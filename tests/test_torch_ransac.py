"""The port's RANSAC offset calculators against the JAX package's:
``ransac.ransac_homography_batch`` and ``vote.ransac_translation_batch``.

Homography RANSAC is not bit-equal (ops/features/ransac.py says why): the
8x8 DLT solves of pixel coordinates are ill-conditioned and jax's LAPACK
rounds them otherwise, and the port refits in float64 where jax refits in
float32.  Held here: the inlier counts and ``any_valid`` equal on every
pair; where the consensus has 8 matches or more, the integer offsets equal
and the float offsets within 0.1 px (1e-3 px from 32 matches).  A smaller
consensus is a coincidental fit of a few outliers (any 4 matches fit a
homography exactly), whose translation the two float32 solves and refits
place differently (up to hundreds of px on these sets): not held.
Translation RANSAC is bit-equal, at the whole-image K of 11,616 too, where
its float32 sums pass 2^24."""
import numpy as np
import pytest
import torch

from imagestitch_tpu.ops.features import ransac as jransac
from imagestitch_tpu.ops.features import vote as jvote
from imagestitch_tpu_torch.ops.features import ransac as transac
from imagestitch_tpu_torch.ops.features import vote as tvote
from test_torch_jax_chain import two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _matches(rng, n_good, n_out, t, k, span=1000.0, jitter=0.3):
    """tests/test_ransac.py's sets: translation plus jitter, uniform
    outliers, padded to ``k`` invalid slots."""
    n = n_good + n_out
    ra = rng.uniform(50, span - 50, n).astype(np.float32)
    ca = rng.uniform(50, span - 50, n).astype(np.float32)
    rb = np.empty_like(ra)
    cb = np.empty_like(ca)
    rb[:n_good] = ra[:n_good] + t[0] + rng.normal(0, jitter, n_good)
    cb[:n_good] = ca[:n_good] + t[1] + rng.normal(0, jitter, n_good)
    rb[n_good:] = rng.uniform(0, span, n_out)
    cb[n_good:] = rng.uniform(0, span, n_out)
    z = np.zeros(k - n, np.float32)
    valid = np.arange(k) < n
    return [np.concatenate([a, z]) for a in (ra, ca, rb, cb)] + [valid]


def _sets(seed, p, k):
    rng = np.random.default_rng(seed)
    cap = min(60, k // 2)
    sets = [_matches(rng, int(rng.integers(0, cap)), int(rng.integers(0, cap)),
                     rng.uniform(-300, 300, 2), k) for _ in range(p)]
    return [np.stack([s[j] for s in sets]) for j in range(5)]


def _both(arrs):
    ref = [np.asarray(x) for x in jransac.ransac_homography_batch(*arrs)]
    got = [x.numpy() for x in transac.ransac_homography_batch(
        *[torch.from_numpy(a) for a in arrs])]
    return got, ref


def _assert_like_jax(got, ref):
    dr, dc, n, ok, sr, sc = got
    jdr, jdc, jn, jok, jsr, jsc = ref
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(ok, jok)
    held = jn >= 8
    np.testing.assert_array_equal(dr[held], jdr[held])
    np.testing.assert_array_equal(dc[held], jdc[held])
    for lo, tol in ((8, 0.1), (32, 1e-3)):
        m = jn >= lo
        np.testing.assert_allclose(sr[m], jsr[m], rtol=0, atol=tol)
        np.testing.assert_allclose(sc[m], jsc[m], rtol=0, atol=tol)


def test_homography_matches_jax_on_outlier_laden_sets():
    """3 x 64 pairs of 0-59 inliers and 0-59 uniform outliers in 128
    slots."""
    for seed in range(3):
        got, ref = _both(_sets(seed, 64, 128))
        _assert_like_jax(got, ref)
        assert (ref[2] >= 8).sum() > 32


def test_degenerate_samples_do_not_raise():
    """n_valid < 4, duplicated points, collinear points, every slot
    invalid, and one point repeated in every slot: nothing raises, and the
    counts equal jax's (0 below 4 valid matches), except on the collinear
    pair, whose refit normal matrix has a null space of more than one
    dimension: each package keeps an arbitrary member of it."""
    rng = np.random.default_rng(5)
    arrs = _sets(1, 6, 32)
    ra, ca, rb, cb, valid = arrs
    valid[0] = np.arange(32) < 3                  # n_valid < 4
    ra[1, 1::2], ca[1, 1::2] = ra[1, ::2], ca[1, ::2]   # duplicated points
    rb[1, 1::2], cb[1, 1::2] = rb[1, ::2], cb[1, ::2]
    valid[1] = np.arange(32) < 20
    ra[2] = 7.0                                   # collinear
    ca[2] = np.linspace(0, 900, 32, dtype=np.float32)
    rb[2], cb[2] = ra[2] + 3.5, ca[2] - 1.25
    valid[2] = True
    valid[3] = False                              # no valid slot
    for a in (ra, ca, rb, cb):                    # one point everywhere
        a[4] = a[4, 0]
    valid[4] = True
    ra[5] = rng.uniform(0, 10, 32)                # a tiny cluster
    got, ref = _both(arrs)
    held = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(got[2][held], ref[2][held])
    np.testing.assert_array_equal(got[3][held], ref[3][held])
    assert got[2][0] == 0 and got[2][3] == 0


def test_solve_pivots_and_zero_pivot():
    """The elimination picks the largest pivot (a system that needs a row
    swap solves exactly), and an exactly singular system gives non-finite
    values, as jax's solve does, instead of raising."""
    a = torch.tensor([[0.0, 2.0], [3.0, 1.0]])
    x = transac._solve(a, torch.tensor([4.0, 5.0]))
    torch.testing.assert_close(x, torch.tensor([1.0, 2.0]), rtol=0, atol=0)
    sing = torch.tensor([[1.0, 2.0], [2.0, 4.0]])
    assert not torch.isfinite(transac._solve(
        sing, torch.tensor([1.0, 1.0]))).all()


@pytest.mark.parametrize("k", [37, 1024, 11616])
def test_translation_bit_equal(k):
    """Clusters at offsets up to 2,600 px: at K = 11,616 the inlier sums
    pass 2^24, where XLA's order of summation decides the float32 mean."""
    rng = np.random.default_rng(k)
    p = 3 if k > 2000 else 8
    shift = rng.integers(-2600, 2600, (p, 1, 2))
    d = (rng.integers(-3, 4, (p, k, 2)) + shift).astype(np.int32)
    out = rng.random((p, k)) < 0.3
    d[out] = rng.integers(-2600, 2600, (int(out.sum()), 2))
    valid = rng.random((p, k)) < 0.95
    valid[-1] = False
    ref = [np.asarray(x) for x in jvote.ransac_translation_batch(
        d[..., 0], d[..., 1], valid)]
    got = [x.numpy() for x in tvote.ransac_translation_batch(
        torch.from_numpy(d[..., 0]), torch.from_numpy(d[..., 1]),
        torch.from_numpy(valid))]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the card's RANSAC is held against the "
                    "CPU's")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_ransac_equals_cpu(cuda_device):
    """The card's homography and translation RANSAC against the CPU's on
    the same seeded matches, degenerate samples included: equal integer
    fields and inlier counts, float offsets within 1e-3 px where the
    consensus has 4 matches or more (a refit with fewer inliers has no
    unique solution)."""
    arrs = _sets(2, 64, 1024)
    arrs[4][0] = np.arange(1024) < 3
    cpu = [torch.from_numpy(a) for a in arrs]
    got = [x.cpu().numpy() for x in transac.ransac_homography_batch(
        *[t.to(cuda_device) for t in cpu])]
    ref = [x.numpy() for x in transac.ransac_homography_batch(*cpu)]
    for j in range(4):
        np.testing.assert_array_equal(got[j][ref[2] >= 4], ref[j][ref[2] >= 4])
    np.testing.assert_array_equal(got[2], ref[2])
    m = ref[2] >= 4
    np.testing.assert_allclose(got[4][m], ref[4][m], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[5][m], ref[5][m], rtol=0, atol=1e-3)
    d = (arrs[0] - arrs[2]).astype(np.int32), (arrs[1] - arrs[3]).astype(
        np.int32)
    rt = [tvote.ransac_translation_batch(
        *[torch.from_numpy(x).to(dev) for x in (*d, arrs[4])])
        for dev in (cuda_device, torch.device("cpu"))]
    for g, r in zip(*rt):
        np.testing.assert_array_equal(g.cpu().numpy(), r.numpy())
