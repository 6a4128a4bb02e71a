"""K3/K5 on the tensor cores (``csrc/matcher.cu``): the products a.b run as
3xTF32 MMAs (hi = tf32(x), lo = tf32(x - hi), a.b = lo.hi + hi.lo + hi.hi
accumulated in FP32), and small grids split the train axis.

On the CPU: the tolerance argument, by an emulation of that arithmetic on
the port's pool descriptors and on unit-norm random ones (within 2e-6 of
float64, and no ratio test flips except within 1e-5 of the ratio), and the
split choice at the paths' shapes.  On the card (``cuda``): the kernel
against its plain version on ragged shapes and every D, exact ties in
different splits, masked splits and rows, the paths' three shapes, the
launch counts; and the card's integer records against the port's CPU run
on frames whose true shifts lie within 0.02 px of an integer."""
import numpy as np
import pytest
import torch

from imagestitch_tpu_torch import FeatureConfig, StitchConfig
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.core import registration as treg
from imagestitch_tpu_torch.ops.features.match import ratio_ok
from imagestitch_tpu_torch.ops.kernels import matcher as tkmatch
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import two_threads

_BIG = 3.4e38


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero (cvt.rna.tf32.f32), on the int32 view."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _fma_norms(x):
    """|x|^2 of each row as an FP32 FMA chain in column order."""
    s = np.zeros(x.shape[0], np.float32)
    for k in range(x.shape[1]):
        v = x[:, k].astype(np.float64)
        s = (s.astype(np.float64) + v * v).astype(np.float32)
    return s


def _split_distances(a, b):
    """The kernel's squared distances: 3xTF32 products accumulated in FP32
    one 8-column MMA step at a time, then max(fl(fl(na + nb) - 2ab), 0)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    ab = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            ab = ab + x[:, s] @ y[:, s].T
    na, nb = _fma_norms(a), _fma_norms(b)
    return np.maximum((na[:, None] + nb[None, :]) - np.float32(2) * ab,
                      np.float32(0))


def _top2(dist, valid_b):
    dist = np.where(valid_b[None, :], dist, _BIG)
    i0 = dist.argmin(1)
    d0 = dist[np.arange(len(dist)), i0]
    rest = dist.copy()
    rest[np.arange(len(dist)), i0] = _BIG
    return d0, i0, rest.min(1)


def _unit(rng, n, d=128):
    x = rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _pool_descriptors():
    """Queries and train rows from the port's fused pool of two seeded
    synthetic frames (upright SURF-128, the main path's descriptors)."""
    positions = synthetic.serpentine_positions(2, 1, (150.37, 0.0))
    frames, _ = synthetic.sequence(3, (240, 320), positions)
    cfg = StitchConfig(color_mode=False,
                       features=FeatureConfig(upright=True))
    _, _, scores, descs = tfr.pool_features(
        torch.as_tensor(frames), tfr._detect_params(cfg),
        tfr._describe_params(cfg))
    valid = (scores > 0).numpy()
    return (descs[0].numpy(), valid[0]), (descs[1].numpy(), valid[1])


@pytest.mark.parametrize("source", ["pool", "unit"])
def test_3xtf32_error_and_ratio_test(source):
    """The 3xTF32 distances lie within 2e-6 of float64, and the ratio test
    on them gives float64's decision except within 1e-5 of the ratio."""
    rng = np.random.default_rng(11)
    if source == "pool":
        (a, va), (b, vb) = _pool_descriptors()
        assert va.sum() > 300 and vb.sum() > 300
    else:
        a, b = _unit(rng, 1000), _unit(rng, 900)
        # near neighbours, so that the ratio test has work to do
        b[:300] = _unit(rng, 300) * 0.1 + a[:300] * 0.9
        b[:300] /= np.linalg.norm(b[:300], axis=1, keepdims=True)
        va, vb = np.ones(len(a), bool), rng.random(len(b)) > 0.2
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d64 = np.maximum((a64 * a64).sum(1)[:, None] + (b64 * b64).sum(1)[None]
                     - 2 * a64 @ b64.T, 0)
    dsp = _split_distances(a, b)
    err = np.abs(dsp - d64)[:, vb]
    assert err.max() < 2e-6, err.max()
    ratio = FeatureConfig().search_ratio
    e0, _, e1 = _top2(d64, vb)
    s0, _, s1 = _top2(dsp.astype(np.float64), vb)
    t = lambda d0, d1: ratio_ok(torch.as_tensor(va), torch.as_tensor(d0),
                                torch.as_tensor(d1), ratio).numpy()
    flips = t(e0, e1) != t(s0, s1)
    near = np.abs(e0 / np.maximum(e1, 1e-30) - ratio * ratio) <= 1e-5
    assert not (flips & ~near).any()
    assert t(e0, e1).sum() > 50


def test_split_choice_at_the_paths_shapes():
    """S = 1 where the grid already fills the card (K3's replay dispatch,
    K5 over every pair of (d)); splits of whole tiles, none empty, giving
    at least two waves where the train axis allows (K5 on one pair)."""
    sms = 132
    assert tkmatch.num_splits(64, 1024, 1024, sms) == 1
    assert tkmatch.num_splits(10, 11616, 11616, sms) == 1
    for ka, kb in ((11616, 11616), (1024, 1024), (200, 5000)):
        s = tkmatch.num_splits(1, ka, kb, sms)
        tiles = -(-kb // tkmatch.TILE)
        per = -(-tiles // s)
        blocks = -(-ka // tkmatch.TILE) * s
        assert 1 < s <= tiles and (s - 1) * per < tiles
        assert blocks >= 2 * sms or s == tiles


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _check_top2(got, ref):
    """chip_smoke.py's rule: d0/d1 within 1e-5; an argmin may differ only
    where the two smallest distances tie within 1e-5."""
    (d0k, i0k, d1k), (d0p, i0p, d1p) = got[:3], ref[:3]
    torch.testing.assert_close(d0k, d0p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d1k, d1p, rtol=1e-5, atol=1e-5)
    differ = i0k != i0p.to(torch.int32)
    tied = (d1p - d0p) <= 1e-5 * d1p.abs().clamp_min(1e-30)
    assert not bool((differ & ~tied).any())
    return differ


def _both(dev, da, db, vb, coords=False):
    """Kernel and plain results of K5, or of K3 with coordinates."""
    t = lambda x: torch.as_tensor(x, device=dev)
    args = [t(da), t(db), t(vb)]
    if coords:
        b, kb = vb.shape
        rows = np.arange(b * kb, dtype=np.float32).reshape(b, kb)
        args += [t(rows), t(-rows)]
        fn = tkmatch.top2_l2_coords
    else:
        fn = tkmatch.top2_l2
    got, ref = fn(*args), fn(*args, use_kernel=False)
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.cuda
def test_cuda_ragged_shapes_every_d(cuda_device):
    rng = np.random.default_rng(5)
    for d in (32, 64, 96, 128):
        da = np.stack([_unit(rng, 200, d) for _ in range(3)])
        db = np.stack([_unit(rng, 300, d) for _ in range(3)])
        vb = rng.random((3, 300)) > 0.3
        for coords in (False, True):
            got, ref = _both(cuda_device, da, db, vb, coords)
            differ = _check_top2(got, ref)
            if coords:
                same = ~differ
                assert torch.equal(got[3][same], ref[3][same])
                assert torch.equal(got[4][same], ref[4][same])


@pytest.mark.cuda
def test_cuda_ties_in_different_splits_take_the_first_index(cuda_device):
    rng = np.random.default_rng(6)
    ka, kb = 64, 20 * tkmatch.TILE
    sms = tkmatch._sm_count(cuda_device)
    assert tkmatch.num_splits(1, ka, kb, sms) > 1
    da = _unit(rng, ka)[None]
    db = _unit(rng, kb)[None]
    first = np.arange(ka) * 3                   # the first split
    last = kb - 1 - np.arange(ka) * 7           # the last split
    near = _unit(rng, ka) * 0.05 + da[0]
    db[0, first] = db[0, last] = near
    vb = np.ones((1, kb), bool)
    got, ref = _both(cuda_device, da, db, vb)
    d0, i0, d1 = (x.cpu().numpy()[0] for x in got)
    np.testing.assert_array_equal(i0, first)
    np.testing.assert_array_equal(d0, d1)      # an exact tie: d1 == d0
    _check_top2(got, ref)


@pytest.mark.cuda
def test_cuda_masked_split_and_masked_rows(cuda_device):
    """A split range whose train rows are all masked, and a batch with
    every train row masked (i0 = 0, d0 = d1 = 3.4e38)."""
    rng = np.random.default_rng(7)
    ka, kb = 100, 12 * tkmatch.TILE
    da = np.stack([_unit(rng, ka) for _ in range(2)])
    db = np.stack([_unit(rng, kb) for _ in range(2)])
    vb = np.ones((2, kb), bool)
    vb[0, : 4 * tkmatch.TILE] = False
    vb[1] = False
    assert tkmatch.num_splits(2, ka, kb, tkmatch._sm_count(cuda_device)) > 1
    for coords in (False, True):
        got, ref = _both(cuda_device, da, db, vb, coords)
        _check_top2(got, ref)
        d0, i0, d1 = (x.cpu().numpy() for x in got[:3])
        assert (i0[0] >= 4 * tkmatch.TILE).all()
        assert (d0[1] == np.float32(_BIG)).all()
        assert (d1[1] == np.float32(_BIG)).all() and (i0[1] == 0).all()


@pytest.mark.cuda
def test_cuda_paths_shapes_against_plain(cuda_device):
    """K3's replay dispatch and K5's two whole-image shapes."""
    rng = np.random.default_rng(8)
    for b, ka, kb in ((64, 1024, 1024), (1, 11616, 11616), (1, 1024, 1024)):
        da = np.stack([_unit(rng, ka) for _ in range(b)])
        db = np.stack([_unit(rng, kb) for _ in range(b)])
        vb = rng.random((b, kb)) > 0.3
        got, ref = _both(cuda_device, da, db, vb, coords=b > 1)
        same = ~_check_top2(got, ref)
        if b > 1:
            assert torch.equal(got[3][same], ref[3][same])


@pytest.mark.cuda
def test_cuda_launch_counts(cuda_device):
    """One count a wrapper call, with and without a train split (the tile
    kernel and its merge are one call)."""
    rng = np.random.default_rng(9)
    for kb in (200, 12 * tkmatch.TILE):
        da = torch.as_tensor(_unit(rng, 100)[None], device=cuda_device)
        db = torch.as_tensor(_unit(rng, kb)[None], device=cuda_device)
        vb = torch.ones((1, kb), dtype=torch.bool, device=cuda_device)
        rows = torch.zeros((1, kb), device=cuda_device)
        k3, k5 = tkmatch.LAUNCHES, tkmatch.TOP2_LAUNCHES
        tkmatch.top2_l2(da, db, vb)
        assert (tkmatch.LAUNCHES, tkmatch.TOP2_LAUNCHES) == (k3, k5 + 1)
        tkmatch.top2_l2_coords(da, db, vb, rows, rows)
        assert (tkmatch.LAUNCHES, tkmatch.TOP2_LAUNCHES) == (k3 + 1, k5 + 1)
        tkmatch.top2_l2(da, db, vb, use_kernel=False)
        assert tkmatch.TOP2_LAUNCHES == k5 + 1


@pytest.mark.cuda
def test_cuda_integer_records_equal_the_cpu_run(cuda_device):
    """F5: the card's sub-pixel means differ from the CPU's by up to ~5e-4
    px, and the replay truncates a mean.  On 6 seeds of a 2x2 serpentine of
    480x640 frames whose true shifts lie within 0.02 px of an integer,
    feature_incre (a) and phase_incre (h) give the CPU run's integer
    records on the card."""
    def integers(recs):
        return [(r.ok, r.offset, r.direction, r.scale, r.attempts)
                for r in recs]

    for seed in range(6):
        sign = 1 if seed % 2 else -1
        step = (422 + seed + 0.01 * sign, 566 - seed - 0.015 * sign)
        positions = synthetic.serpentine_positions(
            2, 2, step, drift=(0.01 * sign, -0.015 * sign))
        frames, truth = synthetic.sequence(seed, (480, 640), positions)
        assert np.abs(truth - np.rint(truth)).max() <= 0.02
        gray = torch.as_tensor(frames, device=cuda_device)
        for registration, fn in (
                ("feature_incre", tfr.register_sequence_features_incre),
                ("phase_incre", treg.register_sequence_phase)):
            cfg = StitchConfig(registration=registration, direction=1,
                               direct_incre=1, roi_ratio=0.2,
                               color_mode=False)
            card, cpu = fn(gray, cfg), fn(frames, cfg, device="cpu")
            assert integers(card) == integers(cpu), (seed, registration)
            assert any(r.ok for r in card), (seed, registration)
