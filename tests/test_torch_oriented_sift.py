"""Oriented SIFT (``FeatureConfig(method="sift", auto_upright=False)``)
against the JAX package's, on the CPU.

The SIFT route of the port's oriented describe mirrors what XLA's CPU code
computes for the JAX package: glibc's float32 ``atan2f`` for both angles of
the dominant orientation, the window sums in the order of XLA's tiled
matrix-vector product, glibc's ``cosf``/``sinf`` for the rotation and the
bilinear sum's fused multiply-adds.  Oriented SURF keeps the torch ops.

Tolerances, each held where it is stated:
  * glibc's ``cosf``, the window sums, the dominant orientation and the
    fused bilinear sum: bit-equal; the rotated grid within 2e-6;
  * oriented SIFT descriptors within 1e-5 on all but 2% of the rows.  XLA
    recomputes the rotated grid inside each fusion that reads a sample
    (the four gathers, the magnitude, the orientation), and LLVM contracts
    each copy's products into FMAs by its own operand counts, so one
    sample rounds differently in different uses; the port computes each
    sample once.  Measured: 1 row of 300 here (0.33%), 0.93-1.0% of 3,000
    random keypoints on three other frames; the bound is twice the worst;
  * ``Stitcher`` records (integer and sub-pixel offsets) and panoramas:
    equal, for oriented SIFT and oriented SURF.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import feature_registration as jfr
from imagestitch_tpu.ops.features import describe as jdescribe
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.ops.features import describe as tdescribe
from imagestitch_tpu_torch.ops.fusion import blend as tblend
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import (assert_records_equal,
                                  assert_segments_equal,
                                  route_pools_as_on_tpu, stitch_both,
                                  two_threads)

#: share of oriented SIFT rows allowed beyond 1e-5 (module docstring)
ORIENTED_SIFT_SHARE = 0.02


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def patches():
    image = synthetic.sequence(5, (240, 320), [(0.3, 0.6)])[0][0].astype(
        np.float32)
    rng = np.random.default_rng(4)
    rows = rng.uniform(16, 224, 300).astype(np.float32)
    cols = rng.uniform(16, 304, 300).astype(np.float32)
    ref = jdescribe._patch_gather(jnp.asarray(image), jnp.asarray(rows),
                                  jnp.asarray(cols), 29, 14)
    got = tdescribe._patch_gather(torch.as_tensor(image),
                                  torch.as_tensor(rows),
                                  torch.as_tensor(cols), 29, 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    return image, rows, cols, got


def test_glibc_cosf_bit_equal():
    """On 800,008 arguments: every branch of glibc's cosf (below 2^-12,
    below 0.75, reduced below 120) and the sine beside it."""
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.uniform(-4, 4, 500000),
                        rng.uniform(-1, 1, 200000),
                        rng.uniform(-1e-3, 1e-3, 10000),
                        rng.uniform(-100, 100, 90000),
                        [0.0, -0.0, 0.75, -0.75, 2 ** -12, np.pi, -np.pi,
                         np.pi / 2]]).astype(np.float32)
    for jf, tf in ((jnp.cos, tblend._cosf), (jnp.sin, tblend._sinf)):
        np.testing.assert_array_equal(tf(torch.from_numpy(y)).numpy(),
                                      np.asarray(jax.jit(jf)(y)))


def test_window_sums_and_orientation_bit_equal(patches):
    """The 72 x 109 window sums as XLA's CPU dot sums them (also at a
    length with no tail), and the dominant orientation."""
    rng = np.random.default_rng(2)
    for n in (109, 64):
        m = (rng.uniform(size=(40, 72, n)) < 0.3).astype(np.float32)
        x = rng.normal(0, 50, (40, n)).astype(np.float32)
        ref = jax.jit(lambda a, b: jnp.einsum("kws,ks->kw", a, b))(m, x)
        got = tdescribe._window_sum_xla(torch.from_numpy(m)
                                        * torch.from_numpy(x)[:, None, :])
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    patch = patches[3]
    ref = jax.jit(jdescribe._dominant_orientation)(jnp.asarray(patch))
    got = tdescribe._dominant_orientation(patch, xla_bits=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_rotated_bilinear_samples_bit_equal(patches):
    """The rotation by glibc's cosine and sine, within 2e-6 of XLA's grid
    (whether XLA fuses a product into an FMA there depends on the fusion
    around it); then, on XLA's grid, the fused bilinear sum bit-equal."""
    patch = patches[3]
    theta = np.asarray(jax.jit(jdescribe._dominant_orientation)(
        jnp.asarray(patch)))
    base = np.arange(18, dtype=np.float32) - 8.5
    u = np.broadcast_to(base[:, None], (1, 18, 18)).copy()
    v = np.broadcast_to(base[None, :], (1, 18, 18)).copy()
    ju, jv = jax.jit(jdescribe._rot)(jnp.asarray(-theta), u, v)
    tu, tv = tdescribe._rot(torch.as_tensor(-theta), torch.as_tensor(u),
                            torch.as_tensor(v), xla_bits=True)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-6)
    pr, pc = np.asarray(ju) + 14, np.asarray(jv) + 14
    ref = jax.jit(jdescribe._bilinear_from_patch)(jnp.asarray(patch), pr, pc)
    got = tdescribe._bilinear_from_patch(patch, torch.as_tensor(pr),
                                         torch.as_tensor(pc), xla_bits=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_oriented_sift_descriptors_match_jax(patches):
    image, rows, cols, _ = patches
    ref = np.asarray(jdescribe.describe_batch(
        jnp.asarray(image)[None], jnp.asarray(rows)[None],
        jnp.asarray(cols)[None],
        jdescribe.DescribeParams(family="sift", upright=False)))[0]
    got = tdescribe.describe_batch(
        torch.as_tensor(image)[None], torch.as_tensor(rows)[None],
        torch.as_tensor(cols)[None],
        tdescribe.DescribeParams(family="sift", upright=False))[0].numpy()
    assert got.shape == ref.shape == (300, 128)
    bad = np.abs(got - ref).max(axis=1) > 1e-5
    assert bad.mean() <= ORIENTED_SIFT_SHARE, bad.mean()


@pytest.fixture(scope="module")
def grid():
    """A 3-down, 2-column serpentine of 6 frames."""
    pos = synthetic.serpentine_positions(3, 2, (121.37, 170.21))
    return synthetic.sequence(13, (160, 224), pos)[0]


@pytest.mark.parametrize("method", ["sift", "surf"])
def test_oriented_stitcher_matches_jax(method, grid, monkeypatch):
    """``feature_incre`` with every descriptor oriented (the score-map
    pool; K4's Pallas kernel in interpret mode on the JAX side): records
    with their sub-pixel offsets, then the ``Stitcher``'s segments and
    panoramas, equal."""
    route_pools_as_on_tpu(monkeypatch)
    jcfg = JStitchConfig(color_mode=False, roi_ratio=0.2,
                         features=JFeatureConfig(max_keypoints=256,
                                                 method=method,
                                                 auto_upright=False))
    ref = jfr.register_sequence_features_incre(grid, jcfg)
    got = tfr.register_sequence_features_incre(grid, config_from_jax(jcfg),
                                               device="cpu")
    assert_records_equal(got, ref)
    assert all(r.ok for r in got)
    res, jres = stitch_both(grid, jcfg)
    assert_segments_equal(res, jres)
    assert res[0].report.offsets == [r.offset for r in ref]
