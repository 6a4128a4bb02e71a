"""Multiband and optimal-seam fusion of the port against the JAX package
(ops/fusion/pyramid.py, ops/fusion/seam.py, and ``compose`` in both modes).

Tolerances, each stated where it is held:
  * pyr_down / pyr_up bit-equal: every tap is summed in float64 and
    rounded once, as the fused multiply-adds XLA makes of the JAX sums;
  * ``_resize_to`` (jax.image.resize "cubic", antialias on) bit-equal, a
    2h -> 2h - 1 downscale included (tests/test_torch_resize_bits.py
    holds it over sizes);
  * the seam energy bit-equal (integer differences), the DP's mask
    bit-equal given the same energy;
  * fusion and composition bit-equal on both layouts, the one whose
    pyramid levels have odd sizes included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import compose as jcompose
from imagestitch_tpu.ops.fusion import pyramid as jpyr
from imagestitch_tpu.ops.fusion import seam as jseam
from imagestitch_tpu_torch import StitchConfig
from imagestitch_tpu_torch.core import compose as tcompose
from imagestitch_tpu_torch.ops.fusion import blend as tblend
from imagestitch_tpu_torch.ops.fusion import pyramid as tpyr
from imagestitch_tpu_torch.ops.fusion import seam as tseam
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import two_threads

METHODS = ("multiBandBlending", "optimalSeamLine")
#: frames and true offsets whose fusion rects (64 x 320, 256 x 96) halve
#: to even sizes at every level; the odd layout's rects do not
H, W = 256, 320
EVEN = [(192, 0), (0, 224), (-192, 0)]
ODD = [(190, 3), (1, 221), (-187, -2)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def blobs():
    """Two overlapping frames of sub-pixel blobs plus noise."""
    seq, _ = synthetic.sequence(5, (160, 200), [(0.37, 0.21), (9.4, 6.3)])
    return seq.astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape", [(146, 134), (37, 5), (1, 1)])
def test_pyr_ops_and_resize_match_jax(shape):
    """Even and odd sizes, a single pixel included."""
    x = np.random.default_rng(shape[0]).uniform(0, 255, shape).astype(
        np.float32)
    down = np.asarray(jax.jit(jpyr.pyr_down)(jnp.asarray(x)))
    up = np.asarray(jax.jit(jpyr.pyr_up)(jnp.asarray(x)))
    np.testing.assert_array_equal(tpyr.pyr_down(_t(x)).numpy(), down)
    np.testing.assert_array_equal(tpyr.pyr_up(_t(x)).numpy(), up)
    # the multiband path's odd-level downscale, and one axis at a time
    for target in ((2 * shape[0] - 1, 2 * shape[1] - 1),
                   (2 * shape[0] - 1, 2 * shape[1]), up.shape):
        ref = np.asarray(jax.jit(lambda v: jpyr._resize_to(v, target))(
            jnp.asarray(up)))
        got = tpyr._resize_to(_t(up), target).numpy()
        assert got.shape == ref.shape == target
        np.testing.assert_array_equal(got, ref)


def test_seam_energy_matches_jax(blobs):
    """Bit-equal: integer differences, IEEE divisions."""
    a, b = blobs
    for rows, cols in ((70, 134), (160, 9), (3, 3)):
        pa, pb = tblend._prefill_background(_t(a[:rows, :cols]),
                                            _t(b[:rows, :cols]))
        ja, jb = (jnp.asarray(v.numpy()) for v in (pa, pb))
        np.testing.assert_array_equal(
            tseam.seam_energy(pa, pb).numpy(),
            np.asarray(jax.jit(jseam.seam_energy)(ja, jb)))


def test_find_optimal_seam_matches_jax():
    """The mask from the same energy, bit-equal: plateaus of ties, 1, 2
    and 3 rows, one column, the straight and diagonal valleys of
    tests/test_pyramid_seam.py, "vertical" and the reference's int
    direction, and random energies."""
    rng = np.random.default_rng(3)
    straight = np.full((20, 15), 100.0, np.float32)
    straight[:, 7] = 0.0
    diagonal = np.full((12, 12), 50.0, np.float32)
    diagonal[np.arange(12), np.arange(12)] = 0.0
    cases = [(straight, "horizontal"), (diagonal, "horizontal"),
             (diagonal, "vertical"), (straight, 1),
             (np.zeros((9, 7), np.float32), "horizontal"),
             (rng.integers(0, 3, (30, 11)).astype(np.float32), "horizontal"),
             (rng.integers(0, 3, (30, 11)).astype(np.float32), "vertical"),
             (rng.random((40, 25)).astype(np.float32) * 1e4, "horizontal")]
    cases += [(rng.integers(0, 2, (r, 6)).astype(np.float32), "horizontal")
              for r in (1, 2, 3)]
    cases.append((rng.random((17, 1)).astype(np.float32), "horizontal"))
    for value, direction in cases:
        ref = np.asarray(jseam.find_optimal_seam(jnp.asarray(value),
                                                 direction))
        got = tseam.find_optimal_seam(_t(value), direction)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("method", METHODS)
def test_fusion_matches_jax(blobs, method):
    """``fuse_multiband`` / ``fuse_optimal_seam`` on blob regions with -1
    sentinels: bit-equal where every level is even; elsewhere the float
    blend (``blend_half``, or ``blend_masked`` with the JAX mask) within
    1e-4 and the pixels within one level."""
    a, b = blobs
    t_fn = (tpyr.fuse_multiband if method == METHODS[0]
            else tseam.fuse_optimal_seam)
    j_fn = (jpyr.fuse_multiband if method == METHODS[0]
            else jseam.fuse_optimal_seam)
    for rows, cols in ((64, 96), (128, 48), (70, 134), (146, 67)):
        ra, rb = a[:rows, :cols].copy(), b[:rows, :cols].copy()
        ra[:5, :9] = -1
        got = t_fn(_t(ra), _t(rb)).numpy()
        ref = np.asarray(j_fn(jnp.asarray(ra), jnp.asarray(rb)))
        if rows % 16 == 0 and cols % 16 == 0:
            np.testing.assert_array_equal(got, ref)
            continue
        assert np.abs(got.astype(int) - ref).max() <= 1
        pa, pb = (v.float() for v in tblend._prefill_background(_t(ra),
                                                                _t(rb)))
        ja, jb = jnp.asarray(pa.numpy()), jnp.asarray(pb.numpy())
        if method == METHODS[0]:
            fl = tpyr.blend_half(pa, pb).numpy()
            jfl = np.asarray(jax.jit(jpyr.blend_half)(ja, jb))
        else:
            mask = 1 - np.asarray(jseam.find_optimal_seam(
                jseam.seam_energy(ja, jb))).astype(np.float32)
            fl = tpyr.blend_masked(pa, pb, _t(mask)).numpy()
            jfl = np.asarray(jax.jit(jpyr.blend_masked)(ja, jb,
                                                        jnp.asarray(mask)))
        np.testing.assert_allclose(fl, jfl, rtol=0, atol=1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_compose_blobs_matches_jax(method):
    """A gray 2 x 2 serpentine of blob frames: bit-equal to the JAX
    composer on the even layout and on the odd one."""
    positions = synthetic.serpentine_positions(2, 2, (192.37, 224.21))
    frames, _ = synthetic.sequence(11, (H, W), positions)
    for offsets in (EVEN, ODD):
        got = tcompose.compose(frames, offsets,
                               StitchConfig(fuse_method=method), device="cpu")
        ref = np.asarray(jcompose.compose(frames, offsets,
                                          JStitchConfig(fuse_method=method)))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
def test_cuda_pyramid_and_seam_match_cpu(blobs):
    """On the card against the CPU: the pyramid ops, the resize and the
    seam energy bit-equal, the DP's mask bit-equal given the same energy,
    and both fusions bit-equal (the resize's gathers, float64 fused
    steps and float32 adds round alike on both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    a, b = blobs
    x = _t(a[:37, :67].astype(np.float32))
    for fn in (tpyr.pyr_down, tpyr.pyr_up,
               lambda v: tpyr._resize_to(tpyr.pyr_up(v), (73, 133))):
        assert torch.equal(fn(x.cuda()).cpu(), fn(x))
    differ = total = 0
    for rows, cols in ((70, 134), (160, 200), (146, 67)):
        ra, rb = _t(a[:rows, :cols]), _t(b[:rows, :cols])
        e = tseam.seam_energy(ra, rb)
        e_dev = tseam.seam_energy(ra.cuda(), rb.cuda())
        assert torch.equal(e_dev.cpu(), e)
        assert torch.equal(tseam.find_optimal_seam(e_dev).cpu(),
                           tseam.find_optimal_seam(e))
        for fn in (tpyr.fuse_multiband, tseam.fuse_optimal_seam):
            got = fn(ra.cuda(), rb.cuda()).cpu().numpy().astype(int)
            diff = np.abs(got - fn(ra, rb).numpy())
            differ += int((diff != 0).sum())
            total += diff.size
    assert differ == 0 and total > 0
