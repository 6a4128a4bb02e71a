"""The elementwise fusion modes of the port against the JAX package:
``blend.fuse_region`` on the exact rect against the JAX composer's
``fuse_region_padded`` (the rect inside a padded window, as the composer
runs it), and ``compose`` in every mode the JAX composer pads, gray and
color, on test_torch_compose.py's layouts.

Tolerance: bit-equal, every mode, trigonometric included.  The port's
trigonometric weights take glibc's float32 sine, which XLA's CPU code
calls (held against jax's sine and the C library's here), and its blend
rounds as the fused multiply-add XLA makes of it: where A and B agree the
blend sits on an integer, so a weight one ulp off would move the pixel."""
import ctypes
import ctypes.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import compose as jcompose
from imagestitch_tpu.ops.fusion import blend as jblend
from imagestitch_tpu_torch import StitchConfig
from imagestitch_tpu_torch.core import compose as tcompose
from imagestitch_tpu_torch.ops.fusion import blend as tblend
from test_torch_compose import CASES, H, W
from test_torch_jax_chain import two_threads

PADDABLE = ("notFuse", "average", "maximum", "minimum", "fadeInAndFadeOut",
            "trigonometric")
ALL = PADDABLE + ("multiBandBlending", "optimalSeamLine")
BUCKET = (64, 64)
_padded = jax.jit(jblend.fuse_region_padded,
                  static_argnames=("method", "color"))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _regions(rng, rh, rw, color, corner):
    """int32 regions with -1 sentinels: B valid but for a few holes and
    zeros (the pre-fill's quirk), A valid, or invalid over one corner
    block so that under 65% of it is valid (the corner weights)."""
    shape = (rh, rw, 3) if color else (rh, rw)
    a = rng.integers(0, 256, shape).astype(np.int32)
    b = rng.integers(0, 256, shape).astype(np.int32)
    b[rng.random((rh, rw)) < 0.02] = -1
    a[rng.random((rh, rw)) < 0.02] = 0
    if corner is not None:
        r0, c0 = int(rh * 0.35), int(rw * 0.35)
        rows = slice(r0, None) if corner[0] == "l" else slice(0, rh - r0)
        cols = slice(c0, None) if corner[1] == "r" else slice(0, rw - c0)
        a[rows, cols] = -1
    return a, b


def _fused_pixels(offsets, color):
    """Mask of the panorama's values inside any fusion rect."""
    _, steps, _ = tcompose.plan_compose(offsets, (H, W), StitchConfig())
    mask = np.zeros(tcompose.compute_placement(offsets, (H, W)).canvas_shape,
                    bool)
    for s in steps:
        if s[0] == "fuse":
            (rr, rc), (rh, rw) = s[3], s[4]
            mask[rr:rr + rh, rc:rc + rw] = True
    return np.repeat(mask[..., None], 3, axis=-1) if color else mask


class Tally:
    """Bit-equal, or within one level on the fused elements and equal
    elsewhere, with at most 1e-3 of all the fused elements a test compares
    differing."""

    def __init__(self):
        self.differ = self.fused = 0

    def hold(self, got, ref, exact, fused):
        assert got.dtype == np.uint8 and got.shape == ref.shape
        if exact:
            np.testing.assert_array_equal(got, ref)
            return
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and not diff[~fused].any()
        self.differ += int((diff[fused] != 0).sum())
        self.fused += int(fused.sum())

    def check(self):
        assert self.differ <= 1e-3 * self.fused, (self.differ, self.fused)


@pytest.mark.parametrize("method", PADDABLE)
def test_fuse_region_matches_jax_padded(method):
    """Rects with the ramp across columns (col <= row) and across rows,
    plain and each corner quadrant (valid < 0.65), both offset signs, gray
    and color, each at an offset inside a padded 64 x 64 window."""
    rng = np.random.default_rng(len(method))
    for color in (False, True):
        for rh, rw in ((40, 30), (30, 50)):
            for corner in (None, "ul", "ur", "ll", "lr"):
                for sign in (1, -1):
                    a, b = _regions(rng, rh, rw, color, corner)
                    drow, dcol = sign * 7, sign * 5
                    orow, ocol = 5, 9
                    pa = np.full(BUCKET + a.shape[2:], -1, np.int32)
                    pb = np.full(BUCKET + a.shape[2:], 77, np.int32)
                    pa[orow:orow + rh, ocol:ocol + rw] = a
                    pb[orow:orow + rh, ocol:ocol + rw] = b
                    ref = np.asarray(_padded(
                        jnp.asarray(pa), jnp.asarray(pb), drow, dcol, orow,
                        ocol, jnp.int32(rh), jnp.int32(rw), method=method,
                        color=color))[orow:orow + rh, ocol:ocol + rw]
                    got = tblend.fuse_region(torch.from_numpy(a),
                                             torch.from_numpy(b), drow, dcol,
                                             method, color).numpy()
                    assert got.dtype == np.uint8
                    np.testing.assert_array_equal(got, ref)


def test_sinf_matches_jax_and_libm():
    """``blend._sinf`` against XLA's float32 sine (what the JAX composer's
    trigonometric weights take) and the C library's ``sinf``, bit for
    bit: the weights' range [0, pi/2] densely, +-120 and the branch
    edges."""
    rng = np.random.default_rng(0)
    y = np.concatenate([
        rng.random(200_000, np.float32) * np.float32(np.pi / 2),
        rng.uniform(-119, 119, 30_000).astype(np.float32),
        np.float32([0.0, -0.0, 2.0 ** -12, 1e-5, -1e-5, 0.75, -0.75,
                    np.pi / 4, np.pi / 2, 3 * np.pi / 4, 119.9])])
    got = tblend._sinf(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jnp.sin)(y)))
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.sinf.restype, libm.sinf.argtypes = ctypes.c_float, [ctypes.c_float]
    np.testing.assert_array_equal(
        got, np.array([libm.sinf(float(v)) for v in y], np.float32))


@pytest.mark.parametrize("color", [False, True])
def test_compose_matches_jax(color):
    """Every layout of test_torch_compose.py, every mode the JAX composer
    pads (the bucketed ``_fused_steps_scan_padded``)."""
    for name, offsets in sorted(CASES.items()):
        frames = np.random.default_rng(len(name)).integers(
            0, 256, (len(offsets) + 1, H, W) + ((3,) if color else ()),
            dtype=np.uint8)
        for method in PADDABLE:
            cfg = StitchConfig(fuse_method=method)
            ref = np.asarray(jcompose.compose(
                frames, offsets, JStitchConfig(fuse_method=method)))
            got = tcompose.compose(frames, offsets, cfg, device="cpu")
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
def test_cuda_fusion_modes_match_cpu():
    """Every mode composed on the card against the CPU composer: the
    elementwise modes bit-equal (the ramps are divided on the host, the
    sine in float64), multiband and the seam within one level on at most
    1e-3 of the fused pixels (their products differ in summation order);
    color in every mode the reference runs on color."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    tally = Tally()
    for name, offsets in sorted(CASES.items()):
        for color in (False, True):
            frames = np.random.default_rng(len(name)).integers(
                0, 256, (len(offsets) + 1, H, W) + ((3,) if color else ()),
                dtype=np.uint8)
            for method in PADDABLE if color else ALL:
                cfg = StitchConfig(fuse_method=method)
                cpu = tcompose.compose(frames, offsets, cfg, device="cpu")
                dev = tcompose.compose(torch.as_tensor(frames, device="cuda"),
                                       offsets, cfg, return_device=True)
                assert dev.device.type == "cuda"
                tally.hold(dev.cpu().numpy(), cpu, method in PADDABLE,
                           _fused_pixels(offsets, color))
    tally.check()
