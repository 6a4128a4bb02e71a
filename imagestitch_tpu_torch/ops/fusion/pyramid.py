"""Gaussian/Laplacian pyramids and multi-band blending.

Port of ``imagestitch_tpu/ops/fusion/pyramid.py`` (reference:
ImageFusion.py:296-374): pyrDown/pyrUp with the 5-tap binomial kernel and
reflect-101 borders as shifted-slice sums (never ``conv2d``), and the
effective Laplacian scheme of the reference (its off-by-one list is read
only in its first ``level`` entries; the JAX module's docstring says how).

Rounding follows the JAX package on the CPU, where XLA contracts each tap
of the sums ``acc + x * k`` into a fused multiply-add: every tap is summed
in float64 (the product of a float32 and a kernel weight of three
significant bits is exact there) and rounded once to float32, so the
pyramids are bit-equal to the JAX ones.  The resize of an odd-size level
is ``jax.image.resize(..., "cubic")``: the Keys cubic (a = -0.5) with
antialiasing, whose kernel widens by 1 / scale on a downscale.  Its weight
matrices are jax's formula evaluated in float32 on the host, rounded as
XLA's CPU code rounds the sample positions (``resize_weights``, shared
with the ORB pyramid's linear resize), and applied as float64 products
rounded once to float32, the same on the card and the CPU.  XLA's compiled code rounds both otherwise, in ways that
change with the size, so where a level has an odd size the blends agree
with the JAX package's to about 1e-5, not bit for bit
(tests/test_torch_pyramid_seam.py).
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

_K5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)
_K5_UP = tuple(2.0 * k for k in _K5)


@functools.lru_cache(maxsize=256)
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source index of each position of a reflect-101 padded axis
    (``np.pad(..., mode="reflect")``, any ``n``), kept on ``device``."""
    return torch.as_tensor(np.pad(np.arange(n), pad, mode="reflect")).to(
        device)


def _pad_reflect(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    return x.index_select(dim, _reflect_index(x.shape[dim], pad, x.device))


def _taps(xp: torch.Tensor, k, n: int, dim: int, step: int) -> torch.Tensor:
    """sum_i xp[i + step * o] * k[i] along ``dim`` for o < ceil(n / step),
    each tap added in float64 and rounded to float32 (an FMA chain)."""
    def tap(i):
        return xp.narrow(dim, i, n)[(slice(None),) * dim + (slice(None, None,
                                                                  step),)]
    acc = (tap(0) * k[0]).to(torch.float32)
    for i in range(1, len(k)):
        acc = torch.add(acc, tap(i), alpha=k[i]).to(torch.float32)
    return acc


def _sep_conv_reflect(x: torch.Tensor, k, step: int = 1) -> torch.Tensor:
    """Separable 2-D correlation with reflect-101 padding on (H, W) float32,
    rows first, keeping every ``step``-th output row and column."""
    pad = len(k) // 2
    h, w = x.shape
    x0 = _taps(_pad_reflect(x, pad, 0).to(torch.float64), k, h, 0, step)
    return _taps(_pad_reflect(x0, pad, 1).to(torch.float64), k, w, 1, step)


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown semantics: blur then decimate; out dims (n + 1) // 2."""
    return _sep_conv_reflect(x, _K5, step=2)


def pyr_up(x: torch.Tensor) -> torch.Tensor:
    """cv2.pyrUp semantics: zero-stuff to 2x, then blur with twice the
    kernel on each axis (a gain of 4)."""
    h, w = x.shape
    up = x.new_zeros((2 * h, 2 * w))
    up[::2, ::2] = x
    return _sep_conv_reflect(up, _K5_UP)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel (a = -0.5) of ``jax.image.resize``'s "cubic"."""
    f32 = np.float32
    near = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    far = ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0)
    return np.where(x >= 2.0, f32(0.0), np.where(x >= 1.0, far, near))


def _triangle(x: np.ndarray) -> np.ndarray:
    """The triangle kernel of ``jax.image.resize``'s "linear"."""
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resize_weights(m: int, n: int, method: str) -> np.ndarray:
    """(m, n) float32 weights of ``jax.image.resize`` from m samples to n
    by ``method`` ("cubic" or "linear"), antialias on
    (jax/_src/image/scale.py:40-85): half-pixel sample positions, the
    kernel widened by max(1 / scale, 1), per-output normalisation, and
    zero weights for samples outside [-0.5, m - 0.5].  The sample
    positions round once (XLA fuses their product and difference) and the
    kernel's argument is a product by the reciprocal of its width, as
    XLA's CPU code computes them."""
    f32 = np.float32
    inv_scale = 1.0 / (n / m)                 # Python floats, as jax has them
    kernel_scale = max(f32(inv_scale), f32(1.0))
    sample_f = ((np.arange(n, dtype=f32) + f32(0.5)).astype(np.float64)
                * f32(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        * (f32(1.0) / kernel_scale)
    wts = _KERNELS[method](x).astype(f32)
    total = wts.sum(axis=0, keepdims=True, dtype=f32)
    wts = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                   wts / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], wts, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _weights_on(m: int, n: int, method: str, device: torch.device
                ) -> torch.Tensor:
    """``resize_weights`` as float64 on ``device``, built once."""
    return torch.as_tensor(resize_weights(m, n, method)).to(device,
                                                             torch.float64)


def _resize_to(x: torch.Tensor, shape_hw: Tuple[int, int],
               method: str = "cubic") -> torch.Tensor:
    """``jax.image.resize(x, shape_hw, method)`` (antialias on) of an
    (..., H, W) float32 image over its last two axes: one product per axis
    whose size changes, in float64, rounded once.  The multiband path's
    (2h -> 2h - 1) downscale of an odd level takes "cubic"; the ORB
    pyramid's levels and ``utils/image.resize`` take "linear"."""
    if tuple(x.shape[-2:]) == tuple(shape_hw):
        return x
    out = x.to(torch.float64)
    (h, w), (oh, ow) = x.shape[-2:], shape_hw
    if oh != h:
        out = _weights_on(h, oh, method, x.device).t() @ out
    if ow != w:
        out = out @ _weights_on(w, ow, method, x.device)
    return out.to(torch.float32)


def gaussian_pyramid(x: torch.Tensor, level: int) -> List[torch.Tensor]:
    """gp[0] = x, gp[k + 1] = pyrDown(gp[k]); level + 1 entries
    (ImageFusion.py:361-367)."""
    gp = [x.to(torch.float32)]
    for _ in range(level):
        gp.append(pyr_down(gp[-1]))
    return gp


def laplacian_pyramid(x: torch.Tensor, level: int
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The effective reference Laplacian stack: (lp, gp) with
    lp[0] = gp[level - 1] and
    lp[k] = gp[level - 1 - k] - resize(pyrUp(gp[level - k])) for k >= 1."""
    gp = gaussian_pyramid(x, level)
    lp = [gp[level - 1]]
    for i in range(level - 1, 0, -1):
        ge = _resize_to(pyr_up(gp[i]), tuple(gp[i - 1].shape))
        lp.append(gp[i - 1] - ge)
    return lp, gp


def reconstruct(lp: List[torch.Tensor]) -> torch.Tensor:
    """pyrUp + add chain (ImageFusion.py:353-359)."""
    out = lp[0]
    for i in range(1, len(lp)):
        out = _resize_to(pyr_up(out), tuple(lp[i].shape)) + lp[i]
    return out


def blend_half(a: torch.Tensor, b: torch.Tensor, level: int = 4
               ) -> torch.Tensor:
    """BlendArbitrary2: 0.5/0.5 per-level blend (ImageFusion.py:331-341)."""
    la, _ = laplacian_pyramid(a, level)
    lb, _ = laplacian_pyramid(b, level)
    return reconstruct([0.5 * x + 0.5 * y for x, y in zip(la, lb)])


def blend_masked(a: torch.Tensor, b: torch.Tensor, region: torch.Tensor,
                 level: int = 4) -> torch.Tensor:
    """BlendArbitrary: region-weighted blend (ImageFusion.py:306-329).
    ``region`` weights a and 1 - region weights b, level by level at the
    mask pyramid's matching resolution.  Each level's sum rounds once, as
    the fused multiply-add XLA makes of it: fma(la, m, lb * (1 - m))."""
    la, _ = laplacian_pyramid(a, level)
    lb, _ = laplacian_pyramid(b, level)
    gr = gaussian_pyramid(region.to(torch.float32), level)
    lc = []
    for i in range(level):
        m = gr[level - 1 - i]
        lbm = (lb[i] * (1.0 - m)).to(torch.float64)
        lc.append(torch.addcmul(lbm, la[i].to(torch.float64),
                                m.to(torch.float64)).to(torch.float32))
    return reconstruct(lc)


def fuse_multiband(image_a: torch.Tensor, image_b: torch.Tensor
                   ) -> torch.Tensor:
    """fuseByMultiBandBlending (ImageFusion.py:296-304) of two gray int32
    regions with -1 sentinels: background pre-fill, then a 4-level
    half/half blend; uint8 out."""
    from .blend import _prefill_background
    a, b = _prefill_background(image_a, image_b)
    out = blend_half(a.to(torch.float32), b.to(torch.float32), 4)
    return out.clamp(0, 255).to(torch.uint8)
