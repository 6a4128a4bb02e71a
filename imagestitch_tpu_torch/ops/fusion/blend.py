"""Elementwise fusion: notFuse, average, maximum, minimum, fade and
trigonometric.

Port of ``imagestitch_tpu/ops/fusion/blend.py`` (:24-208; reference:
ImageFusion.py:12-41 simple fusers, :192-244 fade, :246-293 trigonometric,
and the pre-fill + dispatch of ``fuseImage``, Stitcher.py:488-525) for gray
(H, W) and color (H, W, 3) regions: int32 with ``-1`` background sentinels
in, uint8 out.  The port fuses the exact rect, so each mode follows what
the JAX composer runs on its padded window (``fuse_region_padded``): the
valid fraction is the float32 count over rh * rw * channels and the
trigonometric ramps are rect-local.  Multiband and the optimal seam are in
pyramid.py and seam.py.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .weights import corner_fade_weights, plain_fade_weights

_PI = float(np.float32(np.pi))

# glibc's float32 sine and cosine (sysdeps/ieee754/flt-32/s_sinf.c,
# s_cosf.c, sincosf.h), which XLA's CPU code calls for the JAX package: the
# argument in float64, reduced by the nearest multiple of pi/2, then one of
# two polynomials in float64, rounded once to float32.  Table: (c0, c1, s1, c2, s2, c3, s3,
# c4) for quadrants 0-1, and the same with the cosine's signs flipped for
# quadrants 2-3.
_H = float.fromhex
_SINCOS = (
    (1.0, _H("-0x1.ffffffd0c621cp-2"), _H("-0x1.555545995a603p-3"),
     _H("0x1.55553e1068f19p-5"), _H("0x1.1107605230bc4p-7"),
     _H("-0x1.6c087e89a359dp-10"), _H("-0x1.994eb3774cf24p-13"),
     _H("0x1.99343027bf8c3p-16")),
    (-1.0, _H("0x1.ffffffd0c621cp-2"), _H("-0x1.555545995a603p-3"),
     _H("-0x1.55553e1068f19p-5"), _H("0x1.1107605230bc4p-7"),
     _H("0x1.6c087e89a359dp-10"), _H("-0x1.994eb3774cf24p-13"),
     _H("-0x1.99343027bf8c3p-16")))
_HPI_INV_2P24 = _H("0x1.45f306dc9c883p+23")    # 2 / pi * 2^24
_HPI = _H("0x1.921fb54442d18p+0")


def _sinf_poly(x: torch.Tensor, x2: torch.Tensor, table, odd: bool
               ) -> torch.Tensor:
    c0, c1, s1, c2, s2, c3, s3, c4 = table
    if not odd:
        x3 = x * x2
        return (x + x3 * s1) + (x3 * x2) * (s2 + x2 * s3)
    x4 = x2 * x2
    return (c0 + x2 * c1) + x4 * c2 + (x4 * x2) * (c3 + x2 * c4)


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    """glibc's ``sinf`` or ``cosf`` (s_cosf.c) of a float32 tensor,
    elementwise in float64 torch ops (the same on the card and the CPU).
    Below 2^-12 the sine returns y and the cosine 1, below 0.75 each takes
    its polynomial, below 120 it reduces by pi/2 (reduce_fast) and takes
    the quadrant's polynomial (the cosine's is the sine's of the next
    quadrant).  Beyond 120, where glibc reduces with its large table, it
    takes the float64 function rounded once: no caller reaches it."""
    x = y.to(torch.float64)
    n = (torch.trunc(x * _HPI_INV_2P24).to(torch.int64) + 0x800000) >> 24
    r = x - n.to(torch.float64) * _HPI
    flip = torch.where((n & 3 == 1) | (n & 3 == 2), -1.0, 1.0).to(x)
    r2 = r * r
    quad = [_sinf_poly(r * flip, r2, _SINCOS[t], odd)
            for t in (0, 1) for odd in (False, True)]
    odd = ((n ^ 1) if cos else n) & 1
    reduced = torch.where((n & 2) != 0,
                          torch.where(odd != 0, quad[3], quad[2]),
                          torch.where(odd != 0, quad[1], quad[0]))
    ay = y.abs()
    out = torch.where(ay < 0.75, _sinf_poly(x, x * x, _SINCOS[0], cos),
                      torch.where(ay < 120.0, reduced,
                                  torch.cos(x) if cos else torch.sin(x)))
    return torch.where(ay < 2.0 ** -12, torch.ones_like(y) if cos else y,
                       out.to(torch.float32))


def _sinf(y: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf`` of a float32 tensor (``_sincosf``)."""
    return _sincosf(y, cos=False)


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """glibc's ``cosf`` of a float32 tensor (``_sincosf``)."""
    return _sincosf(y, cos=True)


def _prefill_background(image_a: torch.Tensor, image_b: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Background elimination for the non-fade modes (Stitcher.py:498-504):
    -1 sentinels become 0, then every 0 of one region is filled from the
    other.  True black pixels count as background too, and B is filled
    from the already-filled A (the reference's order)."""
    a = torch.where(image_a == -1, 0, image_a)
    b = torch.where(image_b == -1, 0, image_b)
    a_f = torch.where(a == 0, b, a)
    b_f = torch.where(b == 0, a_f, b)
    return a_f, b_f


def fuse_average(image_a: torch.Tensor, image_b: torch.Tensor
                 ) -> torch.Tensor:
    """(A + B) // 2 (ImageFusion.py:12-21)."""
    return torch.div(image_a + image_b, 2, rounding_mode="floor").to(
        torch.uint8)


def fuse_maximum(image_a: torch.Tensor, image_b: torch.Tensor
                 ) -> torch.Tensor:
    return torch.maximum(image_a, image_b).to(torch.uint8)


def fuse_minimum(image_a: torch.Tensor, image_b: torch.Tensor
                 ) -> torch.Tensor:
    return torch.minimum(image_a, image_b).to(torch.uint8)


def _valid_fraction_plain(image_a: torch.Tensor) -> bool:
    """True when more than 65% of A's elements (channels included) are
    valid (ImageFusion.py:209-239): the float32 count / size of the JAX
    composer (blend.py:181-182), divided on the host (weights.py says
    why)."""
    valid_frac = (np.float32(int((image_a > -1).sum()))
                  / np.float32(image_a.numel()))
    return bool(valid_frac > np.float32(0.65))


def _fade_weights(image_a: torch.Tensor, drow: int, dcol: int,
                  color: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain separable ramps when the valid fraction is over 65%, else the
    corner-quadrant weights."""
    if _valid_fraction_plain(image_a):
        return plain_fade_weights((image_a.shape[0], image_a.shape[1]),
                                  drow, dcol, device=image_a.device)
    return corner_fade_weights(image_a, color)


def _trig_ramp(shape_hw: Tuple[int, int], drow: int, dcol: int, device
               ) -> torch.Tensor:
    """Trigonometric fusion's plain ramp of A (blend.py:185-193): the
    mirror of the fade ramp, rect-local, float32, divided on the host."""
    row, col = shape_hw
    if col <= row:
        j = torch.arange(col, dtype=torch.float32)
        wa = j / col if dcol >= 0 else (col - j) / col
        return wa.to(device)[None, :].expand(row, col)
    i = torch.arange(row, dtype=torch.float32)
    wa = i / row if drow <= 0 else (row - i) / row
    return wa.to(device)[:, None].expand(row, col)


def _trig_weights(image_a: torch.Tensor, drow: int, dcol: int,
                  color: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin^2 of the plain or corner weight of A, then wb = 1 - wa
    (blend.py:194-199).  The sine is glibc's float32 one, which XLA's CPU
    code calls: it is not correctly rounded, and where A and B agree the
    blend sits on an integer, so a weight one ulp off moves the truncated
    pixel."""
    if _valid_fraction_plain(image_a):
        wa = _trig_ramp((image_a.shape[0], image_a.shape[1]), drow, dcol,
                        image_a.device)
    else:
        wa, _ = corner_fade_weights(image_a, color)
    s = _sinf(wa * _PI / 2.0)
    wa = s * s
    return wa, 1.0 - wa


def _apply_weights(image_a: torch.Tensor, image_b: torch.Tensor,
                   wa: torch.Tensor, wb: torch.Tensor,
                   color: bool = False, fma_on: str = "b") -> torch.Tensor:
    """A[A<0] <- B; blend; clamp [0,255]; truncate to uint8
    (ImageFusion.py:240-243).  In color the (H, W) weights broadcast over
    the channels.

    The blend is rounded as the fused multiply-add that XLA emits for the
    JAX package's ``wa * a + wb * b`` in its composer (the padded fuse
    step): fma(wb, b, wa * a) (``fma_on="b"``) for fade, gray and color,
    and for color trigonometric; fma(wa, a, wb * b) (``"a"``) for gray
    trigonometric.  A plain float32 sum is one level off on a few 1e-4 of
    the blended pixels.  In float64 the fused product (24 x 8 significant
    bits) and its sum with the other, rounded, product are exact, so
    casting that sum to float32 is the single FMA rounding.
    """
    if color:
        wa, wb = wa[..., None], wb[..., None]
    a = torch.where(image_a < 0, image_b, image_a)
    if fma_on == "b":
        exact, w_exact, rounded = image_b, wb, wa * a.to(torch.float32)
    else:
        exact, w_exact, rounded = a, wa, wb * image_b.to(torch.float32)
    res = (w_exact.to(torch.float64) * exact.to(torch.float64)
           + rounded.to(torch.float64)).to(torch.float32)
    return res.clamp(0, 255).to(torch.uint8)


def fuse_fade(image_a: torch.Tensor, image_b: torch.Tensor, drow: int,
              dcol: int, color: bool = False) -> torch.Tensor:
    """fadeInAndFadeOut fusion (ImageFusion.py:192-244) of two regions;
    ``drow``/``dcol`` is the pairwise offset of the pair being fused."""
    wa, wb = _fade_weights(image_a, drow, dcol, color)
    return _apply_weights(image_a, image_b, wa, wb, color)


def fuse_trigonometric(image_a: torch.Tensor, image_b: torch.Tensor,
                       drow: int, dcol: int, color: bool = False
                       ) -> torch.Tensor:
    """sin^2-weighted fusion (ImageFusion.py:246-293).  Its plain ramps
    mirror the fade ones (the reference's dy >= 0 branch gives A the
    ascending ramp, ImageFusion.py:265-270)."""
    wa, wb = _trig_weights(image_a, drow, dcol, color)
    return _apply_weights(image_a, image_b, wa, wb, color,
                          fma_on="b" if color else "a")


def fuse_region(image_a: torch.Tensor, image_b: torch.Tensor, drow: int,
                dcol: int, method: str, color: bool = False) -> torch.Tensor:
    """The ``fuseImage`` dispatcher (Stitcher.py:488-525) for the
    elementwise modes; ``drow``/``dcol`` is the pairwise offset of the
    pair being fused."""
    if method in ("average", "maximum", "minimum", "notFuse"):
        a, b = _prefill_background(image_a, image_b)
        if method == "notFuse":
            return b.to(torch.uint8)
        if method == "average":
            return fuse_average(a, b)
        if method == "maximum":
            return fuse_maximum(a, b)
        return fuse_minimum(a, b)
    if method == "fadeInAndFadeOut":
        return fuse_fade(image_a, image_b, drow, dcol, color)
    if method == "trigonometric":
        return fuse_trigonometric(image_a, image_b, drow, dcol, color)
    raise ValueError(f"unknown elementwise fusion method: {method}")
