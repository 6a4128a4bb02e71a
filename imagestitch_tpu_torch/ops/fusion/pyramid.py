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
pyramids are bit-equal to the JAX ones.

The resize of an odd-size level is ``jax.image.resize(..., "cubic")``
(the Keys cubic, a = -0.5, antialiased: the kernel widens by 1 / scale on
a downscale); the ORB pyramid and ``utils/image.resize`` take its
"linear".  It rounds as jax's compiled resize on the CPU: the weights as
XLA computes them (``resize_weights``), then one contraction an axis in
jax's einsum order, each a gather of every output's band of taps in
float64-emulated fused multiply-adds and float32 adds, the same on the
card and the CPU.  The orders come from XLA's CPU code with jaxlib 0.9
on x86-64 (AVX-512, 8 threads): LLVM's unrolling and vectorisation and
Eigen's blocking choose them by size, so a host with another vector width
or thread count may round otherwise.  Where this module does not
reproduce them (ROADMAP Queue 3, F8) tests/test_torch_resize_bits.py
names the shapes and bounds them.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ...utils import profiling

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


def _fma32(a, b, c):
    """float32 a * b + c rounded once, for numpy float32 arrays: the exact
    product and its sum in float64, rounded to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _raw_weights(m: int, n: int, method: str, fused_pos: bool,
                 fused_kernel: bool):
    """Unnormalised (m, n) kernel weights and the n sample positions, as
    XLA's CPU code computes jax's ``compute_weight_mat``
    (jax/_src/image/scale.py:57-85) after its algebraic simplifier: the
    division by the kernel's width is a product by its float32 reciprocal
    ``c``, folded into the cubic's constants (``1.5 c``, ``-0.5 c``).
    ``fused_pos``: the sample position (j + 0.5) * inv - 0.5 rounds once
    (a fused multiply-add) rather than twice.  ``fused_kernel``: the
    cubic's multiply-adds are fused, or the triangle's 1 - d c is one
    fused negated multiply-add."""
    f32 = np.float32
    inv = f32(1.0 / (n / m))                  # Python floats, as jax has them
    c = f32(1.0) / max(inv, f32(1.0))
    j = np.arange(n, dtype=f32) + f32(0.5)
    pos = _fma32(j, inv, -0.5) if fused_pos else (j * inv + f32(-0.5))
    d = np.abs(pos[None, :] - np.arange(m, dtype=f32)[:, None])
    x = d * c
    if method == "cubic":
        c1, c2 = f32(1.5) * c, f32(-0.5) * c
        if fused_kernel:
            near = _fma32(_fma32(d, c1, -2.5) * x, x, 1.0)
            far = _fma32(_fma32(_fma32(d, c2, 2.5), x, -4.0), x, 2.0)
        else:
            near = ((d * c1 + f32(-2.5)) * x) * x + f32(1.0)
            far = ((d * c2 + f32(2.5)) * x + f32(-4.0)) * x + f32(2.0)
        w = np.where(x >= 2.0, f32(0.0), np.where(x >= 1.0, far, near))
    elif method == "linear":
        tri = _fma32(-d, c, 1.0) if fused_kernel else f32(1.0) - x
        w = np.maximum(tri, f32(0.0))
    else:
        raise ValueError(f"resize method {method!r}")
    return w.astype(f32), pos


def _tree(v: np.ndarray) -> np.ndarray:
    """Sum over axis 0 (a power of two long) by halving: the x86 lowering
    of LLVM's vector reduction, (v0 + v4) + (v2 + v6) ... for eight."""
    while v.shape[0] > 1:
        half = v.shape[0] // 2
        v = v[:half] + v[half:]
    return v[0]


def _column_sums(w: np.ndarray) -> np.ndarray:
    """XLA's CPU order for the float32 sum over axis 0.  Beyond 32 rows: a
    reduce-window of 32-row blocks (the padding split evenly, the smaller
    half first), each block summed in order, again over the blocks' sums
    while more than 32 remain, and the last ones in order.  Up
    to 32 rows LLVM vectorises the loop over the rows: the whole groups of
    eight added lane by lane and reduced by halving, then the rest in
    groups of four, two and one, each reduced alike and added in order."""
    f32 = np.float32
    m, n = w.shape
    if m <= 32:
        parts, i = [], 8 * (m // 8)
        if i:
            acc = w[0:8]
            for c in range(8, i, 8):
                acc = acc + w[c:c + 8]
            parts.append(_tree(acc))
        for size in (4, 2, 1):
            if m - i >= size:
                parts.append(_tree(w[i:i + size]))
                i += size
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total
    while m > 32:                  # XLA nests the windows beyond 32 blocks
        nb = -(-m // 32)
        lo = (nb * 32 - m) // 2
        wp = np.zeros((nb * 32, n), f32)
        wp[lo:lo + m] = w
        parts = np.zeros((nb, n), f32)
        for b in range(nb):
            part = np.zeros(n, f32)
            for i in range(b * 32, b * 32 + 32):
                part = part + wp[i]
            parts[b] = part
        w, m = parts, nb
    total = np.zeros(n, f32)
    for b in range(m):
        total = total + w[b]
    return total


def _linear_loop_weights(m: int, n: int, tail: int) -> np.ndarray:
    """The triangle weights as LLVM compiles XLA's loop over the n samples:
    the vector body fuses the positions and rounds 1 - d c twice, and the
    last ``tail`` columns (its scalar remainder) fuse 1 - d c."""
    w, _ = _raw_weights(m, n, "linear", True, False)
    if tail:
        w[:, n - tail:] = _raw_weights(m, n, "linear", True, True)[0][
            :, n - tail:]
    return w


@functools.lru_cache(maxsize=256)
def resize_weights(m: int, n: int, method: str) -> np.ndarray:
    """(m, n) float32 weights of ``jax.image.resize`` from m samples to n
    by ``method`` ("cubic" or "linear"), antialias on, rounded as XLA's
    CPU code computes them: half-pixel sample positions, the kernel
    widened by max(1 / scale, 1), each column divided by its sum (XLA's
    blocked order, ``_column_sums``), and zero weights where the sample
    lies outside [-0.5, m - 0.5].

    XLA computes the sum's weights and the divided ones in two fusions
    that LLVM compiles apart.  Where it unrolls the loop over the n
    samples fully it folds the positions one operation at a time (two
    roundings); where it keeps the loop it fuses them, and the loop's
    vector body and scalar remainder may fuse the kernel differently.
    Observed with jaxlib 0.9 on x86-64 (AVX-512):
      * cubic: the positions fused in the divided weights from n = 96,
        in the sum's when n > 96 and from 13 to 32 rows; the kernel's
        multiply-adds fused, but in the sum from up to 9 rows (folded
        whole), which from 10 to 13 rows sums in order;
      * linear, the sum's fusion: unrolled below n = 352 (two roundings,
        1 - d c fused), else the loop with a remainder of n mod 32;
      * linear, the divided weights: unrolled below n = 88, else the loop
        with a remainder of n mod 8 (``_linear_loop_weights``).
    Sizes where LLVM decides otherwise are named in
    tests/test_torch_resize_bits.py."""
    f32 = np.float32
    sequential = False
    if method == "cubic":
        if m <= 9:              # the sum's fusion folded whole, unfused
            w_sum = _raw_weights(m, n, method, False, False)[0]
        elif m <= 13:           # its loop over the rows kept in order
            w_sum = _raw_weights(m, n, method, m == 13, True)[0]
            sequential = True
        else:
            w_sum = _raw_weights(m, n, method, n > 96 or m <= 32, True)[0]
        w_num, pos = _raw_weights(m, n, method, n >= 96, True)
    else:
        w_sum = (_raw_weights(m, n, method, False, True)[0] if n < 352
                 else _linear_loop_weights(m, n, n % 32))
        w_num, pos = _raw_weights(m, n, method, False, True)
        if n >= 88:
            w_num = _linear_loop_weights(m, n, n % 8)
    total = (np.add.accumulate(w_sum, axis=0, dtype=f32)[-1] if sequential
             else _column_sums(w_sum))[None, :]
    wts = w_num / np.where(total != 0, total, f32(1.0))
    wts = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                   wts, f32(0.0))
    inside = (pos >= -0.5) & (pos <= m - 0.5)
    out = np.where(inside[None, :], wts, f32(0.0)).astype(f32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=1024)
def _band(m: int, n: int, method: str, device: torch.device,
          bf16: bool = False):
    """The non-zero band of ``resize_weights``: (first source index (n,),
    weights (n, T) float32, zero-padded) on ``device``, T the widest
    column's span.  ``bf16``: the weights rounded to bfloat16, as jax
    casts them to a bfloat16 image's dtype.  The cache holds more shapes
    than a project's rects make (the dendritic grid's 87 make 67), since
    each miss copies the band to the card, which waits for its queue."""
    wts = resize_weights(m, n, method)
    if bf16:
        wts = torch.from_numpy(wts.copy()).to(torch.bfloat16).to(
            torch.float32).numpy()
    nz = wts != 0
    any_nz = nz.any(axis=0)
    first = np.where(any_nz, nz.argmax(axis=0), 0)
    last = np.where(any_nz, m - 1 - nz[::-1].argmax(axis=0), 0)
    span = int((last - first).max()) + 1
    first = np.minimum(first, m - span)
    idx = first[:, None] + np.arange(span)[None, :]
    band = wts[idx, np.arange(n)[:, None]]
    return (torch.as_tensor(first).to(device),
            torch.as_tensor(band).to(device))


def _fma_t(w: torch.Tensor, x: torch.Tensor, acc: torch.Tensor
           ) -> torch.Tensor:
    """float32 w * x + acc rounded once, on tensors (float64 emulation)."""
    return (w.to(torch.float64) * x.to(torch.float64)
            + acc.to(torch.float64)).to(torch.float32)


def _taps_of(x: torch.Tensor, first: torch.Tensor, t: int, dim: int
             ) -> torch.Tensor:
    return x.index_select(dim, first + t)


def _k_block(k: int):
    """The block length over the summed axis of XLA's CPU product when
    the weights are its left operand (Eigen's blocking), or None for one
    block: k over ceil(k / 320) blocks rounded up to a multiple of 8, or
    640 where k is a multiple of it.  Observed with jaxlib 0.9 on x86-64
    from k = 472 to 2584; below, narrow products block by 96 and wide ones
    do not (open, tests/test_torch_resize_bits.py)."""
    if k <= 464 or k == 640:
        return None
    if k % 640 == 0:
        return 640
    block = -(-k // -(-k // 320))          # ceil(k / ceil(k / 320))
    return -(-block // 8) * 8


def _contract_chain(x: torch.Tensor, first, band, dim: int,
                    block=None) -> torch.Tensor:
    """Each output a float32 fused multiply-add chain over its taps in
    ascending source index, along ``dim`` (-2 or -1).  With ``block``,
    the taps of each block of that many source indices chain apart and
    the blocks' chains are added in order (an output's taps span at most
    two blocks)."""
    acc = hi = None
    for t in range(band.shape[1]):
        wt = band[:, t, None] if dim == -2 else band[:, t]
        xt = _taps_of(x, first, t, dim)
        if acc is None:
            acc, hi = torch.zeros_like(xt), torch.zeros_like(xt)
        if block is None:
            acc = _fma_t(wt, xt, acc)
            continue
        upper = ((first + t) // block > first // block)
        upper = upper[:, None] if dim == -2 else upper
        acc = torch.where(upper, acc, _fma_t(wt, xt, acc))
        hi = torch.where(upper, _fma_t(wt, xt, hi), hi)
    return acc if block is None else acc + hi


def _contract_lanes(x: torch.Tensor, first, band, m: int, lanes: int,
                    block=None) -> torch.Tensor:
    """Along the last axis, in the order of a vectorised dot product over
    the source index k: lane k mod ``lanes`` is a fused multiply-add chain
    over the taps of the whole blocks of ``lanes``, the lanes are added
    pairwise, and the tail's taps (k beyond the last whole block), each
    product rounded, are summed in order and added in front.  With
    ``block``, the lanes of each block of that many source indices sum
    apart and the blocks' sums are added in order."""
    body = (m // lanes) * lanes
    n = first.shape[0]
    acc = x.new_zeros(x.shape[:-1] + (n, 2, lanes))
    tail = x.new_zeros(x.shape[:-1] + (n,))
    lane_ids = torch.arange(lanes, device=x.device)
    for t in range(band.shape[1]):
        k = first + t
        xt = _taps_of(x, first, t, -1)
        wt = band[:, t]
        upper = (k // block > first // block) if block else \
            torch.zeros_like(k, dtype=torch.bool)
        part = torch.stack([~upper, upper], -1)                # (n, 2)
        slot = part[:, :, None] & ((k % lanes)[:, None, None] == lane_ids)
        slot = slot & ((k < body) & (wt != 0))[:, None, None]
        acc = torch.where(slot, _fma_t(wt[:, None, None],
                                       xt[..., None, None], acc), acc)
        in_tail = (k >= body) & (wt != 0)
        tail = torch.where(in_tail, tail + wt * xt, tail)
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    return tail + (acc[..., 0, 0] + acc[..., 1, 0])


def _data_lhs_order(rows: int, n: int):
    """How XLA's CPU product data (rows, w) @ weights (w, n) sums over the
    data's contiguous axis: 0 (a fused chain per output) up to 50 rows,
    else by n mod 64: 0 for 49-63, 2 lanes for 17-32, 4 lanes otherwise
    (``_contract_lanes``).  Eigen blocks the summed axis in both
    (``_chain_block``, ``_lanes_block``).  Observed with jaxlib 0.9 on x86-64
    (AVX-512) on every width tried from 4 to 2584 columns; a host with
    another vector width may take other orders."""
    if rows <= 50:
        return 0
    r = n % 64
    if r >= 49:
        return 0
    return 2 if 17 <= r <= 32 else 4


def _chain_block(rows: int, w: int):
    """Eigen's block over the summed axis of the data-lhs product in the
    chain order: 512 beyond 512 columns, and 128 for up to 50 rows of 256
    to 324 columns; else one block.  Up to 50 rows of 200-512 columns
    Eigen blocks at other points too, and past 256 does not sum plain
    chains (open, F8)."""
    if w > 512:
        return 512
    if rows <= 50 and 256 <= w <= 324:
        return 128
    return None


def _lanes_block(w: int, n: int, lanes: int):
    """Eigen's block over the summed axis of the data-lhs product in the
    lane orders: 1024 with two lanes, and 2048 with four lanes for up to
    1100 outputs, beyond 2048 columns; else one block.  Observed at the
    ORB levels of 2584 columns (1038 and 865 outputs blocked, 1794 and
    2153 not)."""
    if w <= 2048:
        return None
    if lanes == 2:
        return 1024
    return 2048 if n <= 1100 else None


def _resize_rows(x, oh, method, bf16):
    h = x.shape[-2]
    first, band = _band(h, oh, method, x.device, bf16)
    return _contract_chain(x, first, band, -2, _k_block(h))


def _resize_cols(x, ow, method, data_lhs, bf16):
    w = x.shape[-1]
    first, band = _band(w, ow, method, x.device, bf16)
    if not data_lhs:
        return _contract_chain(x, first, band, -1, _k_block(w))
    lanes = _data_lhs_order(x.shape[-2], ow)
    if not lanes:
        return _contract_chain(x, first, band, -1,
                               _chain_block(x.shape[-2], w))
    return _contract_lanes(x, first, band, w, lanes,
                           _lanes_block(w, ow, lanes))


def _resize_to(x: torch.Tensor, shape_hw: Tuple[int, int],
               method: str = "cubic") -> torch.Tensor:
    """``jax.image.resize(x, shape_hw, method)`` (antialias on) of an
    (..., H, W) float32 image over its last two axes, rounded as XLA's CPU
    code rounds it.  jax contracts one axis at a time (an einsum); with
    both axes changing it takes first the axis of the cheaper pairwise
    path (h w oh + oh w ow against h w ow + h ow oh flops).  A contraction
    whose weights are the product's left operand (the rows, and the
    columns when they go first) is a fused multiply-add chain over each
    output's taps in ascending source index; the columns of data that is
    the left operand follow ``_data_lhs_order``.  Each step gathers the
    band of taps, the same on the card and the CPU.  A bfloat16 image
    takes bfloat16 weights, rounds to bfloat16 between the two axes and
    comes back in float32 (the caller rounds it).  The multiband path's
    (2h -> 2h - 1) downscale of an odd level takes "cubic"; the ORB
    pyramid's levels and ``utils/image.resize`` take "linear"."""
    if tuple(x.shape[-2:]) == tuple(shape_hw):
        return x
    bf16 = x.dtype == torch.bfloat16
    x = x.to(torch.float32)
    (h, w), (oh, ow) = x.shape[-2:], shape_hw
    if oh == h:
        return _resize_cols(x, ow, method, True, bf16)
    if ow == w:
        return _resize_rows(x, oh, method, bf16)
    # a bfloat16 product rounds to bfloat16 before the next one
    mid = (lambda t: t.to(torch.bfloat16).to(torch.float32)) if bf16 else \
        (lambda t: t)
    if h * w * oh + oh * w * ow <= h * w * ow + h * ow * oh:
        return _resize_cols(mid(_resize_rows(x, oh, method, bf16)), ow,
                            method, True, bf16)
    return _resize_rows(mid(_resize_cols(x, ow, method, False, bf16)), oh,
                        method, bf16)


def gaussian_pyramid(x: torch.Tensor, level: int) -> List[torch.Tensor]:
    """gp[0] = x, gp[k + 1] = pyrDown(gp[k]); level + 1 entries
    (ImageFusion.py:361-367)."""
    gp = [x.to(torch.float32)]
    for _ in range(level):
        gp.append(pyr_down(gp[-1]))
    return gp


def _expand_to(x: torch.Tensor, shape_hw: Tuple[int, int]) -> torch.Tensor:
    """pyrUp of a level, resized to the next finer level's shape where that
    is odd; each such resize is the ``compose.multiband.resize`` span and
    counts in ``COMPOSE_MULTIBAND_RESIZES`` (the seam's masked blend takes
    the same pyramid, so its resizes count there too)."""
    up = pyr_up(x)
    if tuple(up.shape) == tuple(shape_hw):
        return up
    profiling.count("COMPOSE_MULTIBAND_RESIZES")
    with profiling.span("compose.multiband.resize"):
        return _resize_to(up, shape_hw)


def laplacian_pyramid(x: torch.Tensor, level: int
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The effective reference Laplacian stack: (lp, gp) with
    lp[0] = gp[level - 1] and
    lp[k] = gp[level - 1 - k] - resize(pyrUp(gp[level - k])) for k >= 1."""
    gp = gaussian_pyramid(x, level)
    lp = [gp[level - 1]]
    for i in range(level - 1, 0, -1):
        lp.append(gp[i - 1] - _expand_to(gp[i], tuple(gp[i - 1].shape)))
    return lp, gp


def reconstruct(lp: List[torch.Tensor]) -> torch.Tensor:
    """pyrUp + add chain (ImageFusion.py:353-359)."""
    out = lp[0]
    for i in range(1, len(lp)):
        out = _expand_to(out, tuple(lp[i].shape)) + lp[i]
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
    with profiling.span("compose.multiband"):
        a, b = _prefill_background(image_a, image_b)
        out = blend_half(a.to(torch.float32), b.to(torch.float32), 4)
        return out.clamp(0, 255).to(torch.uint8)
