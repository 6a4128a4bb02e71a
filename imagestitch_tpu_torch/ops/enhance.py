"""Contrast enhancement: histogram equalization and CLAHE.

Port of ``imagestitch_tpu/ops/enhance.py``, the reference's optional
preprocessing (reference: Stitcher.py:269-276, :327-334 —
cv2.equalizeHist / cv2.createCLAHE with clipLimit/tileGridSize from
ImageUtility.py:47-50), with the JAX package's cv2 semantics: REFLECT_101
padding to whole tiles (both dimensions padded when either does not
divide), the integer clip limit, the uniform-plus-stride-walked excess
redistribution, the saturate-rounded LUTs and the half-tile-centered
bilinear blend.

Histograms are counts (``bincount``), exact on any device.  The blend
rounds as XLA's CPU code does: the tile coordinate is i * float32(1 / tile)
- 0.5 with one rounding, the first weighted LUT term is fused with the
second's product, and the third and fourth terms are fused into the
running sum (FMAs), each evaluated here as a float64 sum of exact products
rounded once to float32.
"""
from __future__ import annotations

import numpy as np
import torch


def _histogram256(x: torch.Tensor) -> torch.Tensor:
    """(..., N) uint8 values -> (..., 256) float32 counts."""
    flat = x.reshape(-1, x.shape[-1]).to(torch.long)
    base = torch.arange(flat.shape[0], device=x.device)[:, None] * 256
    h = torch.bincount((flat + base).reshape(-1),
                       minlength=flat.shape[0] * 256)
    return h.reshape(*x.shape[:-1], 256).to(torch.float32)


def _equalize_lut(hist: torch.Tensor, total: float) -> torch.Tensor:
    """cv2.equalizeHist LUT: the first nonzero bin maps to 0, the rest to
    round((cdf - cdf[first]) * 255 / (total - hist[first]))."""
    first = torch.argmax((hist > 0).to(torch.int32))
    h0 = hist[first]
    tot = torch.tensor(total, dtype=torch.float32, device=hist.device)
    scale = torch.tensor(255.0, dtype=torch.float32,
                         device=hist.device) / torch.clamp_min(tot - h0, 1.0)
    cdf = torch.cumsum(hist, dim=0)
    lut = torch.round((cdf - cdf[first]) * scale).clamp(0, 255)
    ident = torch.arange(256, dtype=lut.dtype, device=lut.device)
    lut = torch.where(tot == h0, ident, lut)             # constant image
    return lut.to(torch.uint8)


def equalize_hist(image: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 -> equalized uint8 (cv2.equalizeHist semantics)."""
    h, w = image.shape
    lut = _equalize_lut(_histogram256(image.reshape(-1)), float(h * w))
    return lut[image.to(torch.long)]


def _reflect101(n: int, size: int, device) -> torch.Tensor:
    """Source index of each of ``size`` positions over ``n`` pixels, with
    REFLECT_101 beyond the end (jnp.pad mode="reflect")."""
    i = torch.arange(size, device=device)
    return torch.where(i < n, i, 2 * (n - 1) - i)


def clahe(image: torch.Tensor, clip_limit: float = 20.0, tiles: int = 5
          ) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization, (H, W) uint8 ->
    uint8 on a ``tiles`` x ``tiles`` grid (cv2.createCLAHE semantics)."""
    h, w = image.shape
    dev = image.device
    if h % tiles == 0 and w % tiles == 0:
        th, tw = h // tiles, w // tiles
    else:
        # cv2 (clahe.cpp): in the non-divisible branch BOTH dimensions pad
        # by ``tiles - dim % tiles``, a divisible one by a whole tile
        th = (h + tiles - h % tiles) // tiles
        tw = (w + tiles - w % tiles) // tiles
    hp, wp = th * tiles, tw * tiles
    img = image[_reflect101(h, hp, dev)][:, _reflect101(w, wp, dev)]
    t = img.reshape(tiles, th, tiles, tw).permute(0, 2, 1, 3)
    hists = _histogram256(t.reshape(tiles * tiles, th * tw))
    area = th * tw
    limit = float(max(int(clip_limit * area / 256.0), 1))   # cv2: int()
    clipped = torch.clamp_max(hists, limit)
    excess = (hists - clipped).sum(dim=1, keepdim=True)      # integral
    # every bin gets floor(excess / 256); the remainder walks bins 0, step,
    # 2 step, ... (step = max(256 // residual, 1)) adding 1 until spent or
    # out of range; the leftover is dropped
    batch = torch.floor(excess / 256.0)
    residual = excess - batch * 256.0
    step = torch.clamp_min(torch.floor(256.0 / torch.clamp_min(residual,
                                                                1.0)), 1.0)
    bins = torch.arange(256, dtype=torch.float32, device=dev)[None, :]
    q = torch.floor_divide(bins, step)
    bump = ((q * step == bins) & (q < residual)).to(torch.float32)
    clipped = clipped + batch + bump
    scale = torch.tensor(255.0 / area, dtype=torch.float32, device=dev)
    luts = torch.round(torch.cumsum(clipped, dim=1) * scale).clamp(0, 255)
    luts = luts.reshape(tiles, tiles, 256)

    # bilinear interpolation between the four surrounding tile LUTs
    def grid(n, step_px):
        # XLA: i * float32(1 / step) - 0.5, fused into one rounding
        inv = float(np.float32(1.0 / step_px))
        c = (torch.arange(n, dtype=torch.float64, device=dev) * inv
             - 0.5).to(torch.float32)
        c0 = torch.floor(c).clamp(0, tiles - 1).to(torch.long)
        c1 = (c0 + 1).clamp(0, tiles - 1)
        return c0, c1, (c - c0.to(torch.float32)).clamp(0.0, 1.0)

    y0, y1, fy = grid(hp, th)
    x0, x1, fx = grid(wp, tw)
    fy, fx = fy[:, None], fx[None, :]
    v = img.to(torch.long)
    g = lambda yy, xx: luts[yy[:, None], xx[None, :], v].to(torch.float64)
    w00 = ((1 - fy) * (1 - fx)).to(torch.float64)
    w01 = ((1 - fy) * fx).to(torch.float64)
    w10 = (fy * (1 - fx)).to(torch.float64)
    w11 = (fy * fx).to(torch.float64)
    f32 = lambda t: t.to(torch.float32).to(torch.float64)
    out = f32(w00 * g(y0, x0) + f32(w01 * g(y0, x1)))
    out = f32(out + w10 * g(y1, x0))
    out = (out + w11 * g(y1, x1)).to(torch.float32)
    return torch.round(out).clamp(0, 255).to(torch.uint8)[:h, :w]


def enhance_batch(images: torch.Tensor, use_clahe: bool, clip_limit: float,
                  tiles: int) -> torch.Tensor:
    """(P, H, W) uint8 batch enhancement (Stitcher.py:269-276)."""
    if use_clahe:
        return torch.stack([clahe(im, clip_limit, tiles) for im in images])
    return torch.stack([equalize_hist(im) for im in images])
