"""Batched FFT phase correlation.

Port of ``imagestitch_tpu/ops/phase_corr.py``: OpenCV's phase correlation
(reference: the per-attempt ``cv2.phaseCorrelate`` of Stitcher.py:230) over
a batch of pairs on one device, in float32:
  1. zero-pad each image to the optimal (5-smooth) DFT size,
  2. cross-power spectrum  F(a) * conj(F(b)) / |.|,
  3. inverse FFT, fftshift,
  4. peak + 5x5 weighted centroid (sub-pixel), response = window mass / (M*N),
  5. shift = center - centroid.

The JAX package computes this in plain XLA (no Pallas kernel), so the port
computes it with ``torch.fft``.  Every division is by a tensor: on a CUDA
tensor PyTorch divides by a Python scalar as a multiply by its reciprocal,
which is not always the IEEE quotient the CPU computes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


def optimal_dft_size(n: int) -> int:
    """Smallest 5-smooth integer >= n (cv2.getOptimalDFTSize semantics)."""
    if n <= 0:
        return 1
    best = None
    p2 = 1
    while p2 < 2 * n:
        p23 = p2
        while p23 < 2 * n:
            p235 = p23
            while p235 < n:
                p235 *= 5
            if best is None or p235 < best:
                best = p235
            p23 *= 3
        p2 *= 2
    return best


def _weighted_centroid_5x5(c: torch.Tensor, peak_r: torch.Tensor,
                           peak_c: torch.Tensor):
    """OpenCV weightedCentroid over a border-clipped 5x5 window, for each
    (H, W) map of a (P, H, W) batch.

    Returns (centroid_row, centroid_col, window_sum), each (P,).  The window
    is clipped (not shifted) at borders, matching cv2's minr/maxr clamping.
    """
    p, h, w = c.shape
    dr = torch.arange(-2, 3, device=c.device)
    rows = peak_r[:, None] + dr                      # (P, 5)
    cols = peak_c[:, None] + dr
    mask = (((rows >= 0) & (rows < h))[:, :, None]
            & ((cols >= 0) & (cols < w))[:, None, :])
    rows_c = rows.clamp(0, h - 1)
    cols_c = cols.clamp(0, w - 1)
    batch = torch.arange(p, device=c.device)[:, None, None]
    win = c[batch, rows_c[:, :, None], cols_c[:, None, :]]
    win = torch.where(mask, win, torch.zeros_like(win))
    s = win.sum(dim=(1, 2))
    den = s + torch.finfo(c.dtype).tiny
    cr = (win * rows_c[:, :, None].to(c.dtype)).sum(dim=(1, 2)) / den
    cc = (win * cols_c[:, None, :].to(c.dtype)).sum(dim=(1, 2)) / den
    return cr, cc, s


def _phase_correlate_one(a: torch.Tensor, b: torch.Tensor, hp: int, wp: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase correlation of each pair of (P, h, w) float32 batches (the JAX
    function's single pair, written over a batch dimension).

    Returns (shift_col, shift_row, response), each (P,) — cv2 returns
    (x, y) with x the column shift; the caller maps to the reference's
    [drow, dcol] order (Stitcher.py:231-232 sets offset=[int(y), int(x)]).
    """
    h, w = a.shape[-2], a.shape[-1]
    pad = (0, wp - w, 0, hp - h)
    fa = torch.fft.rfft2(F.pad(a, pad))
    fb = torch.fft.rfft2(F.pad(b, pad))
    p = fa * torch.conj(fb)
    den = (p.abs() + torch.finfo(a.dtype).tiny)[..., None]
    cps = torch.view_as_complex(torch.view_as_real(p) / den)
    c = torch.fft.irfft2(cps, s=(hp, wp))
    c = torch.roll(c, (hp // 2, wp // 2), dims=(-2, -1))      # fftshift
    flat = torch.argmax(c.reshape(c.shape[0], -1), dim=1)
    cr, cc, wsum = _weighted_centroid_5x5(c, flat // wp, flat % wp)
    # cv2 divides its unscaled-IDFT window mass by M*N; irfft2 already
    # includes the 1/(M*N) factor, so wsum IS cv2's normalized response.
    return wp / 2.0 - cc, hp / 2.0 - cr, wsum


def phase_correlate_batch(a, b, device="cuda"
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched phase correlation.

    a, b: ``(P, h, w)`` arrays or tensors (any real dtype, cast to float32):
    a tensor stays where it lies, numpy goes to ``device`` (the card unless
    the caller passes ``device="cpu"``; without CUDA the card raises).
    ``device`` applies to numpy only.
    Returns host arrays ``(shift_x, shift_y, response)`` of shape ``(P,)``
    with cv2's (x=col, y=row) convention.
    """
    a, b = (x if isinstance(x, torch.Tensor) else torch.as_tensor(x).to(
        resolve_device(device, "phase_correlate_batch")) for x in (a, b))
    a, b = a.to(torch.float32), b.to(torch.float32)
    h, w = a.shape[-2], a.shape[-1]
    out = _phase_correlate_one(a, b, optimal_dft_size(h), optimal_dft_size(w))
    return tuple(t.cpu().numpy() for t in out)
