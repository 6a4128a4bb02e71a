"""Fade (and trigonometric) fusion weight matrices.

Port of the static-shape weights of ``imagestitch_tpu/ops/fusion/weights.py``
(:20-111, :280-349): separable ramps for a full overlap and the corner
-quadrant weights of ImageFusion.py:43-190.  PyTorch runs eagerly on the
exact fusion rect, so the padded ``_dyn`` variants of the JAX package (which
exist for jit shape buckets, and which its composer runs) have no
counterpart; they compute the same weights on the true rect, and the port's
panoramas are held bit-equal to the JAX composer's.  The scalar decisions of
the reference's pixel scans (quadrant, boundary row and column) are taken on
the host from per-column reductions.  The 1-D ramps are computed in float32
on the host and then copied to the region's device: PyTorch's CUDA division
by a Python scalar multiplies by the scalar's reciprocal, which can be one
ulp off the IEEE quotient that the CPU and the JAX composer compute.

Conventions: regions carry the reference's ``-1`` background sentinel
(int32), gray (H, W) or color (H, W, 3); ``valid`` means != -1 (gray) or
channel sum != -3 (color).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _valid_mask(image: torch.Tensor, color: bool) -> torch.Tensor:
    """(H, W) bool validity — ImageFusion.py:72/80 sentinel test."""
    if color:
        return image.sum(dim=-1) != -3
    return image != -1


def plain_fade_weights(shape_hw: Tuple[int, int], drow: int, dcol: int,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear cross-fade ramps for a full-overlap region (ImageFusion.py:
    213-235): across columns when ``col <= row``, else across rows; the
    direction follows the sign of the pairwise offset component."""
    row, col = shape_hw
    if col <= row:  # "horizontal" stitch: ramp across columns
        j = torch.arange(col, dtype=torch.float32)
        if dcol >= 0:
            wa, wb = (col - 1 - j) / col, j / col
        else:
            wa, wb = (j + 1) / col, (col - j) / col
        wa, wb = wa.to(device), wb.to(device)
        return wa[None, :].expand(row, col), wb[None, :].expand(row, col)
    i = torch.arange(row, dtype=torch.float32)
    if drow <= 0:
        wa, wb = i / row, (row - 1 - i) / row
    else:
        wa, wb = (row - i) / row, (i + 1) / row
    wa, wb = wa.to(device), wb.to(device)
    return wa[:, None].expand(row, col), wb[:, None].expand(row, col)


def _last_true(m: np.ndarray) -> Tuple[int, bool]:
    """(index of last True, any True) of a 1-D bool vector."""
    nz = np.flatnonzero(m)
    return (int(nz[-1]), True) if nz.size else (0, False)


def _first_true(m: np.ndarray) -> Tuple[int, bool]:
    nz = np.flatnonzero(m)
    return (int(nz[0]), True) if nz.size else (0, False)


def _select_first_nonzero(candidates: np.ndarray, order_desc: bool,
                          skip_col0: bool) -> int:
    """Reference column scan: first candidate != 0 in scan order, else 0."""
    nz = candidates != 0
    if skip_col0:
        nz = nz.copy()
        nz[0] = False
    idx, any_ = _last_true(nz) if order_desc else _first_true(nz)
    return int(candidates[idx]) if any_ else 0


def _row_ramp_up(n: int, row_index: int, device) -> torch.Tensor:
    """Indices 0..row_index get r/row_index, rest 1 (ImageFusion.py:85-88);
    row_index == 0 -> all ones."""
    if row_index == 0:
        return torch.ones(n, dtype=torch.float32, device=device)
    r = torch.arange(n, dtype=torch.float32)
    ri = float(max(row_index, 1))
    return torch.where(torch.arange(n) <= row_index, r / ri,
                       torch.ones_like(r)).to(device)


def _row_ramp_down(n: int, row_index: int, device) -> torch.Tensor:
    """Indices row_index..n-1 get (n-1-r)/(n-row_index-1), rest 1
    (ImageFusion.py:117-120); row_index == 0 uses denominator n-2 and a
    zero denominator gives 0 (the reference's division by inf)."""
    eff = 1 if row_index == 0 else row_index
    denom = float(n - eff - 1)
    if denom == 0:
        denom = float("inf")
    start = max(min(row_index, n), 0)
    r = torch.arange(n, dtype=torch.float32)
    return torch.where(torch.arange(n) >= start, (n - 1 - r) / denom,
                       torch.ones_like(r)).to(device)


def corner_fade_weights(image_a: torch.Tensor, color: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner-overlap weight matrices (grid/serpentine row transitions).

    ImageFusion.py:43-190: the quadrant of A with the fewest positive
    pixels locates the overlap; the boundary row/col of A's valid region
    define separable linear ramps, weightB = ramp_rows x ramp_cols,
    weightA = 1 - weightB.  In color the quadrant counts count positive
    channel values, as the reference does.  Returns (wA, wB) of shape
    (H, W).
    """
    row, col = image_a.shape[0], image_a.shape[1]
    dev = image_a.device
    valid = _valid_mask(image_a, color)
    positive = image_a > 0
    hr, hc = row // 2, col // 2
    quad = [int(positive[0:hr, 0:hc].sum()), int(positive[hr:, 0:hc].sum()),
            int(positive[hr:, hc:].sum()), int(positive[0:hr, hc:].sum())]
    index = quad.index(min(quad))  # ties -> lowest index

    rpos = torch.arange(row, device=dev)[:, None]
    last_r = torch.where(valid, rpos, -1).max(dim=0).values
    first_r = torch.where(valid, rpos, row).min(dim=0).values
    any_col = last_r >= 0
    cand_bottom_up = torch.where(any_col, last_r + 1, 0).cpu().numpy()
    cand_top_down = torch.where(any_col, first_r - 1, 0).cpu().numpy()

    def col_index_after(row_index: int, from_right: bool, minus_one: bool):
        vrow = valid[min(max(row_index, 0), row - 1)].cpu().numpy()
        if from_right:
            idx, any_ = _last_true(vrow)
            return idx + 1 if any_ else 0
        idx, any_ = _first_true(vrow)
        if not any_:
            return 0
        return idx - 1 if minus_one else idx + 1

    if index == 2:    # overlap upper-left (ImageFusion.py:64-94)
        ri = _select_first_nonzero(cand_bottom_up, True, True)
        ci = col_index_after(ri, True, False)
        wr, wc = _row_ramp_up(row, ri, dev), _row_ramp_up(col, ci, dev)
    elif index == 3:  # lower-left (ImageFusion.py:96-126)
        ri = _select_first_nonzero(cand_top_down, True, True)
        ci = col_index_after(ri, True, False)
        wr, wc = _row_ramp_down(row, ri, dev), _row_ramp_up(col, ci, dev)
    elif index == 0:  # lower-right (ImageFusion.py:128-158)
        ri = _select_first_nonzero(cand_top_down, False, False)
        ci = col_index_after(ri, False, True)
        wr, wc = _row_ramp_down(row, ri, dev), _row_ramp_down(col, ci, dev)
    else:             # upper-right (ImageFusion.py:160-187)
        ri = _select_first_nonzero(cand_bottom_up, False, False)
        ci = col_index_after(ri, False, True)
        wr, wc = _row_ramp_up(row, ri, dev), _row_ramp_down(col, ci, dev)
    wb = wr[:, None] * wc[None, :]
    return 1.0 - wb, wb
