"""Host-side (numpy, float64) fusion — the reference's exact arithmetic.

Port of ``imagestitch_tpu/ops/fusion/host_blend.py`` for the modes the
JAX composer pads (notFuse, average, maximum, minimum, fade and
trigonometric): the reference blends through numpy float64
(ImageFusion.py:85-94, :241-243), and the streamed-output composers
(core/stream_out.py) run these functions on the host.  Weight matrices are
separable, so they are built as per-row / per-column factor vectors: the
native runtime's ``isr_fuse_step`` takes the vectors (fade and
trigonometric, weight modes 0-3), and the numpy route (``fuse_region_np``)
materializes them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _valid_np(image: np.ndarray, color: bool) -> np.ndarray:
    """(H, W) bool validity — ImageFusion.py:72/80 sentinel test."""
    if color:
        return image.sum(axis=-1) != -3
    return image != -1


def _row_ramp_up_np(n: int, idx: int) -> np.ndarray:
    """positions 0..idx get p/idx, rest 1 (ImageFusion.py:85-88);
    idx == 0 -> all ones (the reference's in-loop guard)."""
    out = np.ones(n, np.float64)
    if idx == 0:
        return out
    p = np.arange(min(idx, n - 1) + 1, dtype=np.float64)
    out[:len(p)] = p / idx
    return out


def _row_ramp_down_np(n: int, idx: int) -> np.ndarray:
    """positions idx..n-1 get (n-1-p)/(n-idx-1), rest 1
    (ImageFusion.py:117-120); idx == 0 follows the reference's in-loop guard
    (every position from 0, denominator n-2; /0 -> inf)."""
    eff = 1 if idx == 0 else idx
    start = max(min(idx, n), 0)
    out = np.ones(n, np.float64)
    p = np.arange(start, n, dtype=np.float64)
    denom = float(n - eff - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        out[start:] = (n - 1 - p) / denom if denom != 0 else np.inf
    return out


def corner_vectors_from_stats(quad, first_v, last_v, row_valid,
                              row: int, col: int
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Corner weight factors (wbr, wbc) from one-pass rect statistics.

    ``quad``: the 4 positive-element counts in the reference's order (ul,
    ll, lr, ur — ImageFusion.py:56-62); ``first_v``/``last_v``: per-column
    first/last VALID row (-1 when the column has none); ``row_valid(ri) ->
    (col,) bool``: validity of one row on demand.  The native composer
    gathers the statistics in one C pass (isr_rect_stats); the quirk-exact
    decisions stay here.
    """
    index = int(np.argmin(quad))   # first minimum = list.index(min)
    first_v = np.asarray(first_v)
    last_v = np.asarray(last_v)
    cand_bottom_up = np.where(last_v >= 0, last_v + 1, 0)
    cand_top_down = np.where(first_v >= 0, first_v - 1, 0)

    def select_first_nonzero(cand, order_desc: bool, skip_col0: bool) -> int:
        nz = cand != 0
        if skip_col0:
            nz = nz.copy()
            nz[0] = False
        idxs = np.nonzero(nz)[0]
        if len(idxs) == 0:
            return 0
        return int(cand[idxs[-1] if order_desc else idxs[0]])

    def col_index_after(ri: int, from_right: bool, minus_one: bool) -> int:
        idxs = np.nonzero(row_valid(min(max(ri, 0), row - 1)))[0]
        if len(idxs) == 0:
            return 0
        if from_right:
            return int(idxs[-1]) + 1
        return int(idxs[0]) + (-1 if minus_one else 1)

    if index == 2:    # overlap upper-left (ImageFusion.py:64-94)
        ri = select_first_nonzero(cand_bottom_up, True, True)
        ci = col_index_after(ri, True, False)
        return _row_ramp_up_np(row, ri), _row_ramp_up_np(col, ci)
    if index == 3:    # overlap lower-left (ImageFusion.py:96-126)
        ri = select_first_nonzero(cand_top_down, True, True)
        ci = col_index_after(ri, True, False)
        return _row_ramp_down_np(row, ri), _row_ramp_up_np(col, ci)
    if index == 0:    # overlap lower-right (ImageFusion.py:128-158)
        ri = select_first_nonzero(cand_top_down, False, False)
        ci = col_index_after(ri, False, True)
        return _row_ramp_down_np(row, ri), _row_ramp_down_np(col, ci)
    # index == 1: overlap upper-right (ImageFusion.py:160-187)
    ri = select_first_nonzero(cand_bottom_up, False, False)
    ci = col_index_after(ri, False, True)
    return _row_ramp_up_np(row, ri), _row_ramp_down_np(col, ci)


def corner_weight_vectors_np(image_a: np.ndarray, color: bool
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """getWeightsMatrix's separable factors: weightB = row_vec x col_vec
    (ImageFusion.py:43-190)."""
    a = np.asarray(image_a)
    row, col = a.shape[:2]
    valid = _valid_np(a, color)
    positive = a > 0
    quad = [
        int(np.count_nonzero(positive[0:row // 2, 0:col // 2])),
        int(np.count_nonzero(positive[row // 2:row, 0:col // 2])),
        int(np.count_nonzero(positive[row // 2:row, col // 2:col])),
        int(np.count_nonzero(positive[0:row // 2, col // 2:col])),
    ]
    any_col = valid.any(axis=0)
    last_v = np.where(any_col, (row - 1) - np.argmax(valid[::-1], axis=0), -1)
    first_v = np.where(any_col, np.argmax(valid, axis=0), -1)
    return corner_vectors_from_stats(quad, first_v, last_v,
                                     lambda ri: valid[ri], row, col)


def corner_fade_weights_np(image_a: np.ndarray, color: bool
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """getWeightsMatrix (ImageFusion.py:43-190), float64 (wA, wB)."""
    wbr, wbc = corner_weight_vectors_np(image_a, color)
    wb = wbr[:, None] * wbc[None, :]
    return 1.0 - wb, wb


def _prefill_np(a: np.ndarray, b: np.ndarray):
    """Background elimination (Stitcher.py:498-504): -1 -> 0, then each 0
    filled from the other region (B from the already-filled A)."""
    a = np.where(a == -1, 0, a)
    b = np.where(b == -1, 0, b)
    a_f = np.where(a == 0, b, a)
    b_f = np.where(b == 0, a_f, b)
    return a_f, b_f


def _apply_weights_np(a: np.ndarray, b: np.ndarray, wa, wb, color: bool
                      ) -> np.ndarray:
    """A[A<0] <- B; float64 blend; clamp [0,255] (ImageFusion.py:240-243)."""
    if color:
        wa = wa[..., None]
        wb = wb[..., None]
    a = np.where(a < 0, b, a)
    res = wa * a.astype(np.float64) + wb * b.astype(np.float64)
    return np.clip(res, 0, 255).astype(np.uint8)


def _plain_fade_vectors(shape_hw, drow, dcol):
    """Linear cross-fade ramps (ImageFusion.py:213-235) as separable
    factors (war, wac, wbr, wbc): wa = war[i]*wac[j], wb = wbr[i]*wbc[j],
    float64."""
    row, col = shape_hw
    if col <= row:
        j = np.arange(col, dtype=np.float64)
        wa = (col - 1 - j) / col if dcol >= 0 else (j + 1) / col
        wb = j / col if dcol >= 0 else (col - j) / col
        ones = np.ones(row, np.float64)
        return ones, wa, ones, wb
    i = np.arange(row, dtype=np.float64)
    wa = i / row if drow <= 0 else (row - i) / row
    wb = (row - 1 - i) / row if drow <= 0 else (i + 1) / row
    ones = np.ones(col, np.float64)
    return wa, ones, wb, ones


def _trig_plain_vectors(shape_hw, drow, dcol):
    """Trigonometric fusion's plain ramp of A as separable factors
    (war, wac), float64: the mirror of the fade ramp
    (ImageFusion.py:265-270)."""
    row, col = shape_hw
    if col <= row:
        j = np.arange(col, dtype=np.float64)
        base = j / col if dcol >= 0 else (col - j) / col
        return np.ones(row, np.float64), base
    i = np.arange(row, dtype=np.float64)
    base = i / row if drow <= 0 else (row - i) / row
    return base, np.ones(col, np.float64)


def fuse_region_np(image_a: np.ndarray, image_b: np.ndarray,
                   drow: int, dcol: int, method: str, color: bool
                   ) -> np.ndarray:
    """Host float64 ``fuseImage`` (Stitcher.py:488-525), numpy route.
    ``image_a``/``image_b``: int regions with -1 sentinels.  The integer
    modes pre-fill the background; fade and trigonometric take the plain
    ramps over 65% valid, else the corner weights, trigonometric through
    sin^2 (weight modes 2 and 3 of the runtime)."""
    if method in ("average", "maximum", "minimum", "notFuse"):
        a, b = _prefill_np(image_a, image_b)
        if method == "notFuse":
            return b.astype(np.uint8)
        if method == "average":
            return ((a + b) // 2).astype(np.uint8)
        if method == "maximum":
            return np.maximum(a, b).astype(np.uint8)
        return np.minimum(a, b).astype(np.uint8)
    if method not in ("fadeInAndFadeOut", "trigonometric"):
        raise ValueError(f"host fusion does not support: {method}")
    row, col = image_a.shape[0], image_a.shape[1]
    plain = np.count_nonzero(image_a > -1) / image_a.size > 0.65
    if plain and method == "fadeInAndFadeOut":
        war, wac, wbr, wbc = _plain_fade_vectors((row, col), drow, dcol)
        wa = war[:, None] * wac[None, :]
        wb = wbr[:, None] * wbc[None, :]
    elif plain:
        war, wac = _trig_plain_vectors((row, col), drow, dcol)
        wa = war[:, None] * wac[None, :]
    else:
        wa, wb = corner_fade_weights_np(image_a, color)
    if method == "trigonometric":
        wa = np.sin(wa * np.pi / 2.0) ** 2
        wb = 1.0 - wa
    return _apply_weights_np(image_a, image_b, wa, wb, color)
