"""The plain reference that decides ``correct``.

Written from the semantics of the reference stitcher (VFSMS,
Keep-Passion/ImageStitch: Stitcher.py's placement and paste/fuse order,
ImageFusion.py's fadeInAndFadeOut), in numpy and plain torch.
It imports nothing of the program and takes nothing the program made
except the outputs it judges: the segments and their offsets, whose
panoramas it composes again from the benchmark's own frames.

- Registration: the truth is the scene's geometry.  A pair whose frames
  overlap must register, at the true offset truncated toward zero (the
  reference's ``int()`` of the mean displacement); a pair that does not
  overlap must fail and break the sequence.
- Composition: ``compose`` places the frames as the reference does and
  fuses each overlap by the fuse it is given (a configuration's
  ``fusers/<fuse_method>.py``), by default ``fade``: the fade ramps, in
  float32 weights worked out on the host, the blend rounded once to
  float32 from the exact product of B and the rounded product of A (the
  fused multiply-add of ``wa * a + wb * b``), on the device it is given.
- Ingest: ``decode`` reads each JPEG with cv2 and takes the gray by cv2's
  14-bit fixed-point rule.

``dtype="bfloat16"`` gives the control: the same reference computed a
precision below the float32 the configurations state.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------- truth


def pair_overlaps(truth: np.ndarray, frame_hw) -> np.ndarray:
    """(N - 1,) bool: the two frames of each pair share pixels."""
    h, w = frame_hw
    return (np.abs(truth[:, 0]) < h) & (np.abs(truth[:, 1]) < w)


def expected_offsets(truth: np.ndarray, dtype: str = "float32"
                     ) -> List[Tuple[int, int]]:
    """The true offsets truncated toward zero; in the control, the truth
    is first rounded to bfloat16."""
    t = torch.as_tensor(truth, dtype=torch.float64)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16).to(torch.float64)
    return [(int(r), int(c)) for r, c in t.trunc().tolist()]


def segments_from_decisions(ok: Sequence[bool], offsets) -> List[
        Tuple[Tuple[int, int], List[Tuple[int, int]]]]:
    """[((start, end), offsets inside)] as the reference splits a sequence
    at its failed pairs; ``end`` is exclusive."""
    n = len(ok) + 1
    segs, start = [], 0
    while start < n:
        end = start
        while end < n - 1 and ok[end]:
            end += 1
        segs.append(((start, end + 1), [tuple(offsets[k])
                                        for k in range(start, end)]))
        start = end + 1
    return segs


# ---------------------------------------------------------------- placement


def placement(offsets: Sequence[Tuple[int, int]], h: int, w: int):
    """Positions, canvas size and occupancy ranges (Stitcher.py:387-431):
    prefix sums rebased when they go negative, a canvas that only grows,
    and each frame's occupancy ending at the canvas extent when it was
    placed."""
    n = len(offsets) + 1
    pos = np.zeros((n, 2), np.int64)
    rng_lo = np.zeros((n, 2), np.int64)
    rng_hi = np.zeros((n, 2), np.int64)
    extent = np.array([h, w], np.int64)
    rng_hi[0] = extent
    run = np.zeros(2, np.int64)
    size = np.array([h, w], np.int64)
    for i in range(1, n):
        run += np.asarray(offsets[i - 1], np.int64)
        for a in range(2):
            if run[a] <= 0:
                shift = -run[a]
                pos[:i, a] += shift
                rng_lo[:i, a] += shift
                rng_hi[:i, a] += shift
                extent[a] += shift
                rng_hi[i, a] = extent[a]
                run[a] = 0
                pos[i, a] = 0
            else:
                pos[i, a] = run[a]
                extent[a] = max(extent[a], run[a] + size[a])
                rng_hi[i, a] = extent[a]
            rng_lo[i, a] = pos[i, a]
    return pos, (int(extent[0]), int(extent[1])), rng_lo, rng_hi


# ---------------------------------------------------------------- fade weights


def _plain_weights(row: int, col: int, drow: int, dcol: int):
    """Linear ramps across the shorter side of the rect, their direction
    set by the sign of the pair's offset (ImageFusion.py:213-235)."""
    f = np.float32
    if col <= row:
        j = np.arange(col, dtype=np.float32)
        if dcol >= 0:
            wa, wb = (f(col - 1) - j) / f(col), j / f(col)
        else:
            wa, wb = (j + f(1)) / f(col), (f(col) - j) / f(col)
        return (np.broadcast_to(wa[None, :], (row, col)),
                np.broadcast_to(wb[None, :], (row, col)))
    i = np.arange(row, dtype=np.float32)
    if drow <= 0:
        wa, wb = i / f(row), (f(row - 1) - i) / f(row)
    else:
        wa, wb = (f(row) - i) / f(row), (i + f(1)) / f(row)
    return (np.broadcast_to(wa[:, None], (row, col)),
            np.broadcast_to(wb[:, None], (row, col)))


def _ramp_up(n: int, k: int) -> np.ndarray:
    """0..k rise as r / k, the rest 1; k == 0 gives all ones."""
    if k == 0:
        return np.ones(n, np.float32)
    r = np.arange(n, dtype=np.float32)
    return np.where(np.arange(n) <= k, r / np.float32(max(k, 1)),
                    np.float32(1)).astype(np.float32)


def _ramp_down(n: int, k: int) -> np.ndarray:
    """k..n-1 fall as (n - 1 - r) / (n - k - 1), the rest 1; k == 0 takes
    the denominator n - 2, and a zero denominator gives 0."""
    denom = np.float32(n - (1 if k == 0 else k) - 1)
    if denom == 0:
        denom = np.float32(np.inf)
    r = np.arange(n, dtype=np.float32)
    return np.where(np.arange(n) >= max(min(k, n), 0),
                    (np.float32(n - 1) - r) / denom,
                    np.float32(1)).astype(np.float32)


def _first_nonzero(cands: np.ndarray, from_end: bool, skip_first: bool
                   ) -> int:
    nz = cands != 0
    if skip_first:
        nz[0] = False
    idx = np.flatnonzero(nz)
    if idx.size == 0:
        return 0
    return int(cands[idx[-1] if from_end else idx[0]])


def _corner_weights(a: torch.Tensor, color: bool):
    """The corner-overlap weights (ImageFusion.py:43-190): the quadrant of
    A with the fewest positive values locates the overlap, the boundary
    row and column of A's valid region set two ramps, wb = rows x cols and
    wa = 1 - wb.  The counts and boundaries are reduced where ``a`` lies;
    the ramps are numpy float32."""
    row, col = a.shape[:2]
    valid = (a.sum(dim=-1) != -3) if color else (a != -1)
    pos = a > 0
    hr, hc = row // 2, col // 2
    quads = [int(pos[:hr, :hc].sum()), int(pos[hr:, :hc].sum()),
             int(pos[hr:, hc:].sum()), int(pos[:hr, hc:].sum())]
    q = quads.index(min(quads))
    rows = torch.arange(row, device=a.device)[:, None]
    last = torch.where(valid, rows, -1).max(dim=0).values.cpu().numpy()
    first = torch.where(valid, rows, row).min(dim=0).values.cpu().numpy()
    has = last >= 0
    bottom_up = np.where(has, last + 1, 0)
    top_down = np.where(has, first - 1, 0)

    def col_after(k: int, from_right: bool, minus_one: bool) -> int:
        idx = np.flatnonzero(valid[min(max(k, 0), row - 1)].cpu().numpy())
        if idx.size == 0:
            return 0
        if from_right:
            return int(idx[-1]) + 1
        return int(idx[0]) - 1 if minus_one else int(idx[0]) + 1

    if q == 2:
        k = _first_nonzero(bottom_up, True, True)
        wr, wc = _ramp_up(row, k), _ramp_up(col, col_after(k, True, False))
    elif q == 3:
        k = _first_nonzero(top_down, True, True)
        wr, wc = _ramp_down(row, k), _ramp_up(col, col_after(k, True, False))
    elif q == 0:
        k = _first_nonzero(top_down, False, False)
        wr, wc = _ramp_down(row, k), _ramp_down(col, col_after(k, False, True))
    else:
        k = _first_nonzero(bottom_up, False, False)
        wr, wc = _ramp_up(row, k), _ramp_down(col, col_after(k, False, True))
    wb = (wr[:, None] * wc[None, :]).astype(np.float32)
    return (np.float32(1) - wb).astype(np.float32), wb


def fade(a: torch.Tensor, b: torch.Tensor, drow: int, dcol: int,
         color: bool, dtype: str = "float32") -> torch.Tensor:
    """Fuse the rect before (``a``, int32 with -1 for empty) and after
    (``b``) the paste; uint8 out, where ``a`` lies.  The weights are worked
    out on the host in numpy float32 (IEEE quotients)."""
    valid = np.float32(int((a > -1).sum())) / np.float32(a.numel())
    if valid > np.float32(0.65):
        wa, wb = _plain_weights(a.shape[0], a.shape[1], drow, dcol)
    else:
        wa, wb = _corner_weights(a, color)
    wa = torch.from_numpy(np.ascontiguousarray(wa)).to(a.device)
    wb = torch.from_numpy(np.ascontiguousarray(wb)).to(a.device)
    if color:
        wa, wb = wa[..., None], wb[..., None]
    a = torch.where(a < 0, b, a)
    if dtype == "bfloat16":
        bf = torch.bfloat16
        res = (wa.to(bf) * a.to(bf) + wb.to(bf) * b.to(bf)).to(torch.float32)
    else:
        rounded = wa * a.to(torch.float32)
        res = (wb.to(torch.float64) * b.to(torch.float64)
               + rounded.to(torch.float64)).to(torch.float32)
    return res.clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------- compose


def compose(frames: np.ndarray, offsets: Sequence[Tuple[int, int]],
            dtype: str = "float32", device="cpu", fuse=fade) -> np.ndarray:
    """The panorama of host ``frames`` ((N, H, W[, 3]) uint8) placed by
    ``offsets``, built on ``device``: each frame is pasted in turn, and
    where it meets the occupancy rect of the frame before it, that rect is
    fused from the canvas before and after the paste
    (Stitcher.py:440-486) by ``fuse(before, after, drow, dcol, color,
    dtype)``, as ``fade`` does."""
    n, h, w = frames.shape[:3]
    if n == 1:
        return frames[0].copy()
    color = frames.ndim == 4
    pos, (rows, cols), lo, hi = placement(offsets, h, w)
    canvas = torch.full((rows, cols) + frames.shape[3:], -1,
                        dtype=torch.int16, device=device)
    for i in range(n):
        r, c = int(pos[i, 0]), int(pos[i, 1])
        frame = torch.from_numpy(np.ascontiguousarray(frames[i])).to(device)
        if i > 0:
            r0, c0 = max(r, lo[i - 1, 0]), max(c, lo[i - 1, 1])
            r1, c1 = min(r + h, hi[i - 1, 0]), min(c + w, hi[i - 1, 1])
        if i == 0 or r1 <= r0 or c1 <= c0:
            canvas[r:r + h, c:c + w] = frame
            continue
        before = canvas[r0:r1, c0:c1].to(torch.int32)
        canvas[r:r + h, c:c + w] = frame
        after = canvas[r0:r1, c0:c1].to(torch.int32)
        drow, dcol = offsets[i - 1]
        canvas[r0:r1, c0:c1] = fuse(before, after, int(drow), int(dcol),
                                    color, dtype)
    return canvas.clamp_(min=0).to(torch.uint8).cpu().numpy()


# ---------------------------------------------------------------- ingest


def gray(bgr: torch.Tensor, dtype: str = "float32") -> torch.Tensor:
    """cv2's gray of BGR uint8 (a tensor, computed where it lies),
    ``(1868 b + 9617 g + 4899 r + 8192) >> 14`` in int32; the control
    takes 0.114 b + 0.587 g + 0.299 r in bfloat16."""
    if dtype == "bfloat16":
        x = bgr.to(torch.bfloat16)
        g = (x[..., 0] * 0.114 + x[..., 1] * 0.587 + x[..., 2] * 0.299)
        return torch.round(g.to(torch.float32)).clamp(0, 255).to(
            torch.uint8)
    x = bgr.to(torch.int32)
    return ((1868 * x[..., 0] + 9617 * x[..., 1] + 4899 * x[..., 2] + 8192)
            >> 14).to(torch.uint8)


def decode(path: str) -> np.ndarray:
    """One JPEG as BGR uint8, by cv2 (as the reference reads its frames)."""
    import cv2
    img = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot decode {path}")
    return img
