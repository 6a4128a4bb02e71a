"""Displacement voting: the reference's 2-D mode rule and translation
RANSAC.

Port of ``imagestitch_tpu/ops/features/vote.py`` (the mode vote, the
sub-pixel refinement, the displacements and ``ransac_translation_batch``),
exact semantics of
``getOffsetByMode`` (reference: ImageUtility.py:139-178):

  * per-match displacement = int-truncated keypoint difference (toward zero),
  * exact (0, 0) displacements are discarded,
  * the 2-D mode wins, ties broken by FIRST OCCURRENCE in match order,
  * the empty case is the reference's single (0, 0) vote (count 1), flagged
    by ``any_valid`` = False.

Batched over a leading pair axis: sort the encoded keys, count runs and
pick the (count, first occurrence) lexicographic winner.
"""
from __future__ import annotations

import torch

_OFF = 1 << 12          # supports |displacement| < 4096 (image edge < 4K px)
_SPAN = 1 << 13
_INVALID_BASE = _SPAN * _SPAN


def displacement_from_matches(rows_a, cols_a, rows_b, cols_b, train_idx,
                              valid):
    """Truncated (drow, dcol) per match slot: A keypoint q against B
    keypoint train_idx[q] (reference ImageUtility.py:153-161)."""
    ti = train_idx.long()
    return displacement_from_coords(rows_a, cols_a, rows_b.gather(-1, ti),
                                    cols_b.gather(-1, ti), valid)


def displacement_from_coords(rows_a, cols_a, rb_sel, cb_sel, valid):
    """Truncated (drow, dcol) per match slot from pre-extracted matched
    coordinates (float -> int32 truncates toward zero)."""
    d_row = (rows_a - rb_sel).to(torch.int32)
    d_col = (cols_a - cb_sel).to(torch.int32)
    return d_row, d_col, valid


def mode_vote_batch(d_row: torch.Tensor, d_col: torch.Tensor,
                    valid: torch.Tensor):
    """(P, K) displacements + validity -> (drow, dcol, count, any_valid)."""
    p, k = d_row.shape
    dev = d_row.device
    valid = valid & ~((d_row == 0) & (d_col == 0))
    valid = valid & (d_row.abs() < _OFF) & (d_col.abs() < _OFF)
    key = (d_row.long() + _OFF) * _SPAN + (d_col.long() + _OFF)
    idx = torch.arange(k, device=dev).expand(p, k)
    key = torch.where(valid, key, _INVALID_BASE + idx)
    skey, sidx = torch.sort(key, dim=-1, stable=True)
    start = torch.ones_like(skey, dtype=torch.bool)
    start[:, 1:] = skey[:, 1:] != skey[:, :-1]
    gid = torch.cumsum(start.long(), dim=-1) - 1
    counts = torch.zeros((p, k), dtype=torch.long, device=dev).scatter_add_(
        1, gid, torch.ones_like(gid))
    first_occ = torch.full((p, k), k, dtype=torch.long, device=dev
                           ).scatter_reduce_(1, gid, sidx, "amin")
    group_key = torch.zeros((p, k), dtype=torch.long, device=dev
                            ).scatter_reduce_(1, gid, skey, "amax")
    counts = torch.where(group_key < _INVALID_BASE, counts,
                         torch.zeros_like(counts))
    score = counts * (k + 1) + (k - first_occ)
    win = torch.argmax(score, dim=-1, keepdim=True)
    wkey = group_key.gather(1, win)[:, 0]
    n = counts.gather(1, win)[:, 0]
    drow = wkey // _SPAN - _OFF
    dcol = wkey % _SPAN - _OFF
    any_valid = valid.any(dim=-1)
    zero = torch.zeros_like(drow)
    drow = torch.where(any_valid, drow, zero).to(torch.int32)
    dcol = torch.where(any_valid, dcol, zero).to(torch.int32)
    n = torch.where(any_valid, n, torch.ones_like(n)).to(torch.int32)
    return drow, dcol, n, any_valid


def subpixel_refine_batch(d_row, d_col, dr_f, dc_f, valid, mode_r, mode_c):
    """Sub-pixel offset per pair: mean float displacement over the matches
    whose truncated displacement equals the winning mode (the mode itself
    when there are none)."""
    inl = valid & (d_row == mode_r[:, None]) & (d_col == mode_c[:, None])
    cnt = torch.clamp_min(inl.sum(dim=-1), 1)
    zero = torch.zeros_like(dr_f)
    mr = torch.where(inl, dr_f, zero).sum(dim=-1) / cnt
    mc = torch.where(inl, dc_f, zero).sum(dim=-1) / cnt
    any_ = inl.any(dim=-1)
    return (torch.where(any_, mr, mode_r.to(torch.float32)),
            torch.where(any_, mc, mode_c.to(torch.float32)))


def _xla_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in the order of XLA's CPU code, which
    rewrites a long reduction into windows of 32 summed in order from 0
    (each level padded at both ends to whole windows, the low end getting
    the smaller half), until 32 or fewer remain; order matters once the
    sum passes 2^24."""
    def ordered(t):
        s = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
        for i in range(t.shape[-1]):
            s = s + t[..., i]
        return s

    while x.shape[-1] > 32:
        n = x.shape[-1]
        w = -(-n // 32)
        pad = w * 32 - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = ordered(x.reshape(*x.shape[:-1], w, 32))
    return ordered(x)


#: match pairs (K x K booleans each) a ``ransac_translation_batch`` step
#: holds at once
_TRANSLATION_CHUNK = 1 << 27


def ransac_translation_batch(d_row: torch.Tensor, d_col: torch.Tensor,
                             valid: torch.Tensor, tol: int = 3):
    """Translation consensus over (P, K) truncated displacements (port of
    ``vote.py:130-159``): every valid match proposes its displacement, its
    inliers are the valid matches within ``tol`` in both axes, the first
    proposal with the most inliers wins, and the offset is the inlier mean
    (float32, XLA's summation order, rounded half to even).  Returns
    ``(drow, dcol, inlier_count, any_valid)``; with no valid match the
    count is 0."""
    p, k = d_row.shape
    step = max(1, _TRANSLATION_CHUNK // max(k * k, 1))
    out = []
    for s in range(0, p, step):
        drf = d_row[s:s + step].to(torch.float32)
        dcf = d_col[s:s + step].to(torch.float32)
        v = valid[s:s + step]
        close = (((drf[:, :, None] - drf[:, None, :]).abs() <= tol)
                 & ((dcf[:, :, None] - dcf[:, None, :]).abs() <= tol)
                 & v[:, None, :])
        counts = torch.where(v, close.sum(-1), torch.zeros_like(d_row[:1]))
        win = torch.argmax(counts, dim=-1, keepdim=True)        # first max
        inl = close.gather(1, win[..., None].expand(-1, 1, k))[:, 0] & v
        n = counts.gather(1, win)[:, 0]
        den = torch.clamp_min(n, 1).to(torch.float32)
        zero = torch.zeros_like(drf)
        mr = _xla_sum(torch.where(inl, drf, zero)) / den
        mc = _xla_sum(torch.where(inl, dcf, zero)) / den
        out.append((torch.round(mr).to(torch.int32),
                    torch.round(mc).to(torch.int32), n.to(torch.int32),
                    v.any(dim=-1)))
    return tuple(torch.cat([o[j] for o in out]) for j in range(4))
