"""Grid loop-closure edges for the pose-graph solver.

Port of ``imagestitch_tpu/solver/loop_closure.py``.  The reference chains
pairwise offsets by prefix sum, so a serpentine grid's drift is unbounded
(Stitcher.py:404-405).  On a grid, tiles that are not consecutive overlap
too (a tile and the one above it in the previous row); measuring those
overlaps and adding them as extra pose-graph edges closes the loops:
  1. ``propose_edges`` — every non-adjacent tile pair whose chain-predicted
     overlap exceeds a fraction of the tile area (a spatial hash of the
     predicted positions);
  2. ``verify_edges`` — each candidate measured by phase correlation of
     windows around the predicted overlap (bucketed to 128 px, capped at
     ``max_window``, padded 2x for a linear correlation, batched through
     ``ops/phase_corr._phase_correlate_one`` in chunks of a 2 GiB working
     set); those whose response clears the threshold become edges;
  3. ``close_loops`` — the chain graph plus those edges, their weights
     renormalised to the chain's median.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import phase_corr


def propose_edges(positions: np.ndarray, image_shape: Tuple[int, int],
                  min_overlap_frac: float = 0.04,
                  max_candidates: int = 512) -> List[Tuple[int, int]]:
    """Candidate (i, j) tile pairs (j > i + 1) whose chain-predicted overlap
    area exceeds ``min_overlap_frac`` of the tile area, largest first.
    Tiles are bucketed into an (h, w) cell grid by predicted position, and
    each is tested against its 3x3 cell neighbourhood only."""
    h, w = image_shape
    pos = np.asarray(positions, np.float64)
    cells: dict = {}
    for i in range(len(pos)):
        cells.setdefault((int(pos[i, 0] // h), int(pos[i, 1] // w)),
                         []).append(i)
    cands = []
    for (cr, cc), members in cells.items():
        neigh: List[int] = []
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                neigh.extend(cells.get((cr + dr, cc + dc), ()))
        for i in members:
            for j in neigh:
                if j <= i + 1:      # adjacent pairs are chain edges already
                    continue
                ov_r = h - abs(pos[j, 0] - pos[i, 0])
                ov_c = w - abs(pos[j, 1] - pos[i, 1])
                if ov_r <= 0 or ov_c <= 0:
                    continue
                frac = (ov_r * ov_c) / (h * w)
                if frac >= min_overlap_frac:
                    cands.append((frac, i, j))
    cands.sort(reverse=True)
    return [(i, j) for _, i, j in cands[:max_candidates]]


def _verify_windows(images: torch.Tensor, ia: np.ndarray, ib: np.ndarray,
                    sa: np.ndarray, sb: np.ndarray, win_h: int, win_w: int,
                    hp: int, wp: int):
    """Phase-correlate each edge's windows: tile ia's window at sa against
    tile ib's at sb, mean-subtracted, padded to (hp, wp); the response
    renormalised from the padded to the window's area -> host (shift_col,
    shift_row, response)."""
    win = lambda i, s: images[int(i), int(s[0]):int(s[0]) + win_h,
                              int(s[1]):int(s[1]) + win_w]
    wa = torch.stack([win(i, s) for i, s in zip(ia, sa)]).to(torch.float32)
    wb = torch.stack([win(i, s) for i, s in zip(ib, sb)]).to(torch.float32)
    wa = wa - wa.mean(dim=(1, 2), keepdim=True)
    wb = wb - wb.mean(dim=(1, 2), keepdim=True)
    sx, sy, resp = phase_corr._phase_correlate_one(wa, wb, hp, wp)
    resp = resp * (float(hp) * wp / (win_h * win_w))
    return tuple(t.cpu().numpy() for t in (sx, sy, resp))


def verify_edges(images, positions: np.ndarray,
                 edges: Sequence[Tuple[int, int]],
                 pad: int = 64, response_threshold: float = 0.05,
                 max_window: int = 512, device="cuda"
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Measure candidate edges by windowed phase correlation -> (edges_a,
    edges_b, measurements, weights) of the candidates whose response
    clears ``response_threshold`` (weights = response).

    ``images``: (N, H, W); a tensor is measured where it lies, numpy on
    ``device`` (the card unless ``device="cpu"``).  The chain positions
    only locate the windows; each window is the predicted overlap plus
    ``pad`` on each side, capped at ``max_window`` and rounded up to a
    128-px bucket, one batched call a bucket (in chunks of a 2 GiB
    working set), centred on the predicted overlap."""
    if not edges:
        z = np.zeros(0)
        return z.astype(np.int32), z.astype(np.int32), z.reshape(0, 2), z
    if not isinstance(images, torch.Tensor):
        images = torch.as_tensor(images).to(resolve_device(device,
                                                           "verify_edges"))
    n, h, w = images.shape
    pos = np.round(np.asarray(positions, np.float64)).astype(np.int64)
    d0 = np.stack([pos[j] - pos[i] for i, j in edges])   # (E, 2) prior offset
    e = len(edges)
    ideal = np.stack([
        np.clip(np.maximum(h - np.abs(d0[:, 0]) + 2 * pad, 2 * pad),
                0, min(h, max_window)),
        np.clip(np.maximum(w - np.abs(d0[:, 1]) + 2 * pad, 2 * pad),
                0, min(w, max_window)),
    ], axis=1).astype(np.int64)
    bucket = np.stack([np.minimum(-(-ideal[:, 0] // 128) * 128, h),
                       np.minimum(-(-ideal[:, 1] // 128) * 128, w)], axis=1)
    ia_all = np.asarray([i for i, _ in edges], np.int32)
    ib_all = np.asarray([j for _, j in edges], np.int32)
    resp = np.zeros(e)
    meas = np.zeros((e, 2))
    for bh, bw in sorted({(int(r), int(c)) for r, c in bucket}):
        sel = np.nonzero((bucket[:, 0] == bh) & (bucket[:, 1] == bw))[0]
        sa = np.zeros((len(sel), 2), np.int64)
        sb = np.zeros((len(sel), 2), np.int64)
        for kk, k in enumerate(sel):
            for ax, dim, wl in ((0, h, bh), (1, w, bw)):
                # centre the window in the predicted overlap; the
                # measurement sa - sb - (window shift) holds for any anchor
                ov_start = max(int(d0[k, ax]), 0)
                ov_len = dim - abs(int(d0[k, ax]))
                a0 = int(np.clip(ov_start + max(ov_len - wl, 0) // 2 - pad,
                                 0, dim - wl))
                sa[kk, ax] = a0
                sb[kk, ax] = int(np.clip(a0 - d0[k, ax], 0, dim - wl))
        # 2x padding: a linear correlation, as window anchor clipping can
        # make the shift approach the window size
        hp = phase_corr.optimal_dft_size(2 * bh)
        wp = phase_corr.optimal_dft_size(2 * bw)
        chunk = max(1, (2 << 30) // (6 * hp * wp * 8))
        parts = [_verify_windows(images, ia_all[sel[cs:cs + chunk]],
                                 ib_all[sel[cs:cs + chunk]],
                                 sa[cs:cs + chunk], sb[cs:cs + chunk],
                                 bh, bw, hp, wp)
                 for cs in range(0, len(sel), chunk)]
        gx, gy, gr = (np.concatenate([p[t] for p in parts]) for t in range(3))
        resp[sel] = gr
        # cv2's (x, y) is minus the displacement: measurement = anchor
        # delta + the window offset (-y, -x)
        meas[sel, 0] = sa[:, 0] - sb[:, 0] - gy
        meas[sel, 1] = sa[:, 1] - sb[:, 1] - gx
    keep = resp > response_threshold
    return (ia_all[keep], ib_all[keep], meas[keep].astype(np.float32),
            resp[keep].astype(np.float32))


def close_loops(images, graph, positions: np.ndarray,
                image_shape: Tuple[int, int],
                min_overlap_frac: float = 0.04,
                response_threshold: float = 0.05, device="cuda"):
    """Chain graph + verified loop edges -> (graph, n_edges_added).  The
    loop edges' weights are renormalised so that their median equals the
    chain's (vote counts and phase responses are on different scales)."""
    cands = propose_edges(positions, image_shape, min_overlap_frac)
    ia, ib, meas, wgt = verify_edges(images, positions, cands,
                                     response_threshold=response_threshold,
                                     device=device)
    if len(ia) == 0:
        return graph, 0
    chain_med = float(np.median(graph.weights)) if len(graph.weights) else 1.0
    wgt = wgt / max(float(np.median(wgt)), 1e-6) * chain_med
    return graph.with_extra_edges(ia, ib, meas, wgt), int(len(ia))
