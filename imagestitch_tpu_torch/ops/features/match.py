"""Batched descriptor matching: squared-L2 kNN(2) + Lowe ratio, and the
nearest Hamming neighbour.

Port of ``imagestitch_tpu/ops/features/match.py:29-136`` (the reference's
BruteForce matchers, ImageUtility.py:278-309).  L2: the pooled replay
calls ``match_batch_coords``, which goes through the K3 matcher kernel and
also returns each query's matched train coordinates; the whole-image path
calls ``match_batch``, which goes through K5 (``ops/kernels/matcher.py``).
The ratio test runs on squared distances with ratio^2.  Hamming (ORB):
{0, 1} float bit vectors, distance by the matrix-product identity
|a| + |b| - 2 a.b, exact in float32 below 2^24 bits; the JAX package
computes it outside any Pallas kernel, so it is a ``torch.matmul`` here.
"""
from __future__ import annotations

from typing import Tuple

import torch

# plain float, as in the JAX package: masked distances are 3.4e38, not inf
_BIG = 3.4e38


def _pairwise_sq_l2(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(..., Ka, D), (..., Kb, D) -> (..., Ka, Kb) squared L2 (matmul
    identity, clamped at 0)."""
    ab = torch.matmul(da, db.transpose(-1, -2))
    na = (da * da).sum(dim=-1, keepdim=True)
    nb = (db * db).sum(dim=-1, keepdim=True)
    return torch.clamp_min(na + nb.transpose(-1, -2) - 2.0 * ab, 0.0)


def _pairwise_hamming(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(..., Ka, D), (..., Kb, D) {0, 1} float bits -> (..., Ka, Kb)
    Hamming distances (matmul identity)."""
    ab = torch.matmul(da, db.transpose(-1, -2))
    na = da.sum(dim=-1, keepdim=True)
    nb = db.sum(dim=-1, keepdim=True)
    return na + nb.transpose(-1, -2) - 2.0 * ab


def _first_argmin(dist: torch.Tensor, d0: torch.Tensor) -> torch.Tensor:
    """Index of the first column where each row reaches its minimum
    ``d0`` (jnp.argmin's tie rule, on every device)."""
    col = torch.arange(dist.shape[-1], device=dist.device)
    return torch.where(dist == d0[..., None], col,
                       torch.full_like(col, dist.shape[-1])).min(dim=-1).values


def _top2_min(dist: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise two smallest: (d0, idx0 = first argmin, d1 = min over the
    other columns)."""
    d0 = dist.min(dim=-1).values
    i0 = _first_argmin(dist, d0)
    masked = dist.scatter(-1, i0[..., None], _BIG)
    d1 = masked.min(dim=-1).values
    return d0, i0, d1


def match_ratio(da: torch.Tensor, db: torch.Tensor, valid_a: torch.Tensor,
                valid_b: torch.Tensor, ratio: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN(2) + Lowe ratio on L2 (ImageUtility.py:287-296 semantics):
    (train_idx, ok) per query, ok = valid query & d0 < ratio^2 d1 &
    a second valid train row exists."""
    dist = _pairwise_sq_l2(da, db)
    dist = torch.where(valid_b[..., None, :], dist,
                       torch.full_like(dist, _BIG))
    d0, i0, d1 = _top2_min(dist)
    return i0, ratio_ok(valid_a, d0, d1, ratio)


def ratio_ok(valid_a: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
             ratio: float) -> torch.Tensor:
    """The ratio test on squared distances (matcher.py:172-178)."""
    return valid_a & (d0 < (ratio * ratio) * d1) & (d1 < _BIG)


def match_nearest_hamming(da: torch.Tensor, db: torch.Tensor,
                          valid_a: torch.Tensor, valid_b: torch.Tensor,
                          max_distance: float = 1e9
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain nearest-neighbour Hamming match (ImageUtility.py:297-302):
    (train_idx = the first nearest valid train row, ok = valid query and
    distance <= ``max_distance``), each (..., Ka)."""
    dist = _pairwise_hamming(da, db)
    dist = torch.where(valid_b[..., None, :], dist,
                       torch.full_like(dist, _BIG))
    d0 = dist.min(dim=-1).values
    i0 = _first_argmin(dist, d0)
    return i0, valid_a & (d0 <= max_distance) & (d0 < _BIG)


def match_batch(da: torch.Tensor, db: torch.Tensor, valid_a: torch.Tensor,
                valid_b: torch.Tensor, ratio: float, max_distance: float,
                metric: str = "l2", use_kernel: bool = True):
    """(P, K, D) descriptors -> (train_idx, ok), each (P, K): L2 ratio
    matches (K5 on the card) or, for ``metric="hamming"``, nearest
    Hamming matches within ``max_distance``."""
    if metric != "l2":
        return match_nearest_hamming(da, db, valid_a, valid_b, max_distance)
    from ..kernels import matcher
    d0, i0, d1 = matcher.top2_l2(da, db, valid_b, use_kernel=use_kernel)
    return i0, ratio_ok(valid_a, d0, d1, ratio)


def match_batch_coords(da: torch.Tensor, db: torch.Tensor,
                       valid_a: torch.Tensor, valid_b: torch.Tensor,
                       rows_b: torch.Tensor, cols_b: torch.Tensor,
                       ratio: float, max_distance: float,
                       metric: str = "l2", use_kernel: bool = True):
    """(P, K, D) descriptors -> (train_idx, ok, rb_sel, cb_sel), each
    (P, K): L2 through K3, which also returns the matched train
    coordinates; Hamming through ``match_batch`` and a gather."""
    if metric != "l2":
        ti, ok = match_batch(da, db, valid_a, valid_b, ratio, max_distance,
                             metric)
        return ti, ok, rows_b.gather(-1, ti), cols_b.gather(-1, ti)
    from ..kernels import matcher
    d0, i0, d1, rb_sel, cb_sel = matcher.top2_l2_coords(
        da, db, valid_b, rows_b, cols_b, use_kernel=use_kernel)
    return i0, ratio_ok(valid_a, d0, d1, ratio), rb_sel, cb_sel
