"""Batched descriptor matching: squared-L2 kNN(2) + Lowe ratio.

Port of ``imagestitch_tpu/ops/features/match.py:29-136`` (the L2 metric of
the reference's BruteForce matcher, ImageUtility.py:278-296).  The pooled
replay calls ``match_batch_coords``, which goes through the K3 matcher
kernel and also returns each query's matched train coordinates; the
whole-image path calls ``match_batch``, which goes through K5
(``ops/kernels/matcher.py``).  The ratio test runs on squared distances
with ratio^2.
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


def _top2_min(dist: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise two smallest: (d0, idx0 = first argmin, d1 = min over the
    other columns)."""
    d0 = dist.min(dim=-1).values
    col = torch.arange(dist.shape[-1], device=dist.device)
    i0 = torch.where(dist == d0[..., None], col,
                     torch.full_like(col, dist.shape[-1])).min(dim=-1).values
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


def _require_l2(metric: str) -> None:
    if metric != "l2":
        raise NotImplementedError(
            f"metric {metric!r}: only L2 is ported (the Hamming metric is "
            f"ROADMAP Queue 1 item 17)")


def match_batch(da: torch.Tensor, db: torch.Tensor, valid_a: torch.Tensor,
                valid_b: torch.Tensor, ratio: float, max_distance: float,
                metric: str = "l2", use_kernel: bool = True):
    """(P, K, D) descriptors -> (train_idx, ok), each (P, K).

    ``max_distance`` serves the Hamming metric, which is not ported yet.
    """
    from ..kernels import matcher
    _require_l2(metric)
    d0, i0, d1 = matcher.top2_l2(da, db, valid_b, use_kernel=use_kernel)
    return i0, ratio_ok(valid_a, d0, d1, ratio)


def match_batch_coords(da: torch.Tensor, db: torch.Tensor,
                       valid_a: torch.Tensor, valid_b: torch.Tensor,
                       rows_b: torch.Tensor, cols_b: torch.Tensor,
                       ratio: float, max_distance: float,
                       metric: str = "l2", use_kernel: bool = True):
    """(P, K, D) descriptors -> (train_idx, ok, rb_sel, cb_sel), each (P, K).

    ``max_distance`` serves the Hamming metric, which is not ported yet.
    """
    from ..kernels import matcher
    _require_l2(metric)
    d0, i0, d1, rb_sel, cb_sel = matcher.top2_l2_coords(
        da, db, valid_b, rows_b, cols_b, use_kernel=use_kernel)
    return i0, ratio_ok(valid_a, d0, d1, ratio), rb_sel, cb_sel
