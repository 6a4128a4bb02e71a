"""Incremental-ROI registration: the host replay.

Port, line for line, of the host code of ``imagestitch_tpu/core/registration.py``
(:30-49, :85-167, :191-199): the per-pair record, the power-of-two subset
buckets and the replay of the reference's scale-growth x direction-rotation
search (Stitcher.py:306-367), including the direction that persists across
pairs (Stitcher.py:361).  Attempt results come from a cache that evaluates
every (direction, scale) configuration for many pairs at once; the replay
is exact because an attempt's outcome depends only on (pair, direction,
scale).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import StitchConfig, direction_increase, max_roi_scale
from ..ops import roi


@dataclasses.dataclass
class PairRegistration:
    """Structured per-pair record."""
    ok: bool
    offset: Tuple[int, int]            # (drow, dcol) — reference's [dx, dy]
    offset_subpix: Tuple[float, float]  # sub-pixel offset for the global solver
    direction: int                     # direction that matched (0 if failed)
    scale: int                         # ROI scale i that matched (0 if failed)
    confidence: float                  # modal vote count
    attempts: int                      # number of attempts consumed


def bucket_size(n: int) -> int:
    """Round a subset size up to a power of two."""
    b = 1
    while b < n:
        b *= 2
    return b


def pad_indices(idx: np.ndarray) -> Tuple[np.ndarray, int]:
    """Pad a subset-index vector to its power-of-two bucket (repeat last)."""
    n = len(idx)
    b = bucket_size(n)
    if b == n:
        return idx, n
    return np.concatenate([idx, np.full(b - n, idx[-1], idx.dtype)]), n


def _replay_incremental(num_pairs: int, cfg: StitchConfig, cache,
                        accept: Callable[[Dict[str, float]], bool],
                        extract: Callable[[Dict[str, float]],
                                          Tuple[float, float, float]],
                        shape: Tuple[int, int],
                        offsets_are_full: bool = False,
                        pairs: Optional[Sequence[int]] = None
                        ) -> List[PairRegistration]:
    """Replay the reference's scale-growth x direction-rotation search.

    ``cache.get(direction, scale, ratio, pair, prefetch)`` returns one
    attempt's result; ``accept(result)`` decides whether it succeeded;
    ``extract`` returns (drow_f, dcol_f, confidence).  ``offsets_are_full``:
    the cache already reports full-image offsets (pooled path) — skip the
    strip margin correction.  ``pairs``: optional explicit pair subset;
    results align with ``pairs`` order and direction persists across it.
    """
    out: List[PairRegistration] = []
    direction = cfg.direction
    max_i = max_roi_scale(cfg.roi_ratio)
    pair_list = list(range(num_pairs)) if pairs is None else list(pairs)
    for ki, k in enumerate(pair_list):
        ini_direction = direction
        local_direction = ini_direction
        status = False
        attempts = 0
        best = None
        best_conf = 0.0   # max confidence seen across FAILED attempts
        unresolved = pair_list[ki:]
        for i in range(1, max_i):
            while True:
                # scale-1 configs are what later pairs will mostly need;
                # deeper scales are rare — prefetch narrowly there
                pf = unresolved if i == 1 else list(unresolved)[:8]
                res = cache.get(local_direction, i, cfg.roi_ratio, k,
                                prefetch=pf)
                attempts += 1
                if accept(res):
                    status = True
                    best = (local_direction, i, extract(res))
                else:
                    best_conf = max(best_conf, extract(res)[2])
                if status:
                    break
                local_direction = direction_increase(local_direction, cfg.direct_incre)
                if local_direction == ini_direction:
                    break
            if status:
                break
        if status:
            d, i, (drow_f, dcol_f, conf) = best
            if offsets_are_full:
                mr = mc = 0
            else:
                mr, mc = roi.margin_correction(d, shape, shape,
                                               i * cfg.roi_ratio)
            # reference truncates the sub-pixel strip offset BEFORE the margin
            # correction (Stitcher.py:231-232 then :243-253)
            drow = int(drow_f) + mr
            dcol = int(dcol_f) + mc
            direction = d
            out.append(PairRegistration(
                ok=True, offset=(drow, dcol),
                offset_subpix=(drow_f + mr, dcol_f + mc),
                direction=d, scale=i, confidence=conf, attempts=attempts))
        else:
            out.append(PairRegistration(
                ok=False, offset=(0, 0), offset_subpix=(0.0, 0.0),
                direction=0, scale=0, confidence=best_conf,
                attempts=attempts))
    return out


def register_sequence_features_incre(images, cfg: StitchConfig,
                                     device=None) -> List[PairRegistration]:
    from . import feature_registration
    return feature_registration.register_sequence_features_incre(
        images, cfg, device=device)


def register_sequence_features(images, cfg: StitchConfig,
                               device=None) -> List[PairRegistration]:
    from . import feature_registration
    return feature_registration.register_sequence_features(
        images, cfg, device=device)
