"""Incremental-ROI registration: the host replay and the phase paths.

Port of ``imagestitch_tpu/core/registration.py``: the per-pair record, the
power-of-two subset buckets, the attempt cache and the replay of the
reference's scale-growth x direction-rotation search (Stitcher.py:205-258,
:306-367), including the direction that persists across pairs
(Stitcher.py:361).  Attempt results come from a cache that evaluates every
(direction, scale) configuration for many pairs at once; the replay is
exact because an attempt's outcome depends only on (pair, direction,
scale).

The phase-correlation registrars: ``register_sequence_phase`` (incremental
strips, the reference's phaseCorrelate method), ``register_sequence_phase_
whole`` (whole frames, linear padding, for large shifts) and
``register_sequence_hybrid`` (features, with phase for the pairs they
cannot register).  The JAX package computes them in plain XLA; here they
are ``torch.fft`` (ops/phase_corr.py) on the images' device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import StitchConfig, direction_increase, max_roi_scale
from .. import device as device_mod
from ..ops import phase_corr, roi
from ..parallel import tp_fft


@dataclasses.dataclass
class PairRegistration:
    """Structured per-pair record."""
    ok: bool
    offset: Tuple[int, int]            # (drow, dcol) — reference's [dx, dy]
    offset_subpix: Tuple[float, float]  # sub-pixel offset for the global solver
    direction: int                     # direction that matched (0 if failed)
    scale: int                         # ROI scale i that matched (0 if failed)
    confidence: float                  # phase response / modal vote count
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


def _as_images(images, device, caller: str) -> torch.Tensor:
    """An (N, H, W) batch as a tensor: a tensor stays where it lies, numpy
    frames go to ``device`` (a CUDA device without CUDA raises, naming
    ``device='cpu'``).  ``device`` applies to numpy frames only, as in
    ``compose``: a caller moves a tensor itself (``Stitcher.register``)."""
    if isinstance(images, torch.Tensor):
        return images
    return device_mod.to_device(images,
                                device_mod.resolve_device(device, caller))


class AttemptCache:
    """Lazily-materialized (direction, scale, pair) attempt results.

    ``evaluator(direction, ratio, pair_indices)`` evaluates one configuration
    for an explicit subset of pairs in a single batched dispatch and returns
    host arrays aligned with ``pair_indices``.  When the replay demands a
    missing (config, pair) result, the whole set of still-unresolved pairs is
    prefetched speculatively in the same dispatch — the sequential semantics
    stay exact (an attempt's outcome depends only on (pair, direction,
    scale)), while resolved pairs stop consuming device time.
    """

    def __init__(self, evaluator: Callable[[int, float, np.ndarray],
                                           Dict[str, np.ndarray]]):
        self._evaluator = evaluator
        self._cache: Dict[Tuple[int, int], Dict[int, Dict[str, float]]] = {}
        self.dispatches = 0
        self.pairs_evaluated: set = set()

    def get(self, direction: int, scale: int, ratio: float, pair: int,
            prefetch: Sequence[int]) -> Dict[str, float]:
        key = (direction, scale)
        store = self._cache.setdefault(key, {})
        if pair not in store:
            todo = [pair] + [p for p in prefetch if p != pair and p not in store]
            idx = np.asarray(sorted(todo), np.int32)
            res = self._evaluator(direction, scale * ratio, idx)
            self.dispatches += 1
            self.pairs_evaluated.update(int(p) for p in idx)
            for j, p in enumerate(idx):
                store[int(p)] = {k: v[j] for k, v in res.items()}
        return store[pair]


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


# --------------------------------------------------------------------------
# Phase-correlation incremental registrar (reference Stitcher.py:205-258)
# --------------------------------------------------------------------------

#: bytes one batched phase-correlation call may hold: about ten float32
#: surfaces of the padded size per pair (the padded pair, the spectra, the
#: cross-power spectrum, the correlation map and its shifted copy)
PHASE_BATCH_BYTES = 1 << 30


def _phase_attempt(images: torch.Tensor, idx: torch.Tensor, direction: int,
                   ratio: float, hp: int, wp: int) -> np.ndarray:
    """Selected pairs' strips for one (direction, ratio) -> phase
    correlation, in chunks of pairs that keep each call's surfaces within
    ``PHASE_BATCH_BYTES``.

    ``images``: (N, H, W) uint8 device batch; ``idx``: (B,) pair indices
    (pair k = images k, k+1).  Returns the host (3, B) array of
    (shift_x, shift_y, response): one readback per dispatch.
    """
    ra, rb = roi.extract_strips(images[:-1], images[1:], direction, ratio)
    chunk = max(1, PHASE_BATCH_BYTES // (10 * 4 * hp * wp))
    out = [torch.stack(phase_corr._phase_correlate_one(
        ra[sub].to(torch.float32), rb[sub].to(torch.float32), hp, wp))
        for sub in idx.split(chunk)]
    return torch.cat(out, dim=1).cpu().numpy()


# Introspection for tests/harnesses: dispatch + pair-subset accounting of the
# most recent register_sequence_phase call (e.g. the hybrid fallback must only
# evaluate the failed pairs, not re-sweep the sequence).
LAST_PHASE_STATS: Dict[str, object] = {}


def register_sequence_phase(images, cfg: StitchConfig,
                            pairs: Optional[Sequence[int]] = None,
                            device="cuda") -> List[PairRegistration]:
    """Incremental phase-correlation registration of a full sequence.

    ``images``: (N, H, W) uint8 grayscale batch: a tensor registers where
    it lies, numpy frames on ``device`` (the card unless the caller passes
    ``device="cpu"``).
    Replaces the reference's per-pair, per-attempt cv2.phaseCorrelate loop.
    ``pairs``: optional explicit subset of pair indices to register (results
    align with ``pairs``); used by the hybrid fallback so one failed pair
    costs one-pair dispatches, not a full-sequence sweep.
    """
    images = _as_images(images, device, "register_sequence_phase")
    n, h, w = images.shape
    if n < 2:
        return []

    def evaluator(direction: int, ratio: float, idx: np.ndarray
                  ) -> Dict[str, np.ndarray]:
        if direction in (1, 3):
            sh, sw = roi.strip_length(h, ratio), w
        else:
            sh, sw = h, roi.strip_length(w, ratio)
        hp = phase_corr.optimal_dft_size(sh)
        wp = phase_corr.optimal_dft_size(sw)
        sx, sy, resp = _phase_attempt(
            images, torch.as_tensor(idx, dtype=torch.long,
                                    device=images.device),
            direction, ratio, hp, wp)
        return {"sx": sx, "sy": sy, "resp": resp}

    cache = AttemptCache(evaluator)

    def accept(res: Dict[str, float]) -> bool:
        return bool(res["resp"] > cfg.phase_response_threshold)

    def extract(res: Dict[str, float]) -> Tuple[float, float, float]:
        # cv2.phaseCorrelate returns (x, y) = the NEGATIVE of the window
        # displacement of B relative to A, so the strip-local offset the
        # margin correction expects is (-y, -x).  The reference adds +y/+x
        # (Stitcher.py:231-232), a sign inversion that the JAX package
        # repairs and the port keeps repaired.  Truncation commutes with
        # negation (int() truncates toward zero).
        return -float(res["sy"]), -float(res["sx"]), float(res["resp"])

    out = _replay_incremental(n - 1, cfg, cache, accept, extract, (h, w),
                              pairs=pairs)
    LAST_PHASE_STATS.clear()
    LAST_PHASE_STATS.update(dispatches=cache.dispatches,
                            pairs_evaluated=sorted(cache.pairs_evaluated))
    return out


def _phase_whole(images: torch.Tensor, hp: int, wp: int):
    """All adjacent pairs, whole-image linear phase correlation.

    Mean subtraction before zero-padding removes the content->pad step edge
    shared by both images (a broadband artifact that otherwise correlates at
    exactly zero shift and beats small-overlap true peaks); the response is
    renormalized from padded area to true image area so the acceptance
    threshold keeps cv2's scale.  One pair at a time, as the JAX package's
    ``lax.map``: the padded surfaces of a 2k x 2.6k pair take ~1 GB.
    """
    n, h, w = images.shape
    x = images.to(torch.float32)
    # a tensor count: a CUDA division by a Python scalar is not IEEE
    count = torch.tensor(float(h * w), device=x.device)
    x = x - x.sum(dim=(1, 2), keepdim=True) / count
    out = [torch.stack(phase_corr._phase_correlate_one(
        x[k:k + 1], x[k + 1:k + 2], hp, wp)) for k in range(n - 1)]
    sx, sy, resp = torch.cat(out, dim=1).cpu().numpy()
    return sx, sy, resp * np.float32(float(hp) * wp / (h * w))


def _phase_whole_sharded(images, cfg: StitchConfig, mesh, hp: int, wp: int
                         ) -> List[PairRegistration]:
    """The over-budget route of ``register_sequence_phase_whole`` (JAX
    registration.py:305-320): host float32 mean subtraction per frame,
    then one tensor-parallel correlation a pair, its response renormalized
    from padded area to image area."""
    host = (images.cpu().numpy() if isinstance(images, torch.Tensor)
            else np.asarray(images)).astype(np.float32)
    n, h, w = host.shape
    host = host - host.mean(axis=(1, 2), keepdims=True)
    out: List[PairRegistration] = []
    for k in range(n - 1):
        sxk, syk, rk = tp_fft.phase_correlate_sharded(
            host[k], host[k + 1], mesh, hp, wp)
        rk *= float(hp) * wp / (h * w)
        ok = bool(rk > cfg.phase_response_threshold)
        out.append(PairRegistration(
            ok=ok, offset=(int(np.round(-syk)), int(np.round(-sxk))),
            offset_subpix=(float(-syk), float(-sxk)),
            direction=cfg.direction if ok else 0,
            scale=0, confidence=float(rk), attempts=1))
    return out


def register_sequence_phase_whole(images, cfg: StitchConfig, mesh=None,
                                  device="cuda") -> List[PairRegistration]:
    """Whole-image phase correlation of every adjacent pair.

    Working replacement for the reference's vestigial
    ``calculateOffsetForPhaseCorrleate`` (Stitcher.py:184-203): offset =
    [round(y), round(x)] per its intended semantics (Stitcher.py:198-199),
    with the JAX package's repairs for LARGE shifts: padding to >= 2*dim
    (the full linear cross-correlation; padding only to the optimal DFT
    size >= dim would alias any shift beyond half of it), mean subtraction
    and the response renormalized to image area (``_phase_whole``).

    With a ``mesh`` (JAX :305-320) the pairs run on one device, the mesh's
    first, as long as one pair's padded surfaces fit
    ``cfg.phase_hbm_budget`` (about 0.97 GB at 1936x2584, under the 2 GiB
    default).  Beyond it, on two or more shards, each pair's FFT is split
    over the mesh (``parallel/tp_fft.phase_correlate_sharded``): the
    frames are mean-subtracted on the host in float32, one sharded
    correlation runs a pair, and no device holds a whole padded surface.
    """
    if mesh is not None:
        n, h, w = images.shape
        hp = phase_corr.optimal_dft_size(2 * h)
        wp = phase_corr.optimal_dft_size(2 * w)
        if mesh.size > 1 and 6 * hp * wp * 8 > cfg.phase_hbm_budget:
            return _phase_whole_sharded(images, cfg, mesh, hp, wp)
        device = mesh.devices[0]
    images = _as_images(images, device, "register_sequence_phase_whole")
    n, h, w = images.shape
    if n < 2:
        return []
    hp = phase_corr.optimal_dft_size(2 * h)
    wp = phase_corr.optimal_dft_size(2 * w)
    sx, sy, resp = _phase_whole(images, hp, wp)
    out: List[PairRegistration] = []
    for k in range(n - 1):
        ok = bool(resp[k] > cfg.phase_response_threshold)
        # negate: cv2's (x, y) is minus the B-relative-to-A displacement
        out.append(PairRegistration(
            ok=ok,
            offset=(int(np.round(-sy[k])), int(np.round(-sx[k]))),
            offset_subpix=(float(-sy[k]), float(-sx[k])),
            direction=cfg.direction if ok else 0,
            scale=0, confidence=float(resp[k]), attempts=1))
    return out


def register_sequence_hybrid(images, cfg: StitchConfig, device="cuda"
                             ) -> List[PairRegistration]:
    """Feature registration with per-pair phase-correlation fallback.

    Feature results win where they register; phase fills the gaps (the
    JAX package's demo: zirconTEM registers 8/8 pairs hybrid against 7/8
    with features alone).  The fallback evaluates ONLY the failed pairs
    (subset dispatch), and its search starts from the direction the last
    successful feature pair before the first failure established.
    """
    from . import feature_registration
    images = _as_images(images, device, "register_sequence_hybrid")
    feat = feature_registration.register_sequence_features_incre(images, cfg)
    failed = [k for k, r in enumerate(feat) if not r.ok]
    if not failed:
        return feat
    direction = cfg.direction
    for k in range(failed[0] - 1, -1, -1):
        if feat[k].ok and feat[k].direction:
            direction = feat[k].direction
            break
    phase = register_sequence_phase(images, cfg.replace(direction=direction),
                                    pairs=failed)
    out = list(feat)
    for k, p in zip(failed, phase):
        out[k] = p
    return out


# --------------------------------------------------------------------------
# Feature-search registrars (reference Stitcher.py:260-367), implemented in
# core/feature_registration.py
# --------------------------------------------------------------------------

def register_sequence_features_incre(images, cfg: StitchConfig,
                                     device="cuda") -> List[PairRegistration]:
    from . import feature_registration
    return feature_registration.register_sequence_features_incre(
        images, cfg, device=device)


def register_sequence_features(images, cfg: StitchConfig,
                               device="cuda") -> List[PairRegistration]:
    from . import feature_registration
    return feature_registration.register_sequence_features(
        images, cfg, device=device)
