"""Frame-sharded pooled feature registration: the flagship over a mesh.

Port of ``imagestitch_tpu/parallel/pooled_sharded.py`` (:45-335), the
incremental ROI scale growth x direction rotation with its exact host
replay (reference Stitcher.py:306-367) over a ``parallel.mesh.Mesh``:
  * the keypoint pool is computed frame-sharded, each shard's frames by
    the port's own ``pool_features`` on the shard's device (on the card
    the fused pool, K1 and K2, or the score-map pool, K4, as one device
    picks them), with no communication;
  * each dispatch evaluates its (direction, scale) configurations for ALL
    adjacent pairs: the strip top-k runs frame-parallel on each shard,
    then ONE ``ppermute`` ships each shard's first frame's B-side
    selection (k_sel rows of coordinates, validity and descriptors) to its
    predecessor, and each shard matches (K3 on the card) and votes its
    local pairs; the shards' packed (n_configs, 6, n_local) results are
    gathered and read back once a dispatch;
  * the reference's sequential decision procedure replays unchanged on the
    host (core/registration._replay_incremental), and the pairs the
    upright pool leaves take the single-device oriented fallback (K4).
Each dispatch launches every shard's work before its one readback, so
shards on distinct cards overlap.  Frames pad to a multiple of the shard count by repeating
the last frame; the records of pairs past the last real one are never
read.  The pool, strip selections, matches and votes of every real pair
are those of the single-device path, so the records are too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import StitchConfig, max_roi_scale
from ..core import feature_registration as freg
from ..core import registration as reg
from ..device import to_device
from .mesh import all_gather, pad_to_multiple, ppermute, shard


def shard_frames(images, mesh) -> Tuple[List[torch.Tensor], int]:
    """Pad the frame axis to a multiple of the mesh size (at least one
    frame a shard) by repeating the last frame, and split it, block i on
    ``mesh.devices[i]``.  Returns (per-shard frames, n_true)."""
    n = images.shape[0]
    idx = np.minimum(np.arange(pad_to_multiple(max(n, mesh.size),
                                               mesh.size)), n - 1)
    if isinstance(images, torch.Tensor):
        return shard(images[torch.as_tensor(idx, device=images.device)],
                     mesh), n
    return shard(np.asarray(images)[idx], mesh), n


def pool_features_sharded(shards, cfg: StitchConfig, sparams=None,
                          max_pool=None):
    """Each shard's keypoint pool, (rows, cols, scores, descs), computed on
    the shard's device by ``pool_features``, with the same route as one
    device (JAX :49-60): ``use_pallas`` with ``fused_select`` takes the
    fused pool for upright SURF, the score-map pool for the other
    Gaussian-DoH frames, and the XLA detector otherwise.  The fused pool
    reads nothing back, so on distinct cards the shards overlap; the
    score-map pool reads each frame's survivor counts."""
    max_pool = max_pool or freg._capacity(cfg, cfg.features.pool_keypoints)
    sparams = sparams or freg._describe_params(cfg)
    return [freg.pool_features(x, freg._detect_params(cfg), sparams,
                               max_pool=max_pool,
                               fused_select=cfg.features.fused_select,
                               use_kernels=cfg.use_kernels,
                               use_pallas=cfg.use_pallas) for x in shards]


def _attempt_all_pairs(pools, mesh, bounds_list, k_sel: int, metric: str,
                       search_ratio: float, max_distance: float,
                       use_kernels: bool, vote_method: str) -> np.ndarray:
    """Evaluate (direction, scale) configurations for ALL adjacent pairs
    (JAX :92-195).  Per shard and config: the strip top-k of every local
    frame's A and B sides; then one ``ppermute`` of each shard's first
    frame's B selections (all configs together) to its predecessor; then
    one match (K3) and vote over the shard's configs x local pairs.

    Returns the host (n_configs, 6, N_pad) float32 array (drow, dcol,
    votes, sub_r, sub_c, any_valid); pair k is frames (k, k + 1), and
    entries at k >= N - 1 are padding or wraparound the replay never
    reads."""
    sel = []
    for pool in pools:
        local = torch.arange(pool[0].shape[0], device=pool[0].device)
        sel.append([(freg._select_strip(pool, local, ba, k_sel),
                     freg._select_strip(pool, local, bb, k_sel))
                    for ba, bb in bounds_list])
    # the halo: each shard's first frame's B side of every config
    halos = ppermute([tuple(t[:1] for _, b in cfg_sel for t in b)
                      for cfg_sel in sel], mesh)
    out = []
    for cfg_sel, halo in zip(sel, halos):
        sel_b = [tuple(torch.cat([t[1:], h]) for t, h in
                       zip(b, halo[4 * c:4 * c + 4]))
                 for c, (_, b) in enumerate(cfg_sel)]
        out.append(freg._match_vote_packed(
            [a for a, _ in cfg_sel], sel_b, bounds_list, metric,
            search_ratio, max_distance, use_kernels, vote_method))
    return all_gather(out, mesh, dim=-1).cpu().numpy()


class ShardedPooledCache:
    """``_PooledCache``-compatible store that always evaluates all pairs
    (JAX :197-253): a big sweep (more than ``_SMALL`` pairs to prefetch)
    computes all four directions of the requested scale not yet stored;
    a small one speculates every remaining (direction, scale)."""

    _SMALL = 16

    def __init__(self, pools, cfg: StitchConfig, h: int, w: int, metric: str,
                 mesh=None):
        self._pools = pools
        self._cfg = cfg
        self._hw = (h, w)
        self._metric = metric
        self._mesh = mesh
        self._store: Dict[Tuple[int, int], Dict[int, Dict[str, float]]] = {}
        self.dispatches = 0
        self.attempts_matched = 0

    def get(self, direction: int, scale: int, ratio: float, pair: int,
            prefetch) -> Dict[str, float]:
        store = self._store.setdefault((direction, scale), {})
        if pair not in store:
            cfg = self._cfg
            h, w = self._hw
            if len(list(prefetch)) > self._SMALL:
                configs = [(direction, scale)] + [
                    (d, scale) for d in (1, 2, 3, 4)
                    if d != direction and (d, scale) not in self._store]
            else:
                configs = [(d, s) for s in range(scale, max_roi_scale(ratio))
                           for d in (1, 2, 3, 4)
                           if (d, s) not in self._store]
                if (direction, scale) not in configs:
                    configs.insert(0, (direction, scale))
            bounds = tuple(
                (freg._strip_bounds(d, "first", s * ratio, h, w),
                 freg._strip_bounds(d, "second", s * ratio, h, w))
                for d, s in configs)
            results = _attempt_all_pairs(
                self._pools, self._mesh, bounds,
                freg._capacity(cfg, cfg.features.max_keypoints),
                self._metric, cfg.features.search_ratio,
                freg._effective_max_distance(cfg), cfg.use_kernels,
                cfg.offset_calculate)
            self.dispatches += 1
            n_pairs = int(results.shape[-1])
            self.attempts_matched += n_pairs * len(configs)
            for (d, s), pk in zip(configs, results):
                dstore = self._store.setdefault((d, s), {})
                nv, sr, sc, av = pk[2], pk[3], pk[4], pk[5]
                for p in range(n_pairs):
                    dstore[p] = {"drow": float(sr[p]), "dcol": float(sc[p]),
                                 "votes": float(nv[p]),
                                 "nz": float(nv[p]) if av[p] > 0.5 else 0.0}
        return store[pair]


def register_sequence_features_incre_sharded(images, cfg: StitchConfig,
                                             mesh
                                             ) -> List[reg.PairRegistration]:
    """The flagship registration over ``mesh`` (JAX :256-283): sharded pool,
    all-pairs sharded attempts, the exact host replay, and the oriented
    fallback of the pairs the upright pool leaves, on the mesh's first
    device.  ``images``: (N, H, W) uint8, numpy or a tensor."""
    n, h, w = images.shape
    if n < 2:
        return []
    shards, _ = shard_frames(images, mesh)
    fast, cfg_pool = freg._upright_first(cfg)
    pools = pool_features_sharded(shards, cfg_pool)
    _, _, metric = freg._families(cfg_pool)
    cache = ShardedPooledCache(pools, cfg_pool, h, w, metric, mesh=mesh)
    recs = reg._replay_incremental(
        n - 1, cfg_pool, cache, freg._pool_accept(cfg_pool),
        freg._pool_extract, (h, w), offsets_are_full=True)
    if fast and any(not r.ok for r in recs):
        recs = freg._oriented_fallback_incre(
            to_device(images, mesh.devices[0]), recs, cfg, (h, w))
    return recs


def register_sequence_features_sharded(images, cfg: StitchConfig, mesh
                                       ) -> List[reg.PairRegistration]:
    """Whole-image feature search over ``mesh`` (JAX :286-335): the
    frame-sharded pool (``max_keypoints`` slots where the score-map or the
    XLA pool runs), each pair's top-``max_keypoints`` keypoints of the
    whole frames matched through the halo'd all-pairs step, and the
    oriented retry of failed pairs with some valid match over a pool of
    their frames on the mesh's first device (K5)."""
    n, h, w = images.shape
    if n < 2:
        return []
    shards, _ = shard_frames(images, mesh)
    fast, _ = freg._upright_first(cfg)
    sparams = freg._describe_params(cfg)
    sparams_fast = dataclasses.replace(sparams, upright=True) if fast \
        else sparams
    max_kp = freg._capacity(cfg, cfg.features.max_keypoints)
    pools = pool_features_sharded(shards, cfg, sparams_fast, max_pool=max_kp)
    _, _, metric = freg._families(cfg)
    whole = ((0, h, 0, w), (0, h, 0, w))    # the "strip" is the full frame
    dr, dc, nv, sr, sc, av = _attempt_all_pairs(
        pools, mesh, (whole,), max_kp, metric, cfg.features.search_ratio,
        freg._effective_max_distance(cfg), cfg.use_kernels,
        cfg.offset_calculate)[0]
    out: List[reg.PairRegistration] = []
    for k in range(n - 1):
        okk = bool(nv[k] >= cfg.offset_evaluate)
        out.append(reg.PairRegistration(
            ok=okk, offset=(int(dr[k]), int(dc[k])) if okk else (0, 0),
            offset_subpix=(float(sr[k]), float(sc[k])) if okk else (0.0, 0.0),
            direction=cfg.direction if okk else 0,
            scale=0, confidence=float(nv[k]) if av[k] > 0.5 else 0.0,
            attempts=1))
    # confidence 0 is the floor-zeroed vote count: no valid displacement,
    # nothing for oriented descriptors to rescue
    failed = [k for k, r in enumerate(out) if not r.ok and r.confidence > 0.0]
    if fast and failed:
        frames = sorted({f for k in failed for f in (k, k + 1)})
        fmap = {f: i for i, f in enumerate(frames)}
        dev0 = mesh.devices[0]
        imgs = to_device(images, dev0)
        mini = freg.pool_features(
            imgs[torch.as_tensor(frames, device=dev0)],
            freg._detect_params(cfg), sparams, max_pool=max_kp,
            fused_select=cfg.features.fused_select,
            use_kernels=cfg.use_kernels, use_pallas=cfg.use_pallas)
        sub = freg._match_vote_adjacent(
            mini, np.asarray([fmap[k] for k in failed]), cfg, metric)
        for k, r in zip(failed, sub):
            out[k] = r
    return out
