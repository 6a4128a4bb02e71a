"""Sharded batched registration steps.

Port of ``imagestitch_tpu/parallel/pipeline.py`` (:36-336).  Adjacent-pair
registration is data-parallel over the mesh:
  * phase: pair tensors split into equal per-shard blocks, each shard's
    pairs phase-correlated (``torch.fft``) on its device with no
    communication; the per-pair outputs are gathered on shard 0's device;
  * feature: frames split over the shards; each shard detects and
    describes its frames with the XLA detector (JAX :132-134), selects its
    strip top-k, receives its successor's first frame's B-side selection by
    ONE ``ppermute`` and matches (K3 on the card) and votes its local
    pairs;
and each step ends in the edge-sharded pose-graph solve
(``distributed_stitch_step``, ``distributed_stitch_step_features``).
``feature_step_collectives`` counts the feature step's collectives
(``parallel.mesh.COLLECTIVES``), where the JAX package reads compiled HLO.
Without a mesh each step runs on one ``device``, the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import StitchConfig
from ..device import resolve_device, to_device
from ..ops import phase_corr, roi
from ..solver import pose_graph as pg
from . import mesh as mesh_mod
from .mesh import all_gather, pad_to_multiple, ppermute, shard

Pairs = Union[torch.Tensor, List[torch.Tensor]]


def _blocks(x: Pairs) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _gather(outs, mesh) -> Tuple[torch.Tensor, ...]:
    """Per-shard output tuples -> each output concatenated on shard 0's
    device (one all-gather a step)."""
    if mesh is None or len(outs) == 1:
        return tuple(torch.cat([o[j] for o in outs]) for j in range(
            len(outs[0])))
    packed = all_gather([torch.stack(o) for o in outs], mesh, dim=1)
    return tuple(packed)


def make_pair_tensors(images, mesh=None, device="cuda"
                      ) -> Tuple[Pairs, Pairs, int]:
    """(N, H, W) batch -> A and B pair tensors (pair k = frames k, k + 1)
    and the number of real pairs.  Without a mesh: one upload to
    ``device`` (a tensor stays where it lies), sliced there.  With one:
    the pairs padded to a multiple of the mesh size by repeating the last
    pair, split into per-shard blocks."""
    n_pairs = images.shape[0] - 1
    if mesh is None:
        dev = images if isinstance(images, torch.Tensor) else to_device(
            images, resolve_device(device, "make_pair_tensors"))
        return dev[:-1], dev[1:], n_pairs
    idx = torch.as_tensor(np.minimum(np.arange(pad_to_multiple(
        max(n_pairs, mesh.size), mesh.size)), n_pairs - 1))
    host = torch.as_tensor(np.asarray(images.cpu() if isinstance(
        images, torch.Tensor) else images))
    return shard(host[idx], mesh), shard(host[idx + 1], mesh), n_pairs


def register_pairs_sharded(a: Pairs, b: Pairs, direction: int, ratio: float,
                           mesh=None):
    """Strip phase correlation of every pair of (possibly sharded) pair
    tensors in ``direction`` at ``ratio`` -> (shift_x, shift_y, response),
    each (P,) on the first shard's device."""
    a, b = _blocks(a), _blocks(b)
    h, w = a[0].shape[-2], a[0].shape[-1]
    if direction in (1, 3):
        sh, sw = roi.strip_length(h, ratio), w
    else:
        sh, sw = h, roi.strip_length(w, ratio)
    hp, wp = phase_corr.optimal_dft_size(sh), phase_corr.optimal_dft_size(sw)
    outs = []
    for x, y in zip(a, b):
        ra, rb = roi.extract_strips(x, y, direction, ratio)
        outs.append(phase_corr._phase_correlate_one(
            ra.to(torch.float32), rb.to(torch.float32), hp, wp))
    return _gather(outs, mesh)


def register_pairs_sharded_whole(a: Pairs, b: Pairs, mesh=None):
    """Whole-tile LINEAR (2x-padded) phase correlation of every pair.

    Direction-free: any physically possible shift is unambiguous (the
    repair of core/registration.register_sequence_phase_whole), so one
    step registers a serpentine grid whose in-row and row-transition pairs
    move in different directions.  Each pair is cast and mean-subtracted
    in its chunk, and each shard runs its pairs in chunks whose padded FFT
    temporaries stay within 2 GiB (JAX :94-105).  Offsets = (-sy, -sx)."""
    a, b = _blocks(a), _blocks(b)
    h, w = a[0].shape[-2], a[0].shape[-1]
    hp = phase_corr.optimal_dft_size(2 * h)
    wp = phase_corr.optimal_dft_size(2 * w)
    per_pair = 6 * hp * wp * 8
    scale = float(hp) * wp / (h * w)
    outs = []
    for x, y in zip(a, b):
        chunk = max(1, min(int(x.shape[0]), (2 << 30) // per_pair))
        count = torch.tensor(float(h * w), device=x.device)
        parts = []
        for c0 in range(0, x.shape[0], chunk):
            u, v = (t[c0:c0 + chunk].to(torch.float32) for t in (x, y))
            # a tensor count: a CUDA division by a Python scalar is not IEEE
            u = u - u.sum(dim=(1, 2), keepdim=True) / count
            v = v - v.sum(dim=(1, 2), keepdim=True) / count
            parts.append(phase_corr._phase_correlate_one(u, v, hp, wp))
        sx, sy, resp = (torch.cat([p[j] for p in parts]) for j in range(3))
        outs.append((sx, sy, resp * scale))
    return _gather(outs, mesh)


def _feature_pairs_body(shards: Sequence[torch.Tensor], max_kp: int,
                        k_sel: int, dparams, sparams, metric: str,
                        search_ratio: float, max_distance: float, bounds_a,
                        bounds_b, vote_method: str, use_kernels: bool, halo):
    """The feature attempt over per-shard frames (JAX :122-171): each
    shard's XLA-detector pool of its frames and the strip top-k of both
    sides; then ``halo`` maps the shards' B-side selections to the ones
    aligned so that local pair k is A[k] against B[k + 1]; then each
    shard's match (K3 on the card) and vote.  Every shard is launched
    before any readback.  Returns per shard (drow, dcol, votes, sub_r,
    sub_c), each (n_local,); the entries past the sequence are junk."""
    from ..core import feature_registration as freg
    from ..ops.features import detect
    sel_a, sel_b = [], []
    for x in shards:
        per = [detect.detect_describe_image(im, max_kp, dparams, sparams)
               for im in x]
        pool = tuple(torch.stack([p[j] for p in per]) for j in range(4))
        local = torch.arange(x.shape[0], device=x.device)
        sel_a.append(freg._select_strip(pool, local, bounds_a, k_sel))
        sel_b.append(freg._select_strip(pool, local, bounds_b, k_sel))
    return [tuple(freg._match_vote_packed(
        [a], [b], ((bounds_a, bounds_b),), metric, search_ratio,
        max_distance, use_kernels, vote_method)[0][:5])
        for a, b in zip(sel_a, halo(sel_b))]


def _halo_fn(mesh):
    """The B-side alignment: on a mesh of two or more shards, ONE
    ``ppermute`` of each shard's first frame's selection to its
    predecessor, appended after the shard's own frames 1..; on one device
    the shard's own first frame (wraparound junk, never read)."""
    def halo(sel_b):
        firsts = [tuple(t[:1] for t in s) for s in sel_b]
        if mesh is not None:
            firsts = ppermute(firsts, mesh)
        return [tuple(torch.cat([t[1:], h]) for t, h in zip(s, f))
                for s, f in zip(sel_b, firsts)]
    return halo


def _feature_call_args(images, mesh, cfg: Optional[StitchConfig],
                       direction: int, ratio: float, device):
    """The per-shard frames (padded to the mesh by repeating the last
    frame; one block on ``device`` without a mesh) and the step's static
    arguments."""
    from ..core import feature_registration as freg
    from .pooled_sharded import shard_frames
    cfg = cfg or StitchConfig()
    n, h, w = images.shape
    if mesh is None:
        frames = [images if isinstance(images, torch.Tensor) else
                  torch.as_tensor(np.asarray(images)).to(
                      resolve_device(device, "register_pairs_sharded_"
                                             "features"))]
    else:
        frames, _ = shard_frames(images, mesh)
    _, _, metric = freg._families(cfg)
    args = (freg._capacity(cfg, cfg.features.pool_keypoints),
            freg._capacity(cfg, cfg.features.max_keypoints),
            freg._detect_params(cfg), freg._describe_params(cfg), metric,
            cfg.features.search_ratio, freg._effective_max_distance(cfg),
            freg._strip_bounds(direction, "first", ratio, h, w),
            freg._strip_bounds(direction, "second", ratio, h, w),
            cfg.offset_calculate, cfg.use_kernels)
    return n, frames, args


def register_pairs_sharded_features(images, mesh=None,
                                    cfg: Optional[StitchConfig] = None,
                                    direction: int = 1, ratio: float = 0.5,
                                    device="cuda"):
    """Frame-sharded feature registration of every adjacent pair in one
    (direction, ratio) strip attempt -> host arrays (drow, dcol, votes,
    subpix_row, subpix_col), each (N - 1,): full-image offsets (the strip
    margins cancelled, as on the pooled path)."""
    n, frames, args = _feature_call_args(images, mesh, cfg, direction,
                                         ratio, device)
    outs = _feature_pairs_body(frames, *args, halo=_halo_fn(mesh))
    return tuple(t.cpu().numpy()[:n - 1] for t in _gather(outs, mesh))


def feature_step_collectives(images, mesh=None,
                             cfg: Optional[StitchConfig] = None,
                             direction: int = 1, ratio: float = 0.5,
                             device="cuda") -> dict:
    """The collectives one feature step makes (``parallel.mesh``'s count:
    calls and payload bytes of each kind, and their ``total`` calls), where
    the JAX package counts the compiled HLO's (utils/hlo.py is on
    ROADMAP's do-not-port list)."""
    before = dict(mesh_mod.COLLECTIVES)
    register_pairs_sharded_features(images, mesh, cfg, direction, ratio,
                                    device)
    out = {k: mesh_mod.COLLECTIVES[k] - before[k] for k in before}
    out["total"] = sum(out[k] for k in ("psum", "ppermute", "all_gather"))
    return out


def distributed_stitch_step_features(images, mesh,
                                     cfg: Optional[StitchConfig] = None,
                                     direction: int = 1, ratio: float = 0.5,
                                     cg_iters: int = 64) -> np.ndarray:
    """The flagship step over ``mesh``: frame-sharded feature registration,
    then the pose-graph solve edge-sharded over the mesh.  Returns (N, 2)
    poses."""
    cfg = cfg or StitchConfig()
    dr, dc, nv, sr, sc = register_pairs_sharded_features(
        images, mesh, cfg, direction, ratio)
    offsets = np.stack([sr, sc], axis=1)
    conf = np.maximum(nv.astype(np.float64), 1e-3)
    graph = pg.PoseGraph.from_chain([tuple(o) for o in offsets], conf)
    return pg.solve(graph, iters=cg_iters, mesh=mesh)


def distributed_stitch_step(images, mesh, direction: int = 1,
                            ratio: float = 0.25, cg_iters: int = 64
                            ) -> np.ndarray:
    """One distributed step: pair-sharded strip phase registration, then
    the edge-sharded pose-graph solve.  Returns absolute (N, 2) poses."""
    a, b, n_pairs = make_pair_tensors(images, mesh)
    sx, sy, resp = (t.cpu().numpy()[:n_pairs] for t in
                    register_pairs_sharded(a, b, direction, ratio, mesh))
    mr, mc = roi.margin_correction(direction, images.shape[1:3],
                                   images.shape[1:3], ratio)
    # cv2-style (x, y) is minus the displacement: strip offset = (-y, -x)
    offsets = np.stack([-sy + mr, -sx + mc], axis=1)
    graph = pg.PoseGraph.from_chain([tuple(o) for o in offsets],
                                    np.maximum(resp, 1e-3))
    return pg.solve(graph, iters=cg_iters, mesh=mesh)
