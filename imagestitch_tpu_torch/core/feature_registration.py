"""Feature registration: the pooled incremental search and the whole-image
search.

Port of ``imagestitch_tpu/core/feature_registration.py``:
  * ``register_sequence_features_incre`` — calculateOffsetForFeatureSearchIncre
    (reference: Stitcher.py:306-367), the VFSMS core.  Each frame is
    detected and described ONCE on the full frame, then every
    (direction, scale) attempt masks the keypoint pool to its search strip,
    matches (K3) and votes, and the host replays the
    reference's sequential search over those results
    (core/registration.py).  With ``auto_upright`` the pool is upright and
    pairs it cannot register retry over an oriented pool of just their
    frames (``_oriented_fallback_incre``).
  * ``register_sequence_features`` — calculateOffsetForFeatureSearch
    (reference: Stitcher.py:260-304): every adjacent pair matched over
    whole frames (K5) and voted, with the same oriented retry;
  * the strict per-ROI attempt (``strict_roi_detect``, and whenever
    enhancement is on): every (direction, scale) attempt detects each
    pair's strips with the XLA detector (``detect.detect_describe_image``),
    after enhancing them, matches them (K5) and votes; the host replays it
    through ``reg.AttemptCache`` (``_strict_attempt``).

Pools, per frame (``pool_features``), chosen as the JAX package chooses
them on a TPU: with ``use_pallas``, the fused per-row-select pool (K1 over
the octave bands of the pyramid atlas, one call a frame, and K2 over the
same atlas) for upright SURF with ``fused_select``, otherwise, for the
Gaussian-DoH detector, the score-map pool (K4 once a frame over the same
bands, each octave's exact top-k from the survivors it compacts,
sub-pixel refinement, global top-k, dense describe over the atlas),
upright or oriented, SURF or SIFT; the corner (ORB) and box-filter
families, every pool without ``use_pallas`` and the enhanced whole-image
path take the XLA detector's pool.

Every path votes by ``offset_calculate``: the mode, homography RANSAC
(``ransac.py``, with each pair's key taken from the JAX package's batch
and slot) or translation RANSAC.  The featureMethod families: SURF and
SIFT match by L2 (K3, K5), ORB by Hamming distance; the bf16 detector
raises (``check_supported``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import StitchConfig, max_roi_scale
from ..ops import enhance, roi
from ..ops.features import describe, detect, match, ransac, vote
from ..ops.kernels import describe as kdesc
from ..ops.kernels import doh as kdoh
from . import registration as reg


def check_supported(cfg: StitchConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item that will port it,
    for a registration configuration outside the ported slice."""
    if cfg.registration in ("phase_incre", "phase"):
        return      # the phase paths read no feature, enhance or vote knob
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"not ported: compute_dtype={cfg.compute_dtype!r} (a TPU-only "
            f"knob on ROADMAP's do-not-port list)")


def _enhance_mode(cfg: StitchConfig) -> str:
    if not cfg.enhance.enabled:
        return "none"
    return "clahe" if cfg.enhance.use_clahe else "equalize"


def _families(cfg: StitchConfig) -> Tuple[str, str, str]:
    """(detector_family, descriptor_family, metric) per featureMethod."""
    m = cfg.features.method
    if m == "orb":
        return "corner", "orb", "hamming"
    if m == "sift":
        return "hessian", "sift", "l2"
    if m == "surf" and cfg.features.extended:
        return "hessian", "surf-extended", "l2"
    return "hessian", "surf", "l2"


def _detect_params(cfg: StitchConfig) -> detect.DetectParams:
    """Static detector parameters from config (ImageUtility.py:23-40 knobs)."""
    f = cfg.features
    fam, _, _ = _families(cfg)
    return detect.DetectParams(
        family=fam, threshold=f.hessian_threshold,
        n_octaves=f.n_octaves, n_octave_layers=f.n_octave_layers,
        box_filter=f.box_filter, subpixel=f.subpixel,
        n_levels=f.orb_n_levels, scale_factor=f.orb_scale_factor,
        first_level=f.orb_first_level,
        fast_threshold=float(f.orb_fast_threshold),
        edge_threshold=f.orb_edge_threshold,
        dtype=cfg.compute_dtype,
        octave_topk_decay=f.octave_topk_decay)


def _describe_params(cfg: StitchConfig) -> describe.DescribeParams:
    """Static descriptor parameters from config."""
    f = cfg.features
    _, fam, _ = _families(cfg)
    return describe.DescribeParams(
        family=fam, upright=f.upright,
        patch_size=f.orb_patch_size, wta_k=f.orb_wta_k)


def _capacity(cfg: StitchConfig, requested: int) -> int:
    """Keypoint capacity, capped by orb_n_features for the ORB family."""
    if cfg.features.method == "orb":
        return min(requested, cfg.features.orb_n_features)
    return requested


def _effective_max_distance(cfg: StitchConfig) -> float:
    """orbMaxDistance in descriptor-distance units."""
    d = float(cfg.features.orb_max_distance)
    return d * 2.0 if cfg.features.orb_wta_k > 2 else d


#: per-octave per-row candidate capacities of the fused-select pool
_ROW_CANDS = (4, 2, 2, 4)


def octaves(img: torch.Tensor, params: detect.DetectParams):
    """[(octave, image, border)] the pools detect on: the frame as float32,
    then 2x2 mean pools while the shorter side is at least 256, with the
    border scaled down (at least 1)."""
    xo = img.to(torch.float32)
    out = []
    for o in range(params.n_octaves):
        if o > 0:
            if min(xo.shape) < 256:
                break
            xo = detect._pool2(xo)
        out.append((o, xo, max(1, -(-params.border // (1 << o)))))
    return out


def octave_atlas(img: torch.Tensor, params: detect.DetectParams):
    """The frame's ``octaves``, stacked into the ``pyramid_atlas``, and K1's
    band of each: (octaves, atlas, [(row_off, h, w, border, r_cands)])."""
    octs = octaves(img, params)
    atlas, offs = describe.pyramid_atlas([xo for _, xo, _ in octs])
    bands = [(off, *xo.shape, bo, _ROW_CANDS[min(o, len(_ROW_CANDS) - 1)])
             for (o, xo, bo), off in zip(octs, offs)]
    return octs, atlas, bands


def select_candidates(img: torch.Tensor, params: detect.DetectParams,
                      use_kernels: bool = True):
    """One (H, W) frame -> its candidates and the describe kernel's input.

    The octave images are stacked into the atlas (each band zero-padded to
    the octave-0 width and wrapped in ATLAS_GUARD zero rows), and K1
    selects every octave's per-row top-R DoH candidates with their
    sub-pixel offsets from its bands in one call.  The describe kernel's
    atlas has 16 more zero rows on top.  Returns (rows, cols, scores) in
    full-frame coordinates, row-major per octave (score <= 0 marks an empty
    slot), the atlas, and each candidate's 18x18 window start (r0, c0) in
    it.
    """
    spacing = 2.0 ** (1.0 / max(params.n_octave_layers, 1))
    octs, core, bands = octave_atlas(img, params)
    offs = [b[0] for b in bands]
    sel = kdoh.doh_select_octaves(
        core, bands, threshold=params.threshold,
        n_scales=params.n_octave_layers, base_sigma=params.base_sigma,
        spacing=spacing, use_kernel=use_kernels)
    hc, w0 = core.shape
    atlas = F.pad(core, (0, 0, 16, 0))

    # ---- flatten candidates (row-major per octave)
    rows_l, cols_l, sc_l, r0_l, c0_l = [], [], [], [], []
    for (o, xo, _), (sc, col, drs, dcs), xoff in zip(octs, sel, offs):
        ho, r_c = sc.shape
        f = float(1 << o)
        r_int = torch.arange(ho, device=img.device,
                             dtype=torch.float32)[:, None]
        r_loc = r_int + drs
        c_loc = col.to(torch.float32) + dcs
        rows_l.append((r_loc * f + (f - 1) / 2).reshape(-1))
        cols_l.append((c_loc * f + (f - 1) / 2).reshape(-1))
        sc_l.append(sc.reshape(-1))
        # window starts, clamped against the unpadded atlas / octave-0 width
        r0 = torch.round(r_loc + xoff).to(torch.int32) - kdesc.MARGIN
        r0_l.append((r0.clamp(0, hc - kdesc.WIN) + 16).reshape(-1))
        c0 = torch.round(c_loc).to(torch.int32) - kdesc.MARGIN
        c0_l.append(c0.clamp(0, w0 - kdesc.WIN).reshape(-1))
    return (torch.cat(rows_l), torch.cat(cols_l), torch.cat(sc_l), atlas,
            torch.cat(r0_l), torch.cat(c0_l))


def detect_describe_image(img: torch.Tensor, params: detect.DetectParams,
                          sparams: describe.DescribeParams,
                          use_kernels: bool = True):
    """One (H, W) frame -> (rows, cols, scores, descs) fused pool:
    candidates by K1 (``select_candidates``), descriptors by K2 from the
    atlas."""
    rows, cols, scores, atlas, r0, c0 = select_candidates(img, params,
                                                          use_kernels)
    descs = kdesc.describe_atlas(
        atlas, r0, c0, extended=(sparams.family == "surf-extended"),
        use_kernel=use_kernels)
    return rows, cols, scores, descs


def launch_score_map(img: torch.Tensor, max_kp: int,
                     params: detect.DetectParams, use_kernels: bool = True):
    """Start K4 on one (H, W) frame for ``score_map_pool``: the frame's
    octave atlas and one ``doh_score_map_octaves`` call over its bands at
    the octave budgets.  Returns (atlas, bands, finish); ``finish()`` gives
    each band's (top scores, flat indices, raw)."""
    spacing = 2.0 ** (1.0 / max(params.n_octave_layers, 1))
    _, atlas, bands = octave_atlas(img, params)
    kks = [min(detect.octave_budget(max_kp, o, params.octave_topk_decay),
               h * w) for o, (_, h, w, _, _) in enumerate(bands)]
    finish = kdoh.launch_score_map_octaves(
        atlas, bands, kks, threshold=params.threshold,
        n_scales=params.n_octave_layers, base_sigma=params.base_sigma,
        spacing=spacing, use_kernel=use_kernels)
    return atlas, bands, finish


def score_map_pool(img: torch.Tensor, max_kp: int,
                   params: detect.DetectParams,
                   sparams: describe.DescribeParams,
                   use_kernels: bool = True, launched=None):
    """One (H, W) frame -> (rows, cols, scores, descs) score-map pool of
    ``max_kp`` slots (port of ``_detect_describe_image_pallas``).

    Per octave: the top ``octave_budget`` NMS scores of K4 (one call over
    the frame's octave bands; an exact top-k where the TPU used
    approx_max_k), sub-pixel refinement on the raw response.  Then the
    global top-``max_kp`` over all octaves' candidates and ONE describe
    over the same pyramid atlas, upright or oriented.  Slots with score
    <= 0 are empty.  ``launched``: this frame's ``launch_score_map``, when
    the caller started it ahead.
    """
    atlas, bands, finish = launched or launch_score_map(img, max_kp, params,
                                                        use_kernels)
    cand = []
    for o, ((flat_s, flat_i, raw), (_, _, wo, _, _)) in enumerate(
            zip(finish(), bands)):
        r = flat_i // wo
        c = flat_i % wo
        if params.subpixel:
            dr, dc = detect.refine_subpixel(raw, r, c)
        else:
            dr = dc = torch.zeros_like(flat_s)
        ro = r.to(torch.float32) + dr
        co = c.to(torch.float32) + dc
        f = float(1 << o)
        cand.append((ro * f + (f - 1) / 2, co * f + (f - 1) / 2, flat_s, ro,
                     co, torch.full_like(r, o)))
    rows, cols, scores, r_loc, c_loc, oct_ids = (
        torch.cat([t[i] for t in cand]) for i in range(6))
    if rows.shape[0] < max_kp:
        pad = lambda a: F.pad(a, (0, max_kp - a.shape[0]))
        rows, cols, scores, r_loc, c_loc, oct_ids = (
            pad(a) for a in (rows, cols, scores, r_loc, c_loc, oct_ids))
    top_s, top_i = detect.top_k_stable(scores, max_kp)
    descs = describe.describe_from_atlas(
        atlas, [b[0] for b in bands], r_loc[top_i], c_loc[top_i],
        oct_ids[top_i], sparams)
    return rows[top_i], cols[top_i], top_s, descs


def _vote(vote_method: str, rows_a, cols_a, rows_b, cols_b, train_idx, ok,
          draws=None):
    """Per-pair (drow, dcol, votes, any_valid) of matched keypoint sets by
    ``vote_method`` (the mode, homography RANSAC keyed by ``draws``, or
    translation RANSAC); offsets are integers."""
    if vote_method == "ransac":
        ti = train_idx.long()
        dr, dc, nv, av, _, _ = ransac.ransac_homography_batch(
            rows_a, cols_a, rows_b.gather(-1, ti), cols_b.gather(-1, ti), ok,
            draws=draws)
        return dr, dc, nv, av
    d_row, d_col, v = vote.displacement_from_matches(
        rows_a, cols_a, rows_b, cols_b, train_idx, ok)
    if vote_method == "ransac_translation":
        return vote.ransac_translation_batch(d_row, d_col, v)
    return vote.mode_vote_batch(d_row, d_col, v)


def _feature_attempt_pairs(a: torch.Tensor, b: torch.Tensor, direction: int,
                           ratio: float, max_kp: int,
                           dparams: detect.DetectParams,
                           sparams: describe.DescribeParams, metric: str,
                           search_ratio: float, max_distance: float,
                           vote_method: str = "mode",
                           enhance_mode: str = "none",
                           enhance_clip: float = 20.0, enhance_tiles: int = 5,
                           use_kernels: bool = True):
    """One (direction, scale) attempt for a batch of explicit (A, B) pairs
    (port of ``_feature_attempt_pairs_jit``): the facing strips, enhanced
    in place when asked (reference Stitcher.py:327-334), each detected and
    described by the XLA detector, matched (K5 on the card) and voted.

    a, b: (C, H, W) uint8 batches (pair k = a[k] vs b[k]).  Returns per-pair
    (drow_strip, dcol_strip, votes, any_valid), each (C,); RANSAC keys pair
    k by slot k of a C-pair call, as the JAX package's chunk does."""
    ra, rb = roi.extract_strips(a, b, direction, ratio)
    if enhance_mode != "none":
        ra = enhance.enhance_batch(ra, enhance_mode == "clahe",
                                   enhance_clip, enhance_tiles)
        rb = enhance.enhance_batch(rb, enhance_mode == "clahe",
                                   enhance_clip, enhance_tiles)
    fused = lambda ims: [detect.detect_describe_image(im, max_kp, dparams,
                                                      sparams) for im in ims]
    stack = lambda per: tuple(torch.stack([q[j] for q in per])
                              for j in range(4))
    rows_a, cols_a, sc_a, da = stack(fused(ra))
    rows_b, cols_b, sc_b, db = stack(fused(rb))
    train_idx, ok = match.match_batch(da, db, sc_a > 0, sc_b > 0,
                                      search_ratio, max_distance, metric,
                                      use_kernel=use_kernels)
    return _vote(vote_method, rows_a, cols_a, rows_b, cols_b, train_idx, ok)


def _strict_attempt(images: torch.Tensor, direction: int, ratio: float,
                    idx: np.ndarray, cfg: StitchConfig
                    ) -> Dict[str, np.ndarray]:
    """Per-ROI detection attempt for an explicit pair subset (strict parity
    mode: the detector sees exactly the strip, as the reference's does), in
    the JAX package's chunks of pairs: each padded to its power-of-two
    bucket, which RANSAC's keys depend on."""
    _, _, metric = _families(cfg)
    dparams = _detect_params(cfg)
    sparams = _describe_params(cfg)
    h, w = images.shape[1:3]
    max_kp = _capacity(cfg, cfg.features.max_keypoints)
    if direction in (1, 3):
        strip_px = roi.strip_length(h, ratio) * w
    else:
        strip_px = h * roi.strip_length(w, ratio)
    dist_chunk = max(1, (1 << 28) // (4 * max_kp * max_kp))
    conv_chunk = max(1, (12 << 30) // (strip_px * 4 * 100))
    chunk = cfg.pair_batch or min(dist_chunk, conv_chunk)
    emode = _enhance_mode(cfg)
    out = {"drow": [], "dcol": [], "votes": [], "nz": []}
    for s in range(0, len(idx), chunk):
        sub, keep = reg.pad_indices(idx[s:s + chunk])
        sub_t = torch.as_tensor(sub, dtype=torch.long, device=images.device)
        dr, dc, nv, av = (t.cpu().numpy()[:keep] for t in
                          _feature_attempt_pairs(
            images[sub_t], images[sub_t + 1], direction, ratio, max_kp,
            dparams, sparams, metric, cfg.features.search_ratio,
            _effective_max_distance(cfg), vote_method=cfg.offset_calculate,
            enhance_mode=emode, enhance_clip=cfg.enhance.clip_limit,
            enhance_tiles=cfg.enhance.tile_size,
            use_kernels=cfg.use_kernels))
        out["drow"].append(dr)
        out["dcol"].append(dc)
        out["votes"].append(nv)
        # "nz": votes with the empty-displacement floor zeroed out
        out["nz"].append(np.where(av, nv, 0))
    return {k: np.concatenate(v) for k, v in out.items()}


def _fused_select_ok(dparams: detect.DetectParams,
                     sparams: describe.DescribeParams) -> bool:
    return (dparams.family == "hessian" and not dparams.box_filter
            and sparams.upright
            and sparams.family in ("surf", "surf-extended"))


def pool_features(images: torch.Tensor, dparams: detect.DetectParams,
                  sparams: describe.DescribeParams, max_pool: int = 6144,
                  fused_select: bool = True, use_kernels: bool = True,
                  use_pallas: bool = True):
    """Detect+describe every frame of an (N, H, W) batch, one frame at a
    time -> (rows, cols, scores) (N, P) and descs (N, P, D).

    As the JAX package's per-frame dispatch (_pool_features_jit) picks on
    the TPU: with ``use_pallas``, upright SURF with ``fused_select`` takes
    the fused pool (K1 + K2, P = structural capacity) and the other
    Gaussian-DoH frames (oriented SURF, SIFT) the score-map pool (K4, P =
    ``max_pool``); the corner (ORB) and box-filter families, and every
    frame without ``use_pallas``, take the XLA detector
    (``detect.detect_describe_image``, P = ``max_pool``).
    """
    n = images.shape[0]
    if fused_select and _fused_select_ok(dparams, sparams) and use_pallas:
        per = [detect_describe_image(images[i], dparams, sparams, use_kernels)
               for i in range(n)]
    elif not (use_pallas and dparams.family == "hessian"
              and not dparams.box_filter):
        per = [detect.detect_describe_image(images[i], max_pool, dparams,
                                            sparams) for i in range(n)]
    else:
        # K4 of frame i + 1 is enqueued before frame i's survivor counts are
        # read back, so the card has work while the host waits for them
        launch = lambda i: launch_score_map(images[i], max_pool, dparams,
                                            use_kernels) if i < n else None
        per, ahead = [], launch(0)
        for i in range(n):
            cur, ahead = ahead, launch(i + 1)
            per.append(score_map_pool(images[i], max_pool, dparams, sparams,
                                      use_kernels, launched=cur))
    return tuple(torch.stack([p[j] for p in per]) for j in range(4))


def _precompute_pool(images: torch.Tensor, cfg: StitchConfig):
    """The pool ``cfg`` asks for: pool_keypoints slots where the score-map
    pool runs."""
    return pool_features(images, _detect_params(cfg), _describe_params(cfg),
                         max_pool=_capacity(cfg, cfg.features.pool_keypoints),
                         fused_select=cfg.features.fused_select,
                         use_kernels=cfg.use_kernels,
                         use_pallas=cfg.use_pallas)


def _strip_bounds(direction: int, order: str, ratio: float, h: int, w: int):
    """Full-image-coordinate bounds (r0, r1, c0, c1) of the search strip
    (getROIRegionForIncreMethod semantics, ImageUtility.py:77-100)."""
    if direction in (1, 3):
        L = roi.strip_length(h, ratio)
        first_low = direction == 3  # dir 3: A top strip
        if (order == "first") != first_low:
            return h - L, h, 0, w
        return 0, L, 0, w
    L = roi.strip_length(w, ratio)
    first_low = direction == 4      # dir 4: A left strip
    if (order == "first") != first_low:
        return 0, h, w - L, w
    return 0, h, 0, L


def _select_strip(pool, frames: torch.Tensor, bounds, k_sel: int):
    """Top-``k_sel`` in-strip keypoints by score (stable: lower pool index
    first on ties, as lax.top_k) of each frame in ``frames``."""
    rows, cols, scores, descs = pool
    r, c, s = rows[frames], cols[frames], scores[frames]
    r0, r1, c0, c1 = bounds
    m = (s > 0) & (r >= r0) & (r < r1) & (c >= c0) & (c < c1)
    sel = torch.where(m, s, torch.full_like(s, -1.0))
    top_s, top_i = torch.sort(sel, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k_sel], top_i[:, :k_sel]
    d = descs[frames[:, None], top_i]                 # (P, k_sel, D)
    return r.gather(1, top_i), c.gather(1, top_i), top_s > 0, d


def _pool_attempt_multi(pool, idx: torch.Tensor, bounds_list, k_sel: int,
                        metric: str, search_ratio: float,
                        max_distance: float, use_kernels: bool,
                        vote_method: str = "mode") -> torch.Tensor:
    """Several (direction, scale) attempts for pair subset ``idx`` in one
    pass: one matcher call over configs x pairs, then the vote.  Returns a
    PACKED (n_configs, 6, P) float32 tensor — rows drow, dcol, votes,
    sub_r, sub_c, any_valid — so that the replay reads the host once per
    dispatch.  Offsets are FULL-image offsets (margin correction
    pre-cancelled).

    ``vote_method``: the mode vote with its sub-pixel refinement; "ransac",
    homography RANSAC fit in STRIP-LOCAL coordinates as the reference fits
    it, the strip margins re-added after, each pair keyed by its slot in
    the JAX package's call over the P pairs of one config; or
    "ransac_translation", whose integer offsets are also its sub-pixel
    ones."""
    sides = [(_select_strip(pool, idx, ba, k_sel),
              _select_strip(pool, idx + 1, bb, k_sel))
             for ba, bb in bounds_list]
    cat = lambda side, j: torch.cat([s[side][j] for s in sides])
    ra, ca, va, da = (cat(0, j) for j in range(4))
    rb, cb, vb, db = (cat(1, j) for j in range(4))
    _, ok, rb_sel, cb_sel = match.match_batch_coords(
        da, db, va, vb, rb, cb, search_ratio, max_distance, metric,
        use_kernel=use_kernels)
    if vote_method == "ransac":
        p = idx.shape[0]
        # each config's strip origins (A row, A col, B row, B col),
        # repeated over its P pairs
        org = torch.tensor([[ba[0], ba[2], bb[0], bb[2]]
                            for ba, bb in bounds_list], dtype=torch.float32,
                           device=ra.device).repeat_interleave(p, dim=0)
        dr, dc, nv, av, sr, sc = ransac.ransac_homography_batch(
            ra - org[:, 0:1], ca - org[:, 1:2], rb_sel - org[:, 2:3],
            cb_sel - org[:, 3:4], ok,
            draws=[(p, j) for _ in bounds_list for j in range(p)])
        mr, mc = org[:, 0] - org[:, 2], org[:, 1] - org[:, 3]
        dr, dc, sr, sc = dr + mr, dc + mc, sr + mr, sc + mc
    else:
        d_row, d_col, v = vote.displacement_from_coords(ra, ca, rb_sel,
                                                        cb_sel, ok)
        if vote_method == "ransac_translation":
            dr, dc, nv, av = vote.ransac_translation_batch(d_row, d_col, v)
            sr, sc = dr.to(torch.float32), dc.to(torch.float32)
        else:
            dr, dc, nv, av = vote.mode_vote_batch(d_row, d_col, v)
            sr, sc = vote.subpixel_refine_batch(d_row, d_col, ra - rb_sel,
                                                ca - cb_sel, v, dr, dc)
    packed = torch.stack([dr.to(torch.float32), dc.to(torch.float32),
                          nv.to(torch.float32), sr, sc,
                          av.to(torch.float32)])            # (6, C*P)
    return packed.reshape(6, len(bounds_list), -1).permute(1, 0, 2)


class _PooledCache:
    """Attempt-result store over the keypoint pool.

    Dispatch policy (as in the JAX package): a big sweep (more than
    ``_SMALL`` unresolved pairs) computes ALL FOUR directions of the
    requested scale at once; a small miss speculates every remaining
    (direction, scale) configuration.
    """

    _SMALL = 16   # <= this many pairs: speculate all remaining configs

    def __init__(self, pool, cfg: StitchConfig, h: int, w: int, metric: str):
        self._pool = pool
        self._cfg = cfg
        self._hw = (h, w)
        self._metric = metric
        self._store: Dict[Tuple[int, int], Dict[int, Dict[str, float]]] = {}
        self.dispatches = 0
        self.attempts_matched = 0   # (pair, direction, scale) matches issued

    def get(self, direction: int, scale: int, ratio: float, pair: int,
            prefetch) -> Dict[str, float]:
        store = self._store.setdefault((direction, scale), {})
        if pair not in store:
            todo = [pair] + [p for p in prefetch
                             if p != pair and p not in store]
            idx = np.asarray(sorted(todo), np.int32)
            idx_p, keep = reg.pad_indices(idx)
            h, w = self._hw
            cfg = self._cfg
            if len(idx) > self._SMALL:
                configs = [(direction, scale)] + [
                    (d, scale) for d in (1, 2, 3, 4)
                    if d != direction and (d, scale) not in self._store]
            else:
                configs = [(d, s) for s in range(scale,
                                                 max_roi_scale(ratio))
                           for d in (1, 2, 3, 4)]
            bounds = tuple(
                (_strip_bounds(d, "first", s * ratio, h, w),
                 _strip_bounds(d, "second", s * ratio, h, w))
                for d, s in configs)
            dev = self._pool[0].device
            results = _pool_attempt_multi(
                self._pool, torch.as_tensor(idx_p, dtype=torch.long,
                                            device=dev), bounds,
                _capacity(cfg, cfg.features.max_keypoints), self._metric,
                cfg.features.search_ratio, _effective_max_distance(cfg),
                cfg.use_kernels, cfg.offset_calculate).cpu().numpy()
            self.dispatches += 1
            self.attempts_matched += len(idx_p) * len(configs)
            for (d, s), pk in zip(configs, results):
                dstore = self._store.setdefault((d, s), {})
                nv = pk[2][:keep]
                sr = pk[3][:keep]
                sc = pk[4][:keep]
                av = pk[5][:keep]
                for j, p in enumerate(idx):
                    dstore[int(p)] = {"drow": float(sr[j]),
                                      "dcol": float(sc[j]),
                                      "votes": float(nv[j]),
                                      "nz": float(nv[j]) if av[j] > 0.5
                                            else 0.0}
        return store[pair]


def _pool_accept(cfg: StitchConfig):
    def accept(res: Dict[str, float]) -> bool:
        return bool(res["votes"] >= cfg.offset_evaluate)
    return accept


def _pool_extract(res: Dict[str, float]):
    # confidence = the floor-zeroed vote count ("nz"): 0 when the attempt had
    # no valid displacements at all; the accept decision uses "votes"
    return float(res["drow"]), float(res["dcol"]), float(res["nz"])


# Introspection (tests/bench): dispatch + match accounting of the most
# recent replay_from_pool call.
LAST_REPLAY_STATS: Dict[str, float] = {}


def replay_from_pool(pool, n: int, shape: Tuple[int, int], cfg: StitchConfig,
                     pairs=None) -> List[reg.PairRegistration]:
    """The reference's sequential decision replay over a precomputed
    keypoint pool (rows, cols, scores, descs)."""
    h, w = shape
    _, _, metric = _families(cfg)
    cache = _PooledCache(pool, cfg, h, w, metric)
    out = reg._replay_incremental(n - 1, cfg, cache, _pool_accept(cfg),
                                  _pool_extract, (h, w),
                                  offsets_are_full=True, pairs=pairs)
    LAST_REPLAY_STATS.clear()
    LAST_REPLAY_STATS.update(
        dispatches=cache.dispatches,
        attempts_matched=cache.attempts_matched,
        k_sel=_capacity(cfg, cfg.features.max_keypoints),
        desc_dim=int(pool[3].shape[-1]))
    return out


def _oriented_fallback_incre(images: torch.Tensor,
                             recs: List[reg.PairRegistration],
                             cfg: StitchConfig, shape: Tuple[int, int]
                             ) -> List[reg.PairRegistration]:
    """Re-register the pairs the upright pool could not, over an ORIENTED
    pool of only the frames those pairs touch.

    Pairs with no valid match displacement at all (confidence 0, the
    floor-zeroed vote count) are not retried: there is no signal for
    orientation to rescue.  The replay starts from the direction of the last
    registered pair before the first retried one."""
    failed = [k for k, r in enumerate(recs)
              if not r.ok and r.confidence > 0.0]
    if not failed:
        return recs
    frames = sorted({f for k in failed for f in (k, k + 1)})
    # for a failed pair k both k and k+1 are in ``frames`` with no integer
    # between them, so mini-index(k) + 1 == mini-index(k+1) always holds
    fmap = {f: i for i, f in enumerate(frames)}
    mini = _precompute_pool(
        images[torch.as_tensor(frames, dtype=torch.long,
                               device=images.device)], cfg)
    h, w = shape
    _, _, metric = _families(cfg)
    cache = _PooledCache(mini, cfg, h, w, metric)
    direction = cfg.direction
    for k in range(failed[0] - 1, -1, -1):
        if recs[k].ok and recs[k].direction:
            direction = recs[k].direction
            break
    sub = reg._replay_incremental(
        len(frames) - 1, cfg.replace(direction=direction), cache,
        _pool_accept(cfg), _pool_extract, (h, w), offsets_are_full=True,
        pairs=[fmap[k] for k in failed])
    out = list(recs)
    for k, r in zip(failed, sub):
        out[k] = r
    return out


def register_sequence_features_incre(images, cfg: StitchConfig,
                                     device="cuda"
                                     ) -> List[reg.PairRegistration]:
    """Incremental ROI feature search over an (N, H, W) grayscale batch: a
    tensor registers where it lies, numpy frames on ``device`` (the card
    unless the caller passes ``device="cpu"``).

    Default engine: the pooled fast path (detect once per frame).
    ``strict_roi_detect``, or any enhancement, takes the reference's
    per-ROI detection (``_strict_attempt``)."""
    check_supported(cfg)
    images = reg._as_images(images, device,
                            "register_sequence_features_incre")
    n, h, w = images.shape
    if n < 2:
        return []
    if cfg.features.strict_roi_detect or _enhance_mode(cfg) != "none":
        cache = reg.AttemptCache(
            lambda direction, ratio, idx: _strict_attempt(
                images, direction, ratio, idx, cfg))
        accept = lambda res: bool(res["votes"] >= cfg.offset_evaluate)
        # already integer strip offsets; confidence = floor-zeroed votes
        extract = lambda res: (float(res["drow"]), float(res["dcol"]),
                               float(res["nz"]))
        return reg._replay_incremental(n - 1, cfg, cache, accept, extract,
                                       (h, w), offsets_are_full=False)
    # upright-first (auto_upright): the upright pool registers translation
    # -only stages; the pairs it cannot register retry with orientation
    fast = cfg.features.auto_upright and not cfg.features.upright
    cfg_pool = cfg.replace(features=dataclasses.replace(
        cfg.features, upright=True)) if fast else cfg
    recs = replay_from_pool(_precompute_pool(images, cfg_pool), n, (h, w),
                            cfg_pool)
    if fast and any(not r.ok for r in recs):
        recs = _oriented_fallback_incre(images, recs, cfg, (h, w))
    return recs


def _match_vote_adjacent(pool, ia: np.ndarray, cfg: StitchConfig,
                         metric: str) -> List[reg.PairRegistration]:
    """Match + vote frame pairs (ia[k], ia[k] + 1) of a pooled feature set
    (``ia``: pool indices of each pair's A frame).  RANSAC keys each pair
    by its slot in the JAX package's chunk of ``(1 << 28) // (4 K^2)``
    pairs, whatever the chunk here."""
    rows, cols, scores, descs = pool
    valid = scores > 0
    out: List[reg.PairRegistration] = []
    max_kp = descs.shape[1]
    jax_chunk = max(1, (1 << 28) // (4 * max_kp * max_kp))
    draws = [(min(jax_chunk, len(ia) - s0), i - s0)
             for i in range(len(ia)) for s0 in [i - i % jax_chunk]]
    # pairs per matcher call: the plain version and the Hamming product
    # hold a Ka x Kb distance matrix a pair, the L2 kernel only its
    # gathered inputs (2 x Ka x D floats a pair), so on the kernel route
    # every pair of a sequence goes in one call; each bound is 1 GiB
    if descs.is_cuda and cfg.use_kernels and metric == "l2":
        pchunk = max(1, (1 << 30) // (8 * max_kp * descs.shape[2]))
    else:
        pchunk = jax_chunk
    for s in range(0, len(ia), pchunk):
        sub = torch.as_tensor(ia[s:s + pchunk], dtype=torch.long,
                              device=descs.device)
        ti, ok = match.match_batch(
            descs[sub], descs[sub + 1], valid[sub], valid[sub + 1],
            cfg.features.search_ratio, _effective_max_distance(cfg), metric,
            use_kernel=cfg.use_kernels)
        dr, dc, nv, av = (t.cpu().numpy() for t in _vote(
            cfg.offset_calculate, rows[sub], cols[sub], rows[sub + 1],
            cols[sub + 1], ti, ok, draws[s:s + len(sub)]))
        for k in range(len(sub)):
            okk = bool(nv[k] >= cfg.offset_evaluate)
            out.append(reg.PairRegistration(
                ok=okk,
                offset=(int(dr[k]), int(dc[k])) if okk else (0, 0),
                offset_subpix=((float(dr[k]), float(dc[k])) if okk
                               else (0.0, 0.0)),
                direction=cfg.direction if okk else 0,
                scale=0,
                # confidence: floor-zeroed votes (0 = no valid matches)
                confidence=float(nv[k]) if av[k] else 0.0, attempts=1))
    return out


def register_sequence_features(images, cfg: StitchConfig, device="cuda"
                               ) -> List[reg.PairRegistration]:
    """Whole-image feature search for every adjacent pair of an (N, H, W)
    grayscale batch (non-incremental): a tensor registers where it lies,
    numpy frames on ``device`` (the card unless ``device="cpu"``).

    Each frame is detected and described once (max_keypoints slots where
    the score-map or the XLA pool runs); adjacent pairs are then matched
    and voted by ``offset_calculate``.  With enhancement the frames are
    enhanced first and take the XLA pool, as in the JAX package.  With
    ``auto_upright`` the pool is upright first, and pairs that fail with
    some valid match retry over an oriented pool of their frames."""
    check_supported(cfg)
    images = reg._as_images(images, device, "register_sequence_features")
    n = images.shape[0]
    if n < 2:
        return []
    _, _, metric = _families(cfg)
    dparams = _detect_params(cfg)
    sparams = _describe_params(cfg)
    max_kp = _capacity(cfg, cfg.features.max_keypoints)
    emode = _enhance_mode(cfg)
    if emode != "none":
        # the reference enhances whole images on this path
        # (Stitcher.py:269-276); the enhanced frames take the XLA pool
        images = enhance.enhance_batch(images, emode == "clahe",
                                       cfg.enhance.clip_limit,
                                       cfg.enhance.tile_size)
    fast = cfg.features.auto_upright and not cfg.features.upright
    sparams_fast = dataclasses.replace(sparams, upright=True) if fast \
        else sparams
    pool_of = lambda ims, sp: pool_features(
        ims, dparams, sp, max_pool=max_kp,
        fused_select=cfg.features.fused_select, use_kernels=cfg.use_kernels,
        use_pallas=cfg.use_pallas and emode == "none")
    out = _match_vote_adjacent(pool_of(images, sparams_fast), np.arange(n - 1),
                               cfg, metric)
    failed = [k for k, r in enumerate(out)
              if not r.ok and r.confidence > 0.0]
    if fast and failed:
        frames = sorted({f for k in failed for f in (k, k + 1)})
        fmap = {f: i for i, f in enumerate(frames)}
        mini = pool_of(images[torch.as_tensor(frames, dtype=torch.long,
                                              device=images.device)], sparams)
        sub = _match_vote_adjacent(mini,
                                   np.asarray([fmap[k] for k in failed]),
                                   cfg, metric)
        for k, r in zip(failed, sub):
            out[k] = r
    return out
