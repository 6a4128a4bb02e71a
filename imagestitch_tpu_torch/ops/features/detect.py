"""Batched keypoint detection: the detectors of the XLA path.

Port of ``imagestitch_tpu/ops/features/detect.py``: the static parameters,
the Gaussian-derivative tap tables, the 2x2 octave pool, the layer-max
response (Gaussian DoH, or the SURF box filters over an integral image),
the FAST-9 segment test and the Harris score over the ORB pyramid, 3x3
NMS, sub-pixel refinement, the per-octave and per-level budgets, and the
detectors the JAX package runs without its Pallas kernels
(``detect_image_hessian``, ``detect_image_corner``, ``detect_batch``,
``detect_describe_image``): the pool of ``use_pallas=False``, of the
corner and box-filter families, the strict per-strip attempt and the
enhanced whole-image path.  ``hessian_response`` and ``_nms3`` are also
the tests' oracle for the DoH kernels (``ops/kernels/doh.py``).

Rounding follows XLA's CPU code: the Gaussian and Harris responses fuse
their products into the sums (``fused=True``); the integral image sums in
XLA's blocks of 16 (``_cumsum_xla``); the ORB levels come from jax's
linear resize weights (``ops/fusion/pyramid.resize_weights``) applied in
float64, within a few ulp of jax's, not bit for bit.

Every top-k is a stable descending sort, ties to the lower index first as
``lax.top_k`` breaks them on the CPU (``top_k_stable``).

Convolutions are sums of shifted slices, the same order of products and
additions as the JAX code — never ``conv2d``, which cuDNN runs in TF32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..fusion import pyramid as fusion_pyramid


@dataclasses.dataclass(frozen=True)
class DetectParams:
    """Static detector configuration — see config.FeatureConfig."""
    family: str = "hessian"        # "hessian" | "corner"
    threshold: float = 10.0        # hessian response floor
    n_octaves: int = 4             # ImageUtility.py:24
    n_octave_layers: int = 3       # ImageUtility.py:25
    base_sigma: float = 1.2
    box_filter: bool = False       # integral-image SURF box response
    border: int = 8                # descriptor-window margin (full-res px)
    subpixel: bool = True
    # corner/ORB pyramid (ImageUtility.py:31-38)
    n_levels: int = 8
    scale_factor: float = 1.2
    first_level: int = 0
    fast_threshold: float = 20.0
    edge_threshold: int = 31
    dtype: str = "float32"
    octave_topk_decay: int = 4     # per-octave candidate budget divisor


def _gauss_kernels(sigma: float, radius: int):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    dg = -x / sigma ** 2 * g                     # first derivative
    ddg = (x ** 2 / sigma ** 4 - 1.0 / sigma ** 2) * g  # second derivative
    return (g.astype(np.float32), dg.astype(np.float32), ddg.astype(np.float32))


def _edge_pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Edge-replicate (..., H, W) by ``rows``/``cols`` on both sides."""
    if rows:
        x = torch.cat([x[..., :1, :].expand(*x.shape[:-2], rows, x.shape[-1]),
                       x,
                       x[..., -1:, :].expand(*x.shape[:-2], rows,
                                             x.shape[-1])], dim=-2)
    if cols:
        x = torch.cat([x[..., :, :1].expand(*x.shape[:-1], cols),
                       x,
                       x[..., :, -1:].expand(*x.shape[:-1], cols)], dim=-1)
    return x


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (as a fused multiply-add): the exact
    product and its sum in float64, rounded to float32 (``b``: a float32
    tensor or a number that float32 holds exactly)."""
    if isinstance(b, torch.Tensor):
        b = b.to(torch.float64)
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)


def _correlate(xp: torch.Tensor, k: np.ndarray, window, fused: bool
               ) -> torch.Tensor:
    """sum_t window(xp, t) * k[t], in tap order.  Plain: every product and
    sum rounded (the Pallas kernels' order).  ``fused``: as XLA's CPU code
    compiles the JAX detector, the first product fused with the second,
    then each next product fused into the running sum (the source taken to
    float64 once, each fused step rounded once to float32)."""
    if not fused:
        out = window(xp, 0) * float(k[0])
        for t in range(1, len(k)):
            out = out + window(xp, t) * float(k[t])
        return out
    x64 = xp.to(torch.float64)
    f32 = torch.float32
    out = (window(x64, 0) * float(k[0])
           + (window(x64, 1) * float(k[1])).to(f32).to(torch.float64))
    for t in range(2, len(k)):
        out = window(x64, t) * float(k[t]) + out.to(f32).to(torch.float64)
    return out.to(f32)


def _corr_rows(xp: torch.Tensor, k: np.ndarray, rows_out: int,
               fused: bool = False) -> torch.Tensor:
    """Correlate along axis -2: out[i] = sum_t xp[i + t] * k[t]."""
    return _correlate(xp, k, lambda x, t: x[..., t:t + rows_out, :], fused)


def _corr_cols(xp: torch.Tensor, k: np.ndarray, cols_out: int,
               fused: bool = False) -> torch.Tensor:
    """Correlate along axis -1: out[:, j] = sum_t xp[:, j + t] * k[t]."""
    return _correlate(xp, k, lambda x, t: x[..., :, t:t + cols_out], fused)


def _sep_conv2(x: torch.Tensor, krow: np.ndarray, kcol: np.ndarray,
               fused: bool = False) -> torch.Tensor:
    """Separable 2-D correlation on (..., H, W), edge padding."""
    r = len(krow) // 2
    out = _corr_rows(_edge_pad(x, r, 0), krow, x.shape[-2], fused)
    c = len(kcol) // 2
    return _corr_cols(_edge_pad(out, 0, c), kcol, x.shape[-1], fused)


def hessian_response(images: torch.Tensor, sigma: float,
                     fused: bool = False) -> torch.Tensor:
    """Scale-normalized determinant-of-Hessian response at one scale.

    Plain: every product and sum rounded, the order of the DoH kernels'
    plain versions.  ``fused``: XLA's CPU rounding of the JAX detector
    (``_correlate``; Lxx * Lyy fused with the subtraction of Lxy^2)."""
    radius = max(2, int(math.ceil(3.0 * sigma)))
    g, dg, ddg = _gauss_kernels(sigma, radius)
    lxx = _sep_conv2(images, g, ddg, fused)
    lyy = _sep_conv2(images, ddg, g, fused)
    lxy = _sep_conv2(images, dg, dg, fused)
    if fused:
        return (sigma ** 4) * _fma(lxx, lyy, -(lxy * lxy))
    return (sigma ** 4) * (lxx * lyy - lxy * lxy)


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression mask on (..., H, W), -inf outside."""
    h, w = resp.shape[-2], resp.shape[-1]
    p = torch.nn.functional.pad(resp, (1, 1, 1, 1), value=float("-inf"))
    m = resp
    for di in range(3):
        for dj in range(3):
            if di == 1 and dj == 1:
                continue
            m = torch.maximum(m, p[..., di:di + h, dj:dj + w])
    return resp >= m  # ties keep both


def refine_subpixel(raw: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadratic sub-pixel offsets from the RAW response map at integer
    (rows, cols); 3x3 windows clamped inside the map (XLA gather CLIP).
    Returns (drow, dcol) in [-0.5, 0.5]."""
    h, w = raw.shape
    r0 = (rows.long() - 1).clamp(0, h - 3)
    c0 = (cols.long() - 1).clamp(0, w - 3)
    at = lambda dr, dc: raw[r0 + dr, c0 + dc]
    c = at(1, 1)
    return axis_offset(at(0, 1), at(2, 1), c), axis_offset(at(1, 0), at(1, 2), c)


def axis_offset(m: torch.Tensor, p: torch.Tensor, c: torch.Tensor
                ) -> torch.Tensor:
    """Parabola-vertex offset along one axis from the responses before
    (``m``), at (``c``) and after (``p``) a point, clipped to [-0.5, 0.5];
    0 where the curvature term is within 1e-12 of zero."""
    den = 2.0 * (m + p - 2.0 * c)
    off = torch.where(den.abs() > 1e-12, (m - p) / den, torch.zeros_like(den))
    return off.clamp(-0.5, 0.5)


def octave_budget(max_kp: int, octave: int, decay: int) -> int:
    """Candidate capacity for one octave under the density-matched decay."""
    if decay <= 1 or octave == 0:
        return max_kp
    return max(max_kp // decay ** octave, min(1024, max_kp))


def level_budget(max_kp: int, level: int, scale_factor: float,
                 decay: int) -> int:
    """ORB-pyramid analog of ``octave_budget``: the budget follows the
    level's area shrink."""
    if decay <= 1 or level == 0:
        return max_kp
    area_shrink = scale_factor ** (2 * level)
    return max(int(max_kp / area_shrink), min(1024, max_kp))


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool on (..., H, W) (H, W truncated to even)."""
    h2 = (x.shape[-2] // 2) * 2
    w2 = (x.shape[-1] // 2) * 2
    x = x[..., :h2, :w2]
    y = (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
         + x[..., 1::2, 0::2] + x[..., 1::2, 1::2])
    return y * 0.25


def top_k_stable(x: torch.Tensor, k: int):
    """The ``k`` largest of a 1-D tensor, ties by lower index first (the
    order of lax.top_k, and of approx_max_k on the CPU)."""
    s, i = torch.sort(x, descending=True, stable=True)
    return s[:k], i[:k]


def octave_response(images: torch.Tensor, params: DetectParams
                    ) -> torch.Tensor:
    """Layer-max blob response of ONE octave's (pooled) image: the SURF box
    filters of sizes 9 + 6l with ``box_filter``, else the Gaussian DoH with
    XLA's rounding (``hessian_response(fused=True)``)."""
    if params.box_filter:
        resp = box_hessian_response(images, 9)
        for l in range(1, params.n_octave_layers):
            resp = torch.maximum(resp, box_hessian_response(images, 9 + 6 * l))
        return resp
    spacing = 2.0 ** (1.0 / max(params.n_octave_layers, 1))
    resp = hessian_response(images, params.base_sigma, fused=True)
    for l in range(1, params.n_octave_layers):
        resp = torch.maximum(resp, hessian_response(
            images, params.base_sigma * spacing ** l, fused=True))
    return resp


# --------------------------------------------------------------------------
# SURF integral-image box-filter response
# --------------------------------------------------------------------------

#: block length of XLA's CPU rewrite of a long prefix sum
_SCAN_BLOCK = 16


def _scan_last(x: torch.Tensor) -> torch.Tensor:
    """float32 prefix sums along the last axis in XLA's CPU order: runs of
    ``_SCAN_BLOCK`` summed left to right, the runs' totals scanned the same
    way, then each run's exclusive prefix added to its sums."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = [x[..., 0]]
        for j in range(1, n):
            out.append(out[-1] + x[..., j])
        return torch.stack(out, dim=-1)
    nb = -(-n // _SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(
        *x.shape[:-1], nb, _SCAN_BLOCK)
    inner = _scan_last(blocks)
    before = F.pad(_scan_last(inner[..., -1])[..., :-1], (1, 0))
    return (inner + before[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def _cumsum_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum(x, axis=dim)`` of a float32 tensor as XLA's CPU code
    sums it (a reduce-window rewritten into blocks of 16).  A frame's
    integral image passes 2^24, so the order decides its low bits."""
    return _scan_last(x.movedim(dim, -1)).movedim(-1, dim)


def _integral_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-padded summed-area table: (..., H+2p+1, W+2p+1)."""
    ii = _cumsum_xla(_cumsum_xla(F.pad(x, (pad, pad, pad, pad)), -2), -1)
    return F.pad(ii, (1, 0, 1, 0))


def _box(ii: torch.Tensor, p: int, h: int, w: int,
         r0: int, r1: int, c0: int, c1: int) -> torch.Tensor:
    """Dense box sums over rows [r0, r1] x cols [c0, c1] INCLUSIVE, offsets
    relative to each pixel; returns (..., h, w)."""
    a, b = p + r0, p + r1 + 1
    c, d = p + c0, p + c1 + 1
    return (ii[..., b:b + h, d:d + w] - ii[..., a:a + h, d:d + w]
            - ii[..., b:b + h, c:c + w] + ii[..., a:a + h, c:c + w])


def box_hessian_response(images: torch.Tensor, size: int) -> torch.Tensor:
    """SURF box-filter determinant-of-Hessian at one filter size (Bay et
    al.; cv2.xfeatures2d.SURF's geometry): lobe L = size // 3; Dyy three
    (L x (2L-1)) lobes weighted (1, -2, 1); Dxy four LxL corner boxes; each
    area-normalized; det = Dxx*Dyy - (0.9*Dxy)^2, the first product fused
    into the difference and 0.9 folded into Dxy's normalization, as XLA
    compiles it."""
    L = size // 3
    half = size // 2
    p = size  # padding covers every box offset
    h, w = images.shape[-2], images.shape[-1]
    ii = _integral_pad(images.to(torch.float32), p)
    box = lambda *rc: _box(ii, p, h, w, *rc)
    cw = (-(L - 1), L - 1)
    dyy = (box(-half, -half + L - 1, *cw)
           - 2.0 * box(-half + L, -half + 2 * L - 1, *cw)
           + box(-half + 2 * L, half, *cw))
    dxx = (box(*cw, -half, -half + L - 1)
           - 2.0 * box(*cw, -half + L, -half + 2 * L - 1)
           + box(*cw, -half + 2 * L, half))
    dxy = (box(-L, -1, 1, L) + box(1, L, -L, -1)
           - box(-L, -1, -L, -1) - box(1, L, 1, L))
    inv = np.float32(1.0 / (size * size))
    # XLA folds 0.9 * inv into one float32 constant
    e = dxy * float(np.float32(0.9) * inv)
    return _fma(dxx * float(inv), dyy * float(inv), -(e * e))


# --------------------------------------------------------------------------
# FAST-9 + Harris corner response (ORB)
# --------------------------------------------------------------------------

#: 16-point Bresenham circle of radius 3 (FAST's test circle)
_FAST_CIRCLE = [(3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2),
                (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3),
                (1, -3), (2, -2), (3, -1)]


def _shift2(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Edge-replicated shift: out[p] = x[p + (dr, dc)], |dr|, |dc| <= 3."""
    h, w = x.shape[-2], x.shape[-1]
    m = 3
    return _edge_pad(x, m, m)[..., m + dr:m + dr + h, m + dc:m + dc + w]


def fast9_mask(images: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 segment test: 9 contiguous circle pixels all brighter (or all
    darker) than the center by more than ``threshold``; all-of-3 partial
    arcs, then the OR of every circular run of three of them."""
    x = images if images.is_floating_point() else images.to(torch.float32)
    diffs = [_shift2(x, dr, dc) - x for dr, dc in _FAST_CIRCLE]

    def arc9(flags):
        a3 = [flags[i] & flags[(i + 1) % 16] & flags[(i + 2) % 16]
              for i in range(16)]
        out = a3[0] & a3[3] & a3[6]
        for s in range(1, 16):
            out = out | (a3[s] & a3[(s + 3) % 16] & a3[(s + 6) % 16])
        return out

    return (arc9([d > threshold for d in diffs])
            | arc9([d < -threshold for d in diffs]))


def harris_response(images: torch.Tensor) -> torch.Tensor:
    """Harris corner score (ORB ranks FAST corners by it): Sobel-style
    gradients, 5x5 box sums of their products, det - 0.04 tr^2, each sum
    and difference rounded as XLA's CPU code fuses it."""
    sob = np.array([1.0, 0.0, -1.0], np.float32)
    avg = np.array([0.25, 0.5, 0.25], np.float32)
    box = np.ones(5, np.float32) / 5.0
    x = images if images.is_floating_point() else images.to(torch.float32)
    ix = _sep_conv2(x, avg, sob, fused=True)
    iy = _sep_conv2(x, sob, avg, fused=True)
    sxx = _sep_conv2(ix * ix, box, box, fused=True)
    syy = _sep_conv2(iy * iy, box, box, fused=True)
    sxy = _sep_conv2(ix * iy, box, box, fused=True)
    det = _fma(sxx, syy, -(sxy * sxy))
    tr = sxx + syy
    return _fma(-(0.04 * tr), tr, det)


def fast_corner_response(images: torch.Tensor) -> torch.Tensor:
    """Back-compat alias: plain Harris response (no FAST gate)."""
    return harris_response(images)


def select_candidates(raw: torch.Tensor, score: torch.Tensor, k: int,
                      border_rc: Tuple[int, int, int, int], subpixel: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k of an NMS-masked (H, W) score map -> sub-pixel (rows, cols,
    scores), zero-padded to ``k`` when the map is smaller.  ``raw``: the
    pre-NMS response; ``border_rc``: half-open valid bounds (r_lo, r_hi,
    c_lo, c_hi)."""
    h, w = score.shape
    r_lo, r_hi, c_lo, c_hi = border_rc
    ri = torch.arange(h, device=score.device)[:, None]
    ci = torch.arange(w, device=score.device)[None, :]
    inside = (ri >= r_lo) & (ri < r_hi) & (ci >= c_lo) & (ci < c_hi)
    score = torch.where(inside, score, torch.zeros_like(score))
    kk = min(k, h * w)
    top_s, top_i = top_k_stable(score.reshape(-1), kk)
    r = top_i // w
    c = top_i % w
    if subpixel:
        dr, dc = refine_subpixel(raw, r, c)
    else:
        dr = dc = torch.zeros_like(top_s)
    rows = r.to(torch.float32) + dr
    cols = c.to(torch.float32) + dc
    if kk < k:
        pad = lambda a: torch.nn.functional.pad(a, (0, k - kk))
        rows, cols, top_s = pad(rows), pad(cols), pad(top_s)
    return rows, cols, top_s


def _octave_candidates(xo: torch.Tensor, o: int, max_kp: int,
                       params: DetectParams):
    """One octave's NMS candidates at its budget, in octave coordinates:
    (rows, cols, scores)."""
    ho, wo = xo.shape
    raw = octave_response(xo, params).to(torch.float32)
    keep = _nms3(raw) & (raw > params.threshold)
    score = torch.where(keep, raw, torch.zeros_like(raw))
    bo = max(1, -(-params.border // (1 << o)))
    bud = octave_budget(max_kp, o, params.octave_topk_decay)
    return select_candidates(raw, score, bud, (bo, ho - bo, bo, wo - bo),
                             params.subpixel)


def _global_top(max_kp: int, *parts: torch.Tensor):
    """Zero-pad the concatenated candidates to ``max_kp`` and take the
    global top-``max_kp`` by score (``parts[2]``) -> (index, parts)."""
    if parts[0].shape[0] < max_kp:
        parts = tuple(torch.nn.functional.pad(a, (0, max_kp - a.shape[0]))
                      for a in parts)
    top_s, top_i = top_k_stable(parts[2], max_kp)
    return top_i, parts


def detect_image_hessian(img: torch.Tensor, max_kp: int, params: DetectParams
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-octave blob detection on ONE (H, W) image -> (rows, cols,
    scores) (max_kp,) in full-resolution coordinates."""
    xo = img.to(torch.float32)
    cand = []
    for o in range(params.n_octaves):
        if o > 0:
            if min(xo.shape) < 32:
                break
            xo = _pool2(xo)
        r, c, s = _octave_candidates(xo, o, max_kp, params)
        # pooled pixel centers sit at 2^o * c + (2^o - 1) / 2
        f = float(1 << o)
        cand.append((r * f + (f - 1) / 2, c * f + (f - 1) / 2, s))
    top_i, (rows, cols, scores) = _global_top(
        max_kp, *(torch.cat([t[i] for t in cand]) for i in range(3)))
    return rows[top_i], cols[top_i], scores[top_i]


def _corner_levels(img: torch.Tensor, params: DetectParams):
    """[(level, level image, scale)] of the ORB pyramid: ``n_levels``
    levels spaced by ``scale_factor`` from ``first_level``, each the frame
    resized as ``jax.image.resize(x, (hs, ws), "linear")``, until the
    shorter side is at most ``2 * edge_threshold + 8``."""
    x = img.to(torch.float32)
    h, w = x.shape
    out = []
    for lvl in range(params.first_level, params.n_levels):
        s = params.scale_factor ** lvl
        hs, ws = int(round(h / s)), int(round(w / s))
        if min(hs, ws) <= 2 * params.edge_threshold + 8:
            break
        xl = x if lvl == 0 else fusion_pyramid._resize_to(x, (hs, ws),
                                                          "linear")
        out.append((lvl, xl, s))
    return out


def _level_candidates(xl: torch.Tensor, lvl: int, max_kp: int,
                      params: DetectParams):
    """One ORB level's candidates at its budget, in level coordinates:
    Harris scores of NMS maxima that pass the FAST-9 gate, inside the
    ``edge_threshold`` border -> (rows, cols, scores)."""
    hs, ws = xl.shape
    gate = fast9_mask(xl, params.fast_threshold)
    raw = harris_response(xl).to(torch.float32)
    score = torch.where(_nms3(raw) & gate & (raw > 0), raw,
                        torch.zeros_like(raw))
    b = params.edge_threshold
    bud = level_budget(max_kp, lvl - params.first_level, params.scale_factor,
                       params.octave_topk_decay)
    return select_candidates(raw, score, bud, (b, hs - b, b, ws - b),
                             params.subpixel)


def _level_to_full(v: torch.Tensor, s: float) -> torch.Tensor:
    """Level coordinate -> full-resolution coordinate, (v + 0.5) * s - 0.5,
    the product and the difference rounded once as XLA fuses them."""
    return ((v + 0.5).to(torch.float64) * float(np.float32(s))
            - 0.5).to(torch.float32)


def detect_image_corner(img: torch.Tensor, max_kp: int, params: DetectParams
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ORB-style pyramid detection on ONE (H, W) image: FAST-9 gate,
    Harris ranking, ``n_levels`` levels spaced by ``scale_factor`` ->
    (rows, cols, scores) (max_kp,) in full-resolution coordinates."""
    cand = []
    for lvl, xl, s in _corner_levels(img, params):
        r, c, sc = _level_candidates(xl, lvl, max_kp, params)
        cand.append((_level_to_full(r, s), _level_to_full(c, s), sc))
    top_i, (rows, cols, scores) = _global_top(
        max_kp, *(torch.cat([t[i] for t in cand]) for i in range(3)))
    return rows[top_i], cols[top_i], scores[top_i]


def detect_image(img: torch.Tensor, max_kp: int, params: DetectParams):
    """The detector of ``params.family``: corner (ORB) or hessian."""
    if params.family == "corner":
        return detect_image_corner(img, max_kp, params)
    return detect_image_hessian(img, max_kp, params)


def detect_batch(images: torch.Tensor, max_kp: int, params: DetectParams
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_kp`` keypoints per image of a (P, H, W) batch -> (rows,
    cols, scores), each (P, max_kp) float32; padded slots score <= 0."""
    per = [detect_image(im, max_kp, params) for im in images]
    return tuple(torch.stack([p[j] for p in per]) for j in range(3))


def detect_describe_image(img: torch.Tensor, max_kp: int,
                          params: DetectParams, sparams):
    """Detect AND describe one (H, W) image, descriptors on the detection
    octave or level -> (rows, cols, scores, descs) in full-resolution
    coordinates, descs (max_kp, D).

    Corner family: each ORB level's candidates at its budget, described on
    that level's image, then the global top-``max_kp``.  Hessian family:
    each octave's candidates at its budget (the octave loop stops below 64
    px, where a descriptor window no longer fits), the global
    top-``max_kp``, then ONE describe over the pyramid atlas at the
    detection octaves."""
    from . import describe
    if params.family == "corner":
        cand = []
        for lvl, xl, s in _corner_levels(img, params):
            r, c, sc = _level_candidates(xl, lvl, max_kp, params)
            d = describe.describe_batch(xl[None], r[None], c[None],
                                        sparams)[0]
            cand.append((_level_to_full(r, s), _level_to_full(c, s), sc, d))
        top_i, (rows, cols, scores) = _global_top(
            max_kp, *(torch.cat([t[i] for t in cand]) for i in range(3)))
        descs = torch.cat([t[3] for t in cand])
        if descs.shape[0] < max_kp:
            descs = F.pad(descs, (0, 0, 0, max_kp - descs.shape[0]))
        return rows[top_i], cols[top_i], scores[top_i], descs[top_i]
    xo = img.to(torch.float32)
    cand, octave_imgs = [], []
    for o in range(params.n_octaves):
        if o > 0:
            if min(xo.shape) < 64:
                break
            xo = _pool2(xo)
        r, c, s = _octave_candidates(xo, o, max_kp, params)
        f = float(1 << o)
        cand.append((r * f + (f - 1) / 2, c * f + (f - 1) / 2, s, r, c,
                     torch.full(r.shape, o, dtype=torch.int32,
                                device=r.device)))
        octave_imgs.append(xo)
    top_i, (rows, cols, scores, r_loc, c_loc, oct_ids) = _global_top(
        max_kp, *(torch.cat([t[i] for t in cand]) for i in range(6)))
    descs = describe.describe_from_pyramid(
        octave_imgs, r_loc[top_i], c_loc[top_i], oct_ids[top_i], sparams)
    return rows[top_i], cols[top_i], scores[top_i], descs
