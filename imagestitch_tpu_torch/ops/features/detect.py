"""Batched keypoint detection: the blob detector of the XLA path.

Port of the Gaussian-DoH half of ``imagestitch_tpu/ops/features/detect.py``:
the static parameters, the Gaussian-derivative tap tables, the 2x2 octave
pool, the layer-max response, 3x3 NMS, sub-pixel refinement, the
per-octave budget, and the detectors the JAX package runs without its
Pallas kernels (``detect_image_hessian``, ``detect_batch``,
``detect_describe_image``): the pool of ``use_pallas=False``, the strict
per-strip attempt and the enhanced whole-image path.  ``hessian_response``
and ``_nms3`` are also the tests' oracle for the DoH kernels
(``ops/kernels/doh.py``).  The box-filter response and the corner/ORB
family are ROADMAP Queue 1 item 17 and raise.

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


def _require_gaussian_hessian(params: DetectParams) -> None:
    if params.family != "hessian" or params.box_filter:
        raise NotImplementedError(
            f"detector family={params.family!r}, box_filter="
            f"{params.box_filter}: only the Gaussian DoH detector is ported "
            f"(ROADMAP Queue 1 item 17)")


def octave_response(images: torch.Tensor, params: DetectParams
                    ) -> torch.Tensor:
    """Layer-max Gaussian DoH response of ONE octave's (pooled) image, with
    XLA's rounding (``hessian_response(fused=True)``)."""
    _require_gaussian_hessian(params)
    spacing = 2.0 ** (1.0 / max(params.n_octave_layers, 1))
    resp = hessian_response(images, params.base_sigma, fused=True)
    for l in range(1, params.n_octave_layers):
        resp = torch.maximum(resp, hessian_response(
            images, params.base_sigma * spacing ** l, fused=True))
    return resp


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
    _require_gaussian_hessian(params)
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


def detect_image(img: torch.Tensor, max_kp: int, params: DetectParams):
    """``detect_image_hessian``; the corner family is ROADMAP item 17."""
    return detect_image_hessian(img, max_kp, params)


def detect_batch(images: torch.Tensor, max_kp: int, params: DetectParams
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_kp`` keypoints per image of a (P, H, W) batch -> (rows,
    cols, scores), each (P, max_kp) float32; padded slots score <= 0."""
    per = [detect_image(im, max_kp, params) for im in images]
    return tuple(torch.stack([p[j] for p in per]) for j in range(3))


def detect_describe_image(img: torch.Tensor, max_kp: int,
                          params: DetectParams, sparams):
    """Detect AND describe one (H, W) image: each octave's candidates at its
    budget (the octave loop stops below 64 px, where a descriptor window no
    longer fits), the global top-``max_kp``, then ONE describe over the
    pyramid atlas at the detection octaves -> (rows, cols, scores, descs)
    in full-resolution coordinates, descs (max_kp, D)."""
    from . import describe
    _require_gaussian_hessian(params)
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
