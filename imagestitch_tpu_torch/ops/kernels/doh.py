"""The two DoH kernels: K1 ``doh_select`` and K4 ``doh_score_map``.

Ports of ``imagestitch_tpu/ops/pallas/doh.py::doh_select`` (K1: response +
NMS + sub-pixel + per-row top-R, CUDA in ``csrc/doh_select.cu``) and
``::doh_score_map`` (K4: response + NMS written as a full score map plus
the raw response, CUDA in ``csrc/doh_score_map.cu``); both share the
response stage ``csrc/doh_common.cuh``.  ``doh_select_plain`` and
``doh_score_map_plain`` are the same functions in plain PyTorch.  Each
wrapper launches its kernel for a CUDA tensor (or the plain version when
``use_kernel`` is False) and takes the plain version for a CPU tensor.
K1's wrapper, ``doh_select_octaves``, takes all octaves of a frame as
bands of the pyramid atlas and covers them in one call (a tile kernel and
a merge kernel); ``doh_select`` is its one-octave case.

Semantics kept from the Pallas kernels:
  * the image is edge-padded; the response is evaluated on rows -1..H and
    columns -1..W, so the 3x3 NMS ring and the sub-pixel neighbours at the
    border read responses of the edge-padded image, not -inf;
  * the sub-pixel step reads the raw (pre-NMS) scale-max response;
  * K1: per row, the top ``r_cands`` NMS survivors by (score desc, column
    asc); slots with score <= 0 are empty and their other fields are
    arbitrary.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch

from ..features.detect import (_corr_cols, _corr_rows, _edge_pad,
                               _gauss_kernels, axis_offset)

#: calls of the K1 kernel (one per frame) since the counter was last set to 0
LAUNCHES = 0
#: launches of the K4 kernel since the counter was last set to 0
SCORE_MAP_LAUNCHES = 0
MAX_SCALES = 4      # csrc/doh_common.cuh kMaxScales
MAX_RADIUS = 10     # csrc/doh_common.cuh kMaxRadius
MAX_CANDS = 8       # csrc/doh_select.cu kMaxCands
MAX_OCTAVES = 8     # csrc/doh_select.cu kMaxOctaves
TILE_VCOLS = 256    # csrc/doh_common.cuh kVW


def _scale_taps(base_sigma: float, n_scales: int, spacing: float = 1.6):
    """Per-scale (g, dg, ddg, radius, sigma) numpy tap tables."""
    taps = []
    for s in range(n_scales):
        sigma = base_sigma * (spacing ** s)
        radius = max(2, int(math.ceil(3.0 * sigma)))
        g, dg, ddg = _gauss_kernels(sigma, radius)
        taps.append((g, dg, ddg, radius, sigma))
    return taps


def _response_ring(x: torch.Tensor, taps) -> torch.Tensor:
    """Scale-max DoH of the edge-padded image on rows -1..H, cols -1..W."""
    h, w = x.shape
    halo = max(r for _, _, _, r, _ in taps) + 1
    xp = _edge_pad(x, halo, halo)
    resp = None
    for g, dg, ddg, radius, sigma in taps:
        base = halo - 1 - radius     # padded index of output row/col -1
        xa = xp[base:base + h + 2 + 2 * radius, :]
        span = slice(base, base + w + 2 + 2 * radius)
        lxx = _corr_cols(_corr_rows(xa, g, h + 2)[:, span], ddg, w + 2)
        lyy = _corr_cols(_corr_rows(xa, ddg, h + 2)[:, span], g, w + 2)
        lxy = _corr_cols(_corr_rows(xa, dg, h + 2)[:, span], dg, w + 2)
        r = (sigma ** 4) * (lxx * lyy - lxy * lxy)
        resp = r if resp is None else torch.maximum(resp, r)
    return resp


def _nms_score(resp: torch.Tensor, border: int, threshold: float
               ) -> torch.Tensor:
    """(H+2, W+2) response ring -> (H, W) score: the centre response where
    it is >= its 8 neighbours, inside the border and above the threshold,
    else 0."""
    h, w = resp.shape[0] - 2, resp.shape[1] - 2
    center = resp[1:1 + h, 1:1 + w]
    m = None
    for di in range(3):
        for dj in range(3):
            if di == 1 and dj == 1:
                continue
            cand = resp[di:di + h, dj:dj + w]
            m = cand if m is None else torch.maximum(m, cand)
    gr = torch.arange(h, device=resp.device)[:, None]
    gc = torch.arange(w, device=resp.device)[None, :]
    inside = ((gr >= border) & (gr < h - border)
              & (gc >= border) & (gc < w - border))
    return torch.where((center >= m) & inside & (center > threshold),
                       center, torch.zeros_like(center))


def doh_select_plain(image: torch.Tensor, r_cands: int = 4,
                     threshold: float = 10.0, n_scales: int = 3,
                     base_sigma: float = 1.2, border: int = 8,
                     spacing: float = 1.6
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Plain PyTorch ``doh_select``: (H, W) -> four (H, r_cands) arrays."""
    x = image.to(torch.float32)
    h, w = x.shape
    resp = _response_ring(x, _scale_taps(base_sigma, n_scales, spacing))
    center = resp[1:1 + h, 1:1 + w]
    score = _nms_score(resp, border, threshold)
    gc = torch.arange(w, device=x.device)[None, :]

    drm = axis_offset(resp[0:h, 1:1 + w], resp[2:2 + h, 1:1 + w], center)
    dcm = axis_offset(resp[1:1 + h, 0:w], resp[1:1 + h, 2:2 + w], center)
    lane = gc.expand(h, w)
    big = torch.full_like(lane, 1 << 30)
    cur = score
    sc, col, drs, dcs = [], [], [], []
    for t in range(r_cands):
        mx = cur.max(dim=1).values
        a = torch.where(cur == mx[:, None], lane, big).min(dim=1).values
        sc.append(mx)
        col.append(a.to(torch.int32))
        drs.append(drm.gather(1, a[:, None])[:, 0])
        dcs.append(dcm.gather(1, a[:, None])[:, 0])
        if t + 1 < r_cands:
            cur = torch.where(lane == a[:, None], torch.zeros_like(cur), cur)
    return (torch.stack(sc, 1), torch.stack(col, 1), torch.stack(drs, 1),
            torch.stack(dcs, 1))


@functools.lru_cache(maxsize=None)
def _tap_tables(n_scales: int, base_sigma: float, spacing: float):
    """(radii, sigma^4, taps) numpy tables in the layout of
    ``doh::fill_params`` (csrc/doh_common.cuh), built once per
    (n_scales, base_sigma, spacing) and read-only."""
    if not 1 <= n_scales <= MAX_SCALES:
        raise ValueError(f"DoH kernel: n_scales={n_scales} not in "
                         f"[1, {MAX_SCALES}]")
    taps = _scale_taps(base_sigma, n_scales, spacing)
    radii = np.asarray([t[3] for t in taps], np.int32)
    if radii.max() > MAX_RADIUS:
        raise ValueError(f"DoH kernel: tap radius {radii.max()} > "
                         f"{MAX_RADIUS}")
    s4 = np.asarray([t[4] ** 4 for t in taps], np.float32)
    table = np.zeros((n_scales, 3, 2 * MAX_RADIUS + 1), np.float32)
    for s, (g, dg, ddg, radius, _) in enumerate(taps):
        for k, arr in enumerate((g, dg, ddg)):
            table[s, k, :2 * radius + 1] = arr
    for a in (radii, s4, table):
        a.setflags(write=False)
    return radii, s4, table


def tile_cols(halo: int) -> int:
    """Output columns of a DoH tile (csrc/doh_common.cuh ``tile_cols``)."""
    return TILE_VCOLS - 2 - 2 * halo


def _check_bands(atlas: torch.Tensor, bands):
    if atlas.dim() != 2:
        raise ValueError(f"doh_select expects a 2-D atlas, got "
                         f"{tuple(atlas.shape)}")
    if not 1 <= len(bands) <= MAX_OCTAVES:
        raise ValueError(f"doh_select: {len(bands)} octaves, not in "
                         f"[1, {MAX_OCTAVES}]")
    ha, wa = atlas.shape
    for row_off, h, w, _, r_cands in bands:
        if not (row_off >= 0 and h >= 1 and w >= 1 and row_off + h <= ha
                and w <= wa):
            raise ValueError(f"doh_select: band rows {row_off}..{row_off + h}"
                             f" x {w} columns outside the {ha}x{wa} atlas")
        if not 1 <= r_cands <= MAX_CANDS:
            raise ValueError(f"doh_select: r_cands={r_cands} not in "
                             f"[1, {MAX_CANDS}]")


def _launch(atlas: torch.Tensor, bands, threshold: float, n_scales: int,
            base_sigma: float, spacing: float):
    from ... import _build
    global LAUNCHES
    radii, s4, table = _tap_tables(n_scales, base_sigma, spacing)
    tc = tile_cols(int(radii.max()))
    table_b = np.asarray(bands, np.int32).reshape(-1, 5)
    slots = [h * rc for _, h, _, _, rc in bands]
    entries = sum(h * -(-w // tc) * rc for _, h, w, _, rc in bands)
    dev = atlas.device
    n = sum(slots)
    sc, dr, dc = (torch.empty(n, dtype=torch.float32, device=dev)
                  for _ in range(3))
    col = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(4 * entries, dtype=torch.float32, device=dev)
    err = _build.library().doh_select_launch(
        atlas.data_ptr(), atlas.shape[1], len(bands), table_b.ctypes.data,
        float(threshold), n_scales, radii.ctypes.data, s4.ctypes.data,
        table.ctypes.data, sc.data_ptr(), col.data_ptr(), dr.data_ptr(),
        dc.data_ptr(), scratch.data_ptr(), entries,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "doh_select")
    LAUNCHES += 1
    out, o0 = [], 0
    for (_, h, _, _, rc), k in zip(bands, slots):
        out.append(tuple(a[o0:o0 + k].view(h, rc) for a in (sc, col, dr, dc)))
        o0 += k
    return out


def doh_select_octaves(atlas: torch.Tensor, bands, threshold: float = 10.0,
                       n_scales: int = 3, base_sigma: float = 1.2,
                       spacing: float = 1.6, use_kernel: bool = True
                       ) -> List[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]]:
    """Per-row top-``r_cands`` DoH candidates of every octave of a frame.

    ``atlas``: (Ha, Wa) float32 holding the octave images as bands (the
    pyramid atlas); ``bands``: one (row_off, h, w, border, r_cands) per
    octave, its image being ``atlas[row_off:row_off + h, :w]``.  Returns per
    octave (scores, cols, drs, dcs), each (h, r_cands): float32, int32,
    float32, float32.  A CUDA atlas runs all octaves in one kernel call
    unless ``use_kernel`` is False; a CPU atlas runs the plain version per
    octave.
    """
    bands = [tuple(int(v) for v in b) for b in bands]
    _check_bands(atlas, bands)
    if atlas.is_cuda and use_kernel:
        if atlas.dtype != torch.float32:
            raise TypeError(f"doh_select kernel needs float32, got "
                            f"{atlas.dtype}")
        return _launch(atlas.contiguous(), bands, threshold, n_scales,
                       base_sigma, spacing)
    return [doh_select_plain(atlas[r:r + h, :w], rc, threshold, n_scales,
                             base_sigma, b, spacing)
            for r, h, w, b, rc in bands]


def doh_select(image: torch.Tensor, r_cands: int = 4, threshold: float = 10.0,
               n_scales: int = 3, base_sigma: float = 1.2, border: int = 8,
               spacing: float = 1.6, use_kernel: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """(H, W) image -> per-row top-``r_cands`` DoH candidates: the
    one-octave case of ``doh_select_octaves``.

    Returns (scores, cols, drs, dcs), each (H, r_cands): float32, int32,
    float32, float32.  A CUDA tensor runs the CUDA kernel unless
    ``use_kernel`` is False; a CPU tensor runs the plain version.
    """
    if image.dim() != 2:
        raise ValueError(f"doh_select expects (H, W), got {tuple(image.shape)}")
    h, w = image.shape
    return doh_select_octaves(image.to(torch.float32), [(0, h, w, border,
                                                         r_cands)],
                              threshold, n_scales, base_sigma, spacing,
                              use_kernel)[0]


def doh_score_map_plain(image: torch.Tensor, threshold: float = 10.0,
                        n_scales: int = 3, base_sigma: float = 1.2,
                        border: int = 8, spacing: float = 1.6
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``doh_score_map``: (H, W) -> (score, raw), each (H, W)
    float32."""
    x = image.to(torch.float32)
    h, w = x.shape
    resp = _response_ring(x, _scale_taps(base_sigma, n_scales, spacing))
    return _nms_score(resp, border, threshold), resp[1:1 + h, 1:1 + w]


def _launch_score_map(x: torch.Tensor, threshold: float, n_scales: int,
                      base_sigma: float, border: int, spacing: float):
    from ... import _build
    global SCORE_MAP_LAUNCHES
    radii, s4, table = _tap_tables(n_scales, base_sigma, spacing)
    h, w = x.shape
    score = torch.empty((h, w), dtype=torch.float32, device=x.device)
    raw = torch.empty((h, w), dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.doh_score_map_launch(
        x.data_ptr(), h, w, float(threshold), border, n_scales,
        radii.ctypes.data, s4.ctypes.data, table.ctypes.data,
        score.data_ptr(), raw.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "doh_score_map")
    SCORE_MAP_LAUNCHES += 1
    return score, raw


def doh_score_map(image: torch.Tensor, threshold: float = 10.0,
                  n_scales: int = 3, base_sigma: float = 1.2,
                  border: int = 8, spacing: float = 1.6,
                  use_kernel: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) image -> (score, raw): the NMS-masked DoH score map (0 where
    suppressed, on the border or under the threshold) and the raw scale-max
    response for sub-pixel refinement, each (H, W) float32.  A CUDA tensor
    runs the CUDA kernel unless ``use_kernel`` is False; a CPU tensor runs
    the plain version.
    """
    if image.dim() != 2:
        raise ValueError(f"doh_score_map expects (H, W), got "
                         f"{tuple(image.shape)}")
    if image.is_cuda and use_kernel:
        x = image.to(torch.float32).contiguous()
        return _launch_score_map(x, threshold, n_scales, base_sigma, border,
                                 spacing)
    return doh_score_map_plain(image, threshold, n_scales, base_sigma,
                               border, spacing)
