"""The two DoH kernels: K1 ``doh_select`` and K4 ``doh_score_map``.

Ports of ``imagestitch_tpu/ops/pallas/doh.py::doh_select`` (K1: response +
NMS + sub-pixel + per-row top-R, CUDA in ``csrc/doh_select.cu``) and
``::doh_score_map`` (K4: response + NMS and the raw response, CUDA in
``csrc/doh_score_map.cu``); both share the response stage
``csrc/doh_common.cuh``.  ``doh_select_plain`` and ``doh_score_map_plain``
are the same functions in plain PyTorch.  Each wrapper launches its kernel
for a CUDA tensor (or the plain version when ``use_kernel`` is False) and
takes the plain version for a CPU tensor.  Both kernels take all octaves
of a frame as bands of the pyramid atlas and cover them in one call:
``doh_select_octaves`` (a tile kernel and a merge kernel; ``doh_select`` is
its one-octave case) and ``doh_score_map_octaves`` (the score-map pool's
per-octave top-k: the kernel compacts the bands' NMS survivors into one
list, and ``top_k_from_survivors`` orders them, in one sort, as a stable
sort of each full score map would).  ``doh_score_map``, the full score
map of one image, is the kernel's full-map mode.

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
from ..features.detect import top_k_stable as _top_k_stable

#: calls of the K1 kernel (one per frame) since the counter was last set to 0
LAUNCHES = 0
#: calls of the K4 kernel (one per frame, or one per ``doh_score_map``)
#: since the counter was last set to 0
SCORE_MAP_LAUNCHES = 0
MAX_SCALES = 4      # csrc/doh_common.cuh kMaxScales
MAX_RADIUS = 10     # csrc/doh_common.cuh kMaxRadius
MAX_CANDS = 8       # csrc/doh_select.cu kMaxCands
#: csrc/doh_select.cu kMaxOctaves, csrc/doh_score_map.cu kMaxBands
MAX_OCTAVES = 8
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


def _check_bands(atlas: torch.Tensor, bands, name: str):
    """Raise for an atlas or band table (row_off, h, w, ...) the kernels do
    not take."""
    if atlas.dim() != 2:
        raise ValueError(f"{name} expects a 2-D atlas, got "
                         f"{tuple(atlas.shape)}")
    if not 1 <= len(bands) <= MAX_OCTAVES:
        raise ValueError(f"{name}: {len(bands)} octaves, not in "
                         f"[1, {MAX_OCTAVES}]")
    ha, wa = atlas.shape
    for row_off, h, w, *_ in bands:
        if not (row_off >= 0 and h >= 1 and w >= 1 and row_off + h <= ha
                and w <= wa):
            raise ValueError(f"{name}: band rows {row_off}..{row_off + h}"
                             f" x {w} columns outside the {ha}x{wa} atlas")


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
    with torch.cuda.device(dev):               # the launch's current card
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
    _check_bands(atlas, bands, "doh_select")
    for *_, r_cands in bands:
        if not 1 <= r_cands <= MAX_CANDS:
            raise ValueError(f"doh_select: r_cands={r_cands} not in "
                             f"[1, {MAX_CANDS}]")
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


#: a survivor's key: band << 60 | (0x7FFFFFFF - bits(score)) << 29 | flat
#: index (csrc/doh_score_map.cu); ascending keys are (band, score desc,
#: index asc)
INDEX_BITS = 29
_INDEX_MASK = (1 << INDEX_BITS) - 1


def survivor_keys(scores: torch.Tensor, index: torch.Tensor,
                  band: int = 0) -> torch.Tensor:
    """The int64 keys K4 writes for band ``band``'s NMS survivors (scores
    > 0) at flat ``index``."""
    bits = scores.to(torch.float32).view(torch.int32).to(torch.int64)
    return ((band << 60) | ((0x7FFFFFFF - bits) << INDEX_BITS)
            | index.to(torch.int64))


def _zero_fill(scores: torch.Tensor, index: torch.Tensor, kk: int,
               size: int):
    """A band's ``n`` < ``kk`` survivors, ordered, followed by zeros at the
    lowest non-survivor indices, ascending, up to ``kk`` slots: the order of
    a stable sort's tied zeros.  They lie below ``kk + n``, as at most ``n``
    survivors do."""
    n = index.shape[0]
    span = min(kk + n, size)
    taken = torch.zeros(span + 1, dtype=torch.bool, device=index.device)
    taken[index.clamp(max=span)] = True
    idx = torch.arange(span, device=index.device)
    fill = torch.sort(torch.where(taken[:span], size, idx)).values
    return (torch.cat([scores, scores.new_zeros(kk - n)]),
            torch.cat([index, fill[:kk - n]]))


def top_k_from_survivors(keys: torch.Tensor, counts, sizes, kks):
    """Each band's ``kk`` largest scores, in ``_top_k_stable``'s order over
    its score map of ``size`` pixels, from the survivors' keys of every
    band in any order (``counts`` of them in each band) -> per band (scores
    float32 (kk,), flat indices int64 (kk,)).  One sort orders all bands."""
    top = torch.sort(keys).values
    score = (0x7FFFFFFF - ((top >> INDEX_BITS) & 0x7FFFFFFF)).to(
        torch.int32).view(torch.float32)
    index = top & _INDEX_MASK
    out, s0 = [], 0
    for n, size, kk in zip(counts, sizes, kks):
        s, i = score[s0:s0 + min(n, kk)], index[s0:s0 + min(n, kk)]
        out.append(_zero_fill(s, i, kk, size) if n < kk else (s, i))
        s0 += n
    return out


def _launch_score_map(atlas: torch.Tensor, bands, threshold: float,
                      n_scales: int, base_sigma: float, spacing: float,
                      full_map: bool):
    """One K4 launch over ``bands`` -> (raw, score, keys, counts): raw
    atlas-shaped; full-map mode: score atlas-shaped, no keys or counts;
    else keys (room for sum h * w int64) and counts (int32: each band's
    survivors, then the keys written) on the device."""
    from ... import _build
    global SCORE_MAP_LAUNCHES
    radii, s4, table = _tap_tables(n_scales, base_sigma, spacing)
    table_b = np.asarray([b[:4] for b in bands], np.int32)
    dev = atlas.device
    raw = torch.empty_like(atlas)
    score = keys = counts = None
    cap = sum(h * w for _, h, w, *_ in bands)
    if full_map:
        score = torch.empty_like(atlas)
    else:
        keys = torch.empty(cap, dtype=torch.int64, device=dev)
        counts = torch.empty(len(bands) + 1, dtype=torch.int32,
                             device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):               # the launch's current card
        err = _build.library().doh_score_map_launch(
            atlas.data_ptr(), atlas.shape[1], len(bands), table_b.ctypes.data,
            float(threshold), n_scales, radii.ctypes.data, s4.ctypes.data,
            table.ctypes.data, raw.data_ptr(), ptr(score), ptr(keys), cap,
            ptr(counts), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "doh_score_map")
    SCORE_MAP_LAUNCHES += 1
    return raw, score, keys, counts


def launch_score_map_octaves(atlas: torch.Tensor, bands, kk_per_band,
                             threshold: float = 10.0, n_scales: int = 3,
                             base_sigma: float = 1.2, spacing: float = 1.6,
                             use_kernel: bool = True):
    """Start ``doh_score_map_octaves``; returns a callable that finishes it.

    On the kernel route the launch enqueues the survivor counts' copy to
    pinned host memory, and the callable waits for that copy alone, so a
    caller that launches the next frame before finishing this one never
    leaves the card idle for the readback.  Other routes compute at once.
    """
    bands = [tuple(int(v) for v in b[:4]) for b in bands]
    kks = [int(k) for k in kk_per_band]
    _check_bands(atlas, bands, "doh_score_map")
    if len(kks) != len(bands) or not all(
            1 <= k <= h * w for k, (_, h, w, _) in zip(kks, bands)):
        raise ValueError(f"doh_score_map: kk_per_band {kks} not in "
                         f"[1, h * w] of the {len(bands)} bands")
    if max(h * w for _, h, w, _ in bands) > 1 << INDEX_BITS or sum(
            h * w for _, h, w, _ in bands) >= 1 << 31:
        raise ValueError(f"doh_score_map: bands of more than 2^{INDEX_BITS}"
                         f" pixels, or 2^31 in all")
    if threshold < 0:
        raise ValueError(f"doh_score_map: threshold {threshold} < 0 (an "
                         f"empty slot's score is 0)")
    if not (atlas.is_cuda and use_kernel):
        out = []
        for (r, h, w, b), kk in zip(bands, kks):
            score, raw = doh_score_map_plain(atlas[r:r + h, :w], threshold,
                                             n_scales, base_sigma, b, spacing)
            out.append((*_top_k_stable(score.reshape(-1), kk), raw))
        return lambda: out
    if atlas.dtype != torch.float32:
        raise TypeError(f"doh_score_map kernel needs float32, got "
                        f"{atlas.dtype}")
    raw, _, keys, counts = _launch_score_map(
        atlas.contiguous(), bands, threshold, n_scales, base_sigma, spacing,
        full_map=False)
    host = torch.empty(len(bands) + 1, dtype=torch.int32, pin_memory=True)
    with torch.cuda.device(atlas.device):
        host.copy_(counts, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(atlas.device))

    def finish():
        ready.synchronize()
        *ns, total = host.tolist()
        top = top_k_from_survivors(keys[:total], ns,
                                   [h * w for _, h, w, _ in bands], kks)
        return [(s, i, raw[r:r + h, :w])
                for (s, i), (r, h, w, _) in zip(top, bands)]
    return finish


def doh_score_map_octaves(atlas: torch.Tensor, bands, kk_per_band,
                          threshold: float = 10.0, n_scales: int = 3,
                          base_sigma: float = 1.2, spacing: float = 1.6,
                          use_kernel: bool = True
                          ) -> List[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]]:
    """The top ``kk`` NMS scores of every octave band of a frame.

    ``atlas``: (Ha, Wa) float32 holding the octave images as bands (the
    pyramid atlas); ``bands``: one (row_off, h, w, border, ...) per octave,
    its image being ``atlas[row_off:row_off + h, :w]``; ``kk_per_band``:
    slots per band, each in [1, h * w].  Returns per band (top scores
    float32 (kk,), their flat indices int64 (kk,), the raw scale-max
    response (h, w)), in the order of a stable descending sort of the
    band's score map (``_top_k_stable``).  A CUDA atlas runs all bands in
    one kernel call (the survivors compacted in the kernel, then ordered)
    unless ``use_kernel`` is False; a CPU atlas runs the plain version per
    band.
    """
    return launch_score_map_octaves(atlas, bands, kk_per_band, threshold,
                                    n_scales, base_sigma, spacing,
                                    use_kernel)()


def doh_score_map(image: torch.Tensor, threshold: float = 10.0,
                  n_scales: int = 3, base_sigma: float = 1.2,
                  border: int = 8, spacing: float = 1.6,
                  use_kernel: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) image -> (score, raw): the NMS-masked DoH score map (0 where
    suppressed, on the border or under the threshold) and the raw scale-max
    response for sub-pixel refinement, each (H, W) float32.  A CUDA tensor
    runs the kernel's full-map mode on its one band unless ``use_kernel``
    is False; a CPU tensor runs the plain version.
    """
    if image.dim() != 2:
        raise ValueError(f"doh_score_map expects (H, W), got "
                         f"{tuple(image.shape)}")
    if image.is_cuda and use_kernel:
        x = image.to(torch.float32).contiguous()
        raw, score, _, _ = _launch_score_map(
            x, [(0, *x.shape, border)], threshold, n_scales, base_sigma,
            spacing, full_map=True)
        return score, raw
    return doh_score_map_plain(image, threshold, n_scales, base_sigma,
                               border, spacing)
