"""The comparison that decides ``correct``.

Each number compared is the worst over what it covers, against a limit
of its own (``checks/<workload>.json``; PERF.md gives the readings each
limit was set from):

- ``offset_err_px``: over every pair of every project in the window, the
  largest Chebyshev distance in px between the offset registered and the
  true offset; a pair registered where the frames do not overlap, or left
  unregistered where they do, reads ``H + W``.
- ``pano_diff_max``: over every segment of the sampled projects, the
  largest difference in levels between the panorama returned and the
  reference's compose of the same frames at the returned offsets, by the
  configuration's fuse method (``fusers/<fuse_method>.py``), on its color
  frames or, in a gray configuration, on their reference gray; a segment
  layout or a panorama shape that differs reads 255.
- ``ingest_diff_max`` (file traffic): the largest difference between the
  gray frames (and, in a color configuration, the color frames) the
  registration received and the reference's decode of the same files.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import reference

#: what an output that cannot be compared reads
WORST_LEVEL = 255


def pairs_from_segments(segments, n: int):
    """[(ok, offset)] per pair from [((start, end), offsets)] segments, or
    None when the segments do not tile the sequence in order."""
    out, expect = [], 0
    for (start, end), offs in segments:
        if start != expect or end <= start or len(offs) != end - start - 1:
            return None
        if start > 0:
            out.append((False, None))
        out.extend((True, tuple(int(v) for v in o)) for o in offs)
        expect = end
    return out if expect == n else None


def segments_of(results) -> List[Tuple[Tuple[int, int], list]]:
    """The program's StitchResults as [((start, end), offsets)]."""
    return [(tuple(r.file_range), [tuple(o) for o in r.offsets])
            for r in results]


def offset_error(segments, truth: np.ndarray, frame_hw) -> float:
    """Worst Chebyshev error in px of one project's pairs (see module)."""
    h, w = frame_hw
    pairs = pairs_from_segments(segments, len(truth) + 1)
    if pairs is None:
        return float(h + w)
    overlap = reference.pair_overlaps(truth, frame_hw)
    worst = 0.0
    for (ok, off), ov, t in zip(pairs, overlap, truth):
        if ok != bool(ov):
            return float(h + w)
        if ok:
            worst = max(worst, abs(off[0] - t[0]), abs(off[1] - t[1]))
    return float(worst)


def pano_difference(segments, images: Sequence[np.ndarray],
                    frames: np.ndarray, device="cpu",
                    fuse=reference.fade) -> int:
    """Worst level difference of a project's panoramas against the
    reference's compose (on ``device``, each overlap fused by ``fuse``) of
    the same segments of ``frames``."""
    worst = 0
    for ((start, end), offs), img in zip(segments, images):
        ref = reference.compose(frames[start:end], offs, device=device,
                                fuse=fuse)
        img = np.asarray(img)
        if img.shape != ref.shape or img.dtype != np.uint8:
            return WORST_LEVEL
        worst = max(worst, max_abs_diff(img, ref, device))
        del ref
    return int(worst)


def _flat(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.reshape(-1)
    return torch.from_numpy(np.ascontiguousarray(x)).reshape(-1)


def max_abs_diff(a, b, device="cpu") -> int:
    """Largest |a - b| of two uint8 arrays or tensors of one shape, on
    ``device``, in blocks."""
    ta, tb = _flat(a), _flat(b)
    worst, step = 0, 1 << 28
    for s in range(0, ta.numel(), step):
        d = (ta[s:s + step].to(device).to(torch.int16)
             - tb[s:s + step].to(device).to(torch.int16))
        worst = max(worst, int(d.abs().max()))
    return worst


def decode_all(files: Sequence[str]) -> np.ndarray:
    """The reference's decode of every file, (N, H, W, 3) BGR uint8."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        return np.stack(list(pool.map(reference.decode, files)))


def configured_frames(decoded: np.ndarray, color: bool, device="cpu",
                      dtype: str = "float32") -> np.ndarray:
    """The (N, H, W, 3) BGR ``decoded`` frames as a configuration composes
    them: themselves in color, else their reference gray, uint8, worked
    out on ``device`` in blocks of frames."""
    if color:
        return decoded
    out = np.empty(decoded.shape[:3], np.uint8)
    for s in range(0, len(decoded), 16):
        bgr = torch.from_numpy(decoded[s:s + 16]).to(device)
        out[s:s + 16] = reference.gray(bgr, dtype).cpu().numpy()
    return out


def ingest_difference(decoded: np.ndarray, color_seen, gray_seen,
                      device="cpu", dtype: str = "float32",
                      color: bool = True) -> int:
    """Worst level difference between the frames registration received
    (arrays or tensors) and the reference's ``decoded`` frames: their gray
    always, and in a ``color`` configuration the color frames too, which
    the program must then hold; on ``device`` in blocks of frames."""
    if tuple(gray_seen.shape) != decoded.shape[:3] or color and (
            color_seen is None or tuple(color_seen.shape) != decoded.shape):
        return WORST_LEVEL
    worst, step = 0, 16
    for s in range(0, len(decoded), step):
        bgr = torch.from_numpy(decoded[s:s + step]).to(device)
        g = reference.gray(bgr, dtype)
        worst = max(worst, max_abs_diff(gray_seen[s:s + step], g, device))
        if color:
            worst = max(worst, max_abs_diff(color_seen[s:s + step], bgr,
                                            device))
    return int(worst)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}}); a number
    without a limit, or a limit without a number, is not correct."""
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in limits}
    ok = set(numbers) == set(limits) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks

