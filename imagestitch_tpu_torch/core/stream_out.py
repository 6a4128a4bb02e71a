"""Streamed panorama output: host float64 composition and rect-only readback.

Port of ``imagestitch_tpu/core/stream_out.py`` (:50-272, :283-399), without
``compose_host_positions`` (the solver, ROADMAP Queue 1 item 20).  Two
composers materialize the panorama on the host without a full-canvas
readback:

  * ``compose_host`` / ``compose_color_host`` replay the device composer's
    paste/fuse steps on a host int16 canvas and blend each fusion rect in
    float64, the reference's own arithmetic (ImageFusion.py:241-243), for
    the modes the JAX composer pads (``compose._PADDABLE_METHODS``).  With
    the shared C++ runtime (io/native_loader.py) a fade or trigonometric
    step is one ``isr_fuse_step`` call; the other modes, and every mode
    without the runtime, run in numpy (ops/fusion/host_blend.py).  No
    color byte crosses the host-device link.  The device composer's
    float32 blend agrees to one level on a small fraction of pixels.
  * ``compose_streamed`` composes on the device and reads back only the
    parts of the fusion rects that no later step overwrites; the host
    replays every paste from the frames it decoded, then patches those
    rects in.  Bit-equal to the device composer, in every mode (multiband
    and the optimal seam compose this way on gray frames).
"""
from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import StitchConfig
from ..io import native_loader
from ..ops.fusion import host_blend
from . import compose as compose_mod

_I16P = ctypes.POINTER(ctypes.c_int16)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F64P = ctypes.POINTER(ctypes.c_double)


def _subtract_one(piece, occ):
    """Rectangle subtraction: ``piece`` minus ``occ`` as <= 4 disjoint
    rects.  Rects are (r0, c0, r1, c1) half-open."""
    pr0, pc0, pr1, pc1 = piece
    or0, oc0, or1, oc1 = occ
    ir0, ic0 = max(pr0, or0), max(pc0, oc0)
    ir1, ic1 = min(pr1, or1), min(pc1, oc1)
    if ir0 >= ir1 or ic0 >= ic1:
        return [piece]
    out = []
    if pr0 < ir0:
        out.append((pr0, pc0, ir0, pc1))          # band above
    if ir1 < pr1:
        out.append((ir1, pc0, pr1, pc1))          # band below
    if pc0 < ic0:
        out.append((ir0, pc0, ir1, ic0))          # left of the hole
    if ic1 < pc1:
        out.append((ir0, ic1, ir1, pc1))          # right of the hole
    return out


#: per-step piece-count cap before streaming the full rect instead
_MAX_PIECES = 64


def visible_rect_pieces(steps, image_shape: Tuple[int, int]
                        ) -> Tuple[Tuple[int, int, int, int], ...]:
    """(r, c, h, w) pieces of every fusion rect that no later step (paste
    or fused-rect write) overwrites, in step order: a reverse sweep that
    clips each rect against every later paste extent and fusion rect."""
    h, w = image_shape
    occluders: List[Tuple[int, int, int, int]] = []
    per_step: List[List[Tuple[int, int, int, int]]] = []
    for s in reversed(steps):
        r, c = s[2]
        if s[0] == "fuse":
            (rr0, rc0), (rh, rw) = s[3], s[4]
            rect = (rr0, rc0, rr0 + rh, rc0 + rw)
            pieces = [rect]
            for occ in occluders:
                if occ[0] >= rect[2] or occ[2] <= rect[0] or \
                        occ[1] >= rect[3] or occ[3] <= rect[1]:
                    continue
                pieces = [q for p in pieces for q in _subtract_one(p, occ)]
                if len(pieces) > _MAX_PIECES:
                    pieces = [rect]
                    break
            per_step.append(pieces)
            occluders.append(rect)
        else:
            per_step.append([])
        occluders.append((r, c, r + h, c + w))
    return tuple((r0, c0, r1 - r0, c1 - c0)
                 for pieces in reversed(per_step)
                 for r0, c0, r1, c1 in pieces)


def _extract_rects_flat(canvas: torch.Tensor, rects) -> torch.Tensor:
    """The canvas content of every rect, concatenated into one flat tensor
    on the canvas's device (one readback instead of one per rect)."""
    if not rects:
        return canvas.new_zeros((0,))
    return torch.cat([canvas[rr:rr + rh, rc:rc + rw].reshape(-1)
                      for rr, rc, rh, rw in rects])


def _paste_host(canvas: np.ndarray, img: np.ndarray, r: int, c: int) -> None:
    """Host uint8 paste: row-wise memcpy in the runtime when it loads."""
    lib = native_loader.get_lib()
    h, w = img.shape[:2]
    if lib is not None and canvas.flags.c_contiguous and \
            img.flags.c_contiguous and canvas.dtype == img.dtype == np.uint8:
        ch = img.shape[2] if img.ndim == 3 else 1
        lib.isr_paste(canvas.ctypes.data_as(_U8P), canvas.shape[0],
                      canvas.shape[1], ch, img.ctypes.data_as(_U8P),
                      h, w, int(r), int(c))
    else:
        canvas[r:r + h, c:c + w] = img


def paste_all_host(frames: np.ndarray, placement, steps) -> np.ndarray:
    """Replay the paste sequence on a zeroed host uint8 canvas."""
    canvas = np.zeros(placement.canvas_shape + frames.shape[3:], np.uint8)
    for s in steps:
        i, (r, c) = s[1], s[2]
        _paste_host(canvas, frames[i], r, c)
    return canvas


def patch_rects_host(canvas: np.ndarray, rects, rect_stream: np.ndarray
                     ) -> np.ndarray:
    """Write streamed rect contents (``rects`` order) into the canvas."""
    tail = canvas.shape[2:]
    off = 0
    for rr, rc, rh, rw in rects:
        size = rh * rw * int(np.prod(tail, dtype=np.int64))
        canvas[rr:rr + rh, rc:rc + rw] = \
            rect_stream[off:off + size].reshape((rh, rw) + tail)
        off += size
    return canvas


def compose_streamed(frames_host: np.ndarray,
                     offsets: Sequence[Tuple[int, int]], cfg: StitchConfig,
                     frames_dev: Optional[torch.Tensor] = None,
                     device="cuda") -> np.ndarray:
    """Device-composed panorama, materialized on the host from a rect-only
    readback.

    ``frames_host``: (N, H, W[, 3]) uint8 decoded frames.  ``frames_dev``:
    the same batch already on the device, if the caller has it; else
    ``frames_host`` goes to ``device``, the card unless the caller passes
    ``device="cpu"`` (``compose.compose``'s rule).  Bit-equal to
    ``compose.compose``."""
    h, w = frames_host.shape[1], frames_host.shape[2]
    placement, steps, _ = compose_mod.plan_compose(offsets, (h, w), cfg)
    src = frames_dev if frames_dev is not None else frames_host
    pano_dev = compose_mod.compose(src, offsets, cfg, return_device=True,
                                   device=device)
    rects = visible_rect_pieces(steps, (h, w))
    flat = _extract_rects_flat(pano_dev, rects)
    # the host paste replay touches only host memory: it runs while the
    # rect stream is read back
    with ThreadPoolExecutor(max_workers=1) as ex:
        paste_fut = ex.submit(paste_all_host, frames_host, placement, steps)
        stream = flat.cpu().numpy()
        canvas = paste_fut.result()
    return patch_rects_host(canvas, rects, stream)


def compose_color_host(frames_color: np.ndarray,
                       offsets: Sequence[Tuple[int, int]],
                       cfg: StitchConfig) -> np.ndarray:
    """Color panorama composed on the host in float64 (``compose_host`` of
    an (N, H, W, 3) batch): no color byte crosses the link."""
    if frames_color.ndim != 4:
        raise ValueError(f"color batch expected, got {frames_color.shape}")
    return compose_host(frames_color, offsets, cfg)


def compose_host(frames: np.ndarray, offsets: Sequence[Tuple[int, int]],
                 cfg: StitchConfig) -> np.ndarray:
    """Host composition of an (N, H, W[, 3]) uint8 batch in the reference's
    float64, replaying the device composer's steps."""
    h, w = frames.shape[1], frames.shape[2]
    placement, steps, pairwise = compose_mod.plan_compose(offsets, (h, w),
                                                          cfg)
    return _run_steps_host(frames, placement.canvas_shape, steps, pairwise,
                           cfg)


def _run_steps_host(frames: np.ndarray, canvas_shape, steps, pairwise,
                    cfg: StitchConfig) -> np.ndarray:
    method = cfg.fuse_method
    if method not in compose_mod._PADDABLE_METHODS:
        raise ValueError(f"{method} is not supported by the host composer")
    if frames.dtype != np.uint8:
        raise ValueError(f"uint8 frames expected, got {frames.dtype}")
    color = frames.ndim == 4
    h, w = frames.shape[1], frames.shape[2]
    ch = 3 if color else 1
    rows, cols = canvas_shape
    shape = (rows, cols, 3) if color else (rows, cols)
    lib = native_loader.get_lib()
    if method not in ("fadeInAndFadeOut", "trigonometric"):
        lib = None          # the runtime blends the weighted modes only
    if lib is not None:
        canvas = np.empty(shape, np.int16)
        lib.isr_fill16(canvas.ctypes.data_as(_I16P), canvas.size, -1, 0)
    else:
        canvas = np.full(shape, -1, np.int16)
    for s in steps:
        kind, i, (r, c) = s[0], s[1], s[2]
        frame = np.ascontiguousarray(frames[i])
        if kind == "paste":
            if lib is not None:
                lib.isr_paste16(canvas.ctypes.data_as(_I16P), rows, cols, ch,
                                frame.ctypes.data_as(_U8P), h, w,
                                int(r), int(c), 0)
            else:
                canvas[r:r + h, c:c + w] = frame
            continue
        (rr0, rc0), (rh, rw) = s[3], s[4]
        pw = pairwise[i]
        if lib is not None:
            _native_fuse_step(lib, canvas, frame, (r, c), (rr0, rc0, rh, rw),
                              pw, method)
            continue
        roi_a = canvas[rr0:rr0 + rh, rc0:rc0 + rw].astype(np.int32)
        canvas[r:r + h, c:c + w] = frame
        roi_b = canvas[rr0:rr0 + rh, rc0:rc0 + rw].astype(np.int32)
        fused = host_blend.fuse_region_np(roi_a, roi_b, pw[0], pw[1],
                                          method, color)
        canvas[rr0:rr0 + rh, rc0:rc0 + rw] = fused
    if lib is not None:
        out = np.empty(shape, np.uint8)
        lib.isr_finalize16(canvas.ctypes.data_as(_I16P),
                           out.ctypes.data_as(_U8P), canvas.size, 0)
        return out
    return np.where(canvas == -1, 0, canvas).astype(np.uint8)


def _native_fuse_step(lib, canvas: np.ndarray, frame: np.ndarray,
                      pos, rect, pw, method: str) -> None:
    """One fade or trigonometric paste+fuse step in the runtime
    (``isr_fuse_step``): rect statistics in one C pass, the weight
    decisions in Python (host_blend.corner_vectors_from_stats), then
    blend, paste and write-back in place on the int16 canvas.  Weight
    modes: 0 plain fade, 1 corner fade, 2 plain sin^2, 3 corner sin^2."""
    r, c = pos
    rr0, rc0, rh, rw = rect
    h, w = frame.shape[:2]
    ch = canvas.shape[2] if canvas.ndim == 3 else 1
    quad = np.zeros(4, np.longlong)
    first_v = np.zeros(rw, np.int32)
    last_v = np.zeros(rw, np.int32)
    npos = np.zeros(1, np.longlong)
    lib.isr_rect_stats(
        canvas.ctypes.data_as(_I16P), canvas.shape[1], ch, rr0, rc0, rh, rw,
        quad.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        first_v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        last_v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        npos.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    fade = method == "fadeInAndFadeOut"
    zr, zc = np.zeros(rh, np.float64), np.zeros(rw, np.float64)
    if float(npos[0]) / (rh * rw * ch) > 0.65:
        if fade:
            war, wac, wbr, wbc = host_blend._plain_fade_vectors(
                (rh, rw), pw[0], pw[1])
            mode = 0
        else:
            war, wac = host_blend._trig_plain_vectors((rh, rw), pw[0], pw[1])
            wbr, wbc = zr, zc
            mode = 2
    else:
        def row_valid(ri):
            v = canvas[rr0 + ri, rc0:rc0 + rw]
            return (v.sum(axis=-1) != -3) if ch == 3 else (v != -1)
        wbr, wbc = host_blend.corner_vectors_from_stats(
            quad, first_v, last_v, row_valid, rh, rw)
        war, wac = zr, zc
        mode = 1 if fade else 3
    war, wac, wbr, wbc = (np.ascontiguousarray(v, np.float64)
                          for v in (war, wac, wbr, wbc))
    lib.isr_fuse_step(
        canvas.ctypes.data_as(_I16P), canvas.shape[0], canvas.shape[1], ch,
        frame.ctypes.data_as(_U8P), h, w, int(r), int(c),
        int(rr0), int(rc0), int(rh), int(rw),
        war.ctypes.data_as(_F64P), wac.ctypes.data_as(_F64P),
        wbr.ctypes.data_as(_F64P), wbc.ctypes.data_as(_F64P), int(mode), 0)
