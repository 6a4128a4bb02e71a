"""Canvas placement and composition.

Port of ``imagestitch_tpu/core/compose.py`` for every fusion mode, gray and
color (multiband and the optimal seam: gray only): placement is integer
bookkeeping on the host (exact reference semantics, Stitcher.py:387-431,
including the running-max occupancy quirk), and the canvas is ONE int16
device tensor at its final size, (rows, cols) or (rows, cols, 3), with the
reference's ``-1`` sentinel.  Each step pastes its frame in place and fuses
the exact overlap rect against the canvas before and after the paste
(Stitcher.py:440-486), in the reference's paste/fuse order; no shape
buckets are needed because PyTorch runs eagerly.  ``compose`` places the
frames by pairwise offsets, ``compose_from_positions`` by the global
solver's absolute positions; both run their steps through ``_run_steps``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import StitchConfig
from ..device import resolve_device, to_device
from ..ops.fusion import blend
from ..ops.fusion import pyramid as fusion_pyramid
from ..ops.fusion import seam as fusion_seam
from ..utils import profiling

#: the modes the JAX composer pads to shape buckets, and the host float64
#: composers run (JAX compose.py:373-374)
_PADDABLE_METHODS = ("notFuse", "average", "maximum", "minimum",
                     "fadeInAndFadeOut", "trigonometric")
#: the modes the reference runs on gray only (JAX compose.py:274-275)
_GRAY_ONLY_METHODS = ("multiBandBlending", "optimalSeamLine")


@dataclasses.dataclass
class Placement:
    """Result of the placement pass."""
    positions: List[Tuple[int, int]]      # top-left (row, col) per image
    canvas_shape: Tuple[int, int]         # (rows, cols)
    range_rows: List[Tuple[int, int]]     # occupancy [min,max) rows per image
    range_cols: List[Tuple[int, int]]     # occupancy [min,max) cols per image


def compute_placement(offsets: Sequence[Tuple[int, int]],
                      image_shape: Tuple[int, int]) -> Placement:
    """Pairwise offsets -> absolute placements + canvas size.

    Exact semantics of the reference's first composition pass
    (Stitcher.py:387-431): prefix sums with negative rebase, a canvas that
    only ever grows, and the occupancy ranges whose upper bound is the
    *running* canvas extent at placement time (rangeX[i][1]=resultRow at
    Stitcher.py:413/418).
    """
    h, w = image_shape
    n = len(offsets) + 1
    pos = [[0, 0] for _ in range(n)]
    range_r = [[0, 0] for _ in range(n)]
    range_c = [[0, 0] for _ in range(n)]
    range_r[0][1] = h
    range_c[0][1] = w
    rows, cols = h, w
    drow_sum = dcol_sum = 0
    for i in range(1, n):
        drow_sum += offsets[i - 1][0]
        dcol_sum += offsets[i - 1][1]
        if drow_sum <= 0:
            shift = -drow_sum
            for j in range(i):
                pos[j][0] += shift
                range_r[j][0] += shift
                range_r[j][1] += shift
            rows += shift
            range_r[i][1] = rows
            drow_sum = 0
            pos[i][0] = 0
        else:
            pos[i][0] = drow_sum
            rows = max(rows, drow_sum + h)
            range_r[i][1] = rows
        if dcol_sum <= 0:
            shift = -dcol_sum
            for j in range(i):
                pos[j][1] += shift
                range_c[j][0] += shift
                range_c[j][1] += shift
            cols += shift
            range_c[i][1] = cols
            dcol_sum = 0
            pos[i][1] = 0
        else:
            pos[i][1] = dcol_sum
            cols = max(cols, dcol_sum + w)
            range_c[i][1] = cols
        range_r[i][0] = pos[i][0]
        range_c[i][0] = pos[i][1]
    return Placement(positions=[tuple(p) for p in pos],
                     canvas_shape=(rows, cols),
                     range_rows=[tuple(r) for r in range_r],
                     range_cols=[tuple(c) for c in range_c])


def plan_compose(offsets: Sequence[Tuple[int, int]],
                 image_shape: Tuple[int, int], cfg: StitchConfig):
    """Placement + per-image step classification.

    Returns ``(placement, steps, pairwise)`` where each step is
    ``("paste", i, (r, c), None, None)`` or
    ``("fuse", i, (r, c), (rr0, rc0), (rh, rw))`` (reference pass-2
    classification, Stitcher.py:440-483: image i fuses only against the
    occupancy rect of image i-1).
    """
    h, w = image_shape
    n = len(offsets) + 1
    placement = compute_placement(offsets, (h, w))
    pairwise = [(0, 0)] + [tuple(o) for o in offsets]
    steps = []
    for i in range(n):
        r, c = placement.positions[i]
        if i == 0 or cfg.fuse_method == "notFuse":
            steps.append(("paste", i, (r, c), None, None))
            continue
        rr0 = max(r, placement.range_rows[i - 1][0])
        rc0 = max(c, placement.range_cols[i - 1][0])
        rr1 = min(r + h, placement.range_rows[i - 1][1])
        rc1 = min(c + w, placement.range_cols[i - 1][1])
        if rr1 - rr0 <= 0 or rc1 - rc0 <= 0:
            steps.append(("paste", i, (r, c), None, None))
        else:
            steps.append(("fuse", i, (r, c), (rr0, rc0),
                          (rr1 - rr0, rc1 - rc0)))
    return placement, steps, pairwise


def _fuse_dispatch(roi_a, roi_b, drow: int, dcol: int, method: str,
                   color: bool) -> torch.Tensor:
    """One fusion rect by ``method`` (JAX compose.py:152-157)."""
    if method == "multiBandBlending":
        return fusion_pyramid.fuse_multiband(roi_a, roi_b)
    if method == "optimalSeamLine":
        return fusion_seam.fuse_optimal_seam(roi_a, roi_b)
    return blend.fuse_region(roi_a, roi_b, drow, dcol, method, color)


def _run_steps(steps, images, canvas_shape, pairwise, cfg: StitchConfig,
               return_device: bool, device):
    """Run paste/fuse ``steps`` over an int16 canvas of ``canvas_shape``
    with the reference's ``-1`` sentinel: each step pastes its frame in
    place and fuses the exact overlap rect against the canvas before and
    after the paste, with the fusion ramp of ``pairwise[i]``.  A tensor
    composes where it lies, numpy frames on ``device``.  Multiband and the
    optimal seam raise ``ValueError`` on color frames, before any work."""
    if images.ndim == 4 and cfg.fuse_method in _GRAY_ONLY_METHODS:
        raise ValueError(f"fuse_method={cfg.fuse_method!r} composes gray "
                         f"frames only (the reference's), got color")
    if not isinstance(images, torch.Tensor):
        with profiling.span("compose.upload"):
            images = to_device(images, resolve_device(device, "compose"))
    color = images.dim() == 4
    h, w = images.shape[1:3]
    with profiling.span("compose.fuse"):
        canvas = torch.full(tuple(canvas_shape) + tuple(images.shape[3:]),
                            -1, dtype=torch.int16, device=images.device)
        for kind, i, (r, c), rect, size in steps:
            img = images[i].to(torch.int16)
            if kind == "paste":
                canvas[r:r + h, c:c + w] = img
                continue
            (rr, rc), (rh, rw) = rect, size
            view = canvas[rr:rr + rh, rc:rc + rw]
            roi_a = view.to(torch.int32)               # before the paste
            canvas[r:r + h, c:c + w] = img
            roi_b = view.to(torch.int32)               # after the paste
            drow, dcol = pairwise[i]
            view.copy_(_fuse_dispatch(roi_a, roi_b, drow, dcol,
                                      cfg.fuse_method, color))
        pano = canvas.clamp_(min=0).to(torch.uint8)   # -1 sentinel -> 0
    if return_device:
        return pano
    # the readback also waits for the fuse work queued above
    with profiling.span("compose.readback"):
        return _readback(pano)


#: addresses of the page-locked blocks panoramas were read back into: a
#: block at one of them is one the host allocator handed out again
_PINNED_BLOCKS: set = set()


def _readback(pano: torch.Tensor) -> np.ndarray:
    """``pano`` as a host array that the caller owns.  A card's panorama
    is copied by DMA into a page-locked block of torch's caching host
    allocator, at the link's rate, and the array's base holds the block:
    the block goes back to the allocator's cache, still locked, when the
    last array or view of it dies, and the next panorama of its size
    lands there without locking or faulting its pages again.  Where the
    allocator cannot lock the memory, and off the card, the copy goes
    into pageable memory (``pano.cpu().numpy()``).  Counts
    ``COMPOSE_READBACKS``, ``COMPOSE_READBACK_REUSED`` and
    ``COMPOSE_READBACK_PAGEABLE`` for a card's panorama."""
    if pano.device.type != "cuda":
        return pano.cpu().numpy()
    profiling.count("COMPOSE_READBACKS")
    try:
        host = torch.empty(pano.shape, dtype=pano.dtype, pin_memory=True)
    except RuntimeError:
        profiling.count("COMPOSE_READBACK_PAGEABLE")
        return pano.cpu().numpy()
    if host.data_ptr() in _PINNED_BLOCKS:
        profiling.count("COMPOSE_READBACK_REUSED")
    else:
        _PINNED_BLOCKS.add(host.data_ptr())
    host.copy_(pano, non_blocking=True)
    torch.cuda.current_stream(pano.device).synchronize()
    return host.numpy()


def compose(images, offsets: Sequence[Tuple[int, int]], cfg: StitchConfig,
            return_device: bool = False, device="cuda"):
    """Compose a registered sequence into one uint8 panorama.

    ``images``: (N, H, W) gray or (N, H, W, 3) BGR uint8.  A tensor composes
    where it lies; numpy frames go to ``device``, the card unless the
    caller passes ``device="cpu"`` (without CUDA the card raises).
    ``offsets``: N-1 pairwise (drow, dcol) ints.  Returns the host numpy
    panorama, or with ``return_device`` the uint8 tensor where it was
    composed.  A panorama composed on the card comes back in page-locked
    host memory (``_readback``), which the returned array owns: torch's
    host allocator rounds each block up to a power of two (a 1.13 GB
    panorama locks 2 GiB) and keeps it locked, cached for the next
    panorama of its size, once the array and its views are gone.  So as
    many blocks of a size stay locked, for the life of the process, as
    panoramas of that size were ever alive at once.  Parity
    with Stitcher.py:440-486: image i fuses only against the occupancy rect
    of image i-1, the fuse rect sees the canvas before and after pasting
    image i, and fusion uses the pairwise offset.  Multiband and the
    optimal seam raise ``ValueError`` on color frames, before any work.
    """
    n, h, w = images.shape[:3]
    if len(offsets) != n - 1:
        raise ValueError(f"{len(offsets)} offsets for {n} images")
    placement, steps, pairwise = plan_compose(offsets, (h, w), cfg)
    return _run_steps(steps, images, placement.canvas_shape, pairwise, cfg,
                      return_device, device)


def compose_from_positions(images, positions: np.ndarray, cfg: StitchConfig,
                           return_device: bool = False, device="cuda"):
    """Compose from ABSOLUTE tile positions (the global solver's output),
    rounded half to even: every tile fuses against the previous tile's true
    extent, the fusion ramp following the consecutive position delta.  A
    tensor composes where it lies, numpy frames on ``device``.  A card's
    panorama comes back in page-locked host memory, locked and cached as
    ``compose`` says."""
    h, w = images.shape[1:3]
    shape, steps, deltas = plan_compose_positions(positions, (h, w), cfg)
    return _run_steps(steps, images, shape, deltas, cfg, return_device,
                      device)


def plan_compose_positions(positions: np.ndarray,
                           image_shape: Tuple[int, int], cfg: StitchConfig):
    """Canvas size + step classification for ABSOLUTE tile positions;
    shared by the device and host composers.  Returns ``((rows, cols),
    steps, deltas)``."""
    h, w = image_shape
    pos = np.round(np.asarray(positions, np.float64)).astype(np.int64)
    pos -= pos.min(axis=0)
    n = pos.shape[0]
    rows = int(pos[:, 0].max()) + h
    cols = int(pos[:, 1].max()) + w
    deltas = [(0, 0)] + [tuple((pos[i] - pos[i - 1]).tolist())
                         for i in range(1, n)]
    steps = []
    for i in range(n):
        r, c = int(pos[i, 0]), int(pos[i, 1])
        if i == 0 or cfg.fuse_method == "notFuse":
            steps.append(("paste", i, (r, c), None, None))
            continue
        pr, pc = int(pos[i - 1, 0]), int(pos[i - 1, 1])
        rr0, rc0 = max(r, pr), max(c, pc)
        rr1, rc1 = min(r + h, pr + h), min(c + w, pc + w)
        if rr1 - rr0 <= 0 or rc1 - rc0 <= 0:
            steps.append(("paste", i, (r, c), None, None))
        else:
            steps.append(("fuse", i, (r, c), (rr0, rc0),
                          (rr1 - rr0, rc1 - rc0)))
    return (rows, cols), steps, deltas
