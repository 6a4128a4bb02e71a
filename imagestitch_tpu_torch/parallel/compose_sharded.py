"""Sharded canvas composition.

Port of ``imagestitch_tpu/parallel/compose_sharded.py`` (:1-288).  The
reference fuses into one monolithic canvas (Stitcher.py:433-483); here the
int16 canvas is split into row blocks of ``ceil(rows / d)`` rows, one a
shard of the mesh, each on its shard's device:
  * a paste writes each shard's rows of the frame into its own block, with
    no communication;
  * a fusion rect is gathered by ONE ``psum`` of each shard's masked slice
    (blocks partition the rows, so each pixel has one contributor and the
    int16 sum is the gather, exact); the rect after the paste is the
    gathered rect with the frame pasted in (JAX :101-123), so one
    collective serves both; the rect is blended once, on shard 0's device,
    and each shard writes back its own rows.
Steps come from ``core/compose.plan_compose``, classified as JAX :231-246
classifies them, and run one at a time as the port's ``compose`` runs
them, so every mode's canvas is bit-equal to ``compose``'s.  Multiband and
the optimal seam compose gray only and refuse color before any work.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import StitchConfig
from ..core.compose import _GRAY_ONLY_METHODS, _fuse_dispatch, plan_compose
from .mesh import psum

# Dispatch and collective accounting of the most recent compose_sharded
# call: one dispatch a step, one psum a fused image, pastes move nothing.
LAST_COMPOSE_STATS: dict = {}


def _rows(s: int, rb: int, r0: int, nr: int) -> Tuple[int, int]:
    """[a, b): the rows of [r0, r0 + nr) in shard s's block (global)."""
    return max(r0, s * rb), min(r0 + nr, (s + 1) * rb)


def _write(blocks, rb: int, img: torch.Tensor, r: int, c: int) -> None:
    """Overwrite ``img`` (on any device) at global (r, c): each shard its
    own rows."""
    ih, iw = img.shape[:2]
    for s, blk in enumerate(blocks):
        a, b = _rows(s, rb, r, ih)
        if a < b:
            blk[a - s * rb:b - s * rb, c:c + iw] = img[a - r:b - r].to(
                blk.device)


def _gather_rect(blocks, rb: int, rr: int, rc: int, rh: int, rw: int, mesh
                 ) -> torch.Tensor:
    """The global (rh, rw) rect at (rr, rc) on shard 0's device: the psum
    of each shard's masked slice (zeros outside its rows)."""
    parts = []
    for s, blk in enumerate(blocks):
        part = blk.new_zeros((rh, rw) + tuple(blk.shape[2:]))
        a, b = _rows(s, rb, rr, rh)
        if a < b:
            part[a - rr:b - rr] = blk[a - s * rb:b - s * rb, rc:rc + rw]
        parts.append(part)
    return psum(parts, mesh)[0]


def compose_sharded(images, offsets: Sequence[Tuple[int, int]],
                    cfg: StitchConfig, mesh, return_device: bool = False):
    """The sharded-canvas counterpart of ``core/compose.compose``.

    ``images``: (N, H, W) gray or (N, H, W, 3) uint8, numpy or a tensor;
    each frame goes to shard 0's device at its step.  Returns the host
    uint8 panorama, or with ``return_device`` ``(panorama, rows)`` with the
    panorama on shard 0's device."""
    n, h, w = images.shape[:3]
    if len(offsets) != n - 1:
        raise ValueError(f"{len(offsets)} offsets for {n} images")
    color = images.ndim == 4
    if color and cfg.fuse_method in _GRAY_ONLY_METHODS:
        raise ValueError(f"fuse_method={cfg.fuse_method!r} composes gray "
                         f"frames only (the reference's), got color")
    placement, steps, pairwise = plan_compose(offsets, (h, w), cfg)
    rows, cols = placement.canvas_shape
    d = mesh.size
    rb = -(-rows // d)
    chan = (3,) if color else ()
    blocks = [torch.full((rb, cols) + chan, -1, dtype=torch.int16,
                         device=dev) for dev in mesh.devices]
    dev0 = mesh.devices[0]
    n_psum = payload = 0
    for kind, i, (r, c), rect, size in steps:
        img = torch.as_tensor(images[i]).to(dev0, torch.int16)
        if kind == "paste":
            _write(blocks, rb, img, r, c)
            continue
        (rr, rc), (rh, rw) = rect, size
        roi_a = _gather_rect(blocks, rb, rr, rc, rh, rw, mesh)
        n_psum += 1
        payload += roi_a.numel() * roi_a.element_size()
        roi_b = roi_a.clone()              # the rect after the paste
        r0, r1 = max(r, rr), min(r + h, rr + rh)
        c0, c1 = max(c, rc), min(c + w, rc + rw)
        roi_b[r0 - rr:r1 - rr, c0 - rc:c1 - rc] = \
            img[r0 - r:r1 - r, c0 - c:c1 - c]
        _write(blocks, rb, img, r, c)
        drow, dcol = pairwise[i]
        fused = _fuse_dispatch(roi_a.to(torch.int32), roi_b.to(torch.int32),
                               drow, dcol, cfg.fuse_method, color)
        _write(blocks, rb, fused.to(torch.int16), rr, rc)
    LAST_COMPOSE_STATS.clear()
    # a ring all-reduce of an N-byte payload moves about 2 (d - 1) / d * N
    # bytes through each device's links (JAX :276-279; NVLink alike)
    LAST_COMPOSE_STATS.update(
        dispatches=len(steps), fuse_psums=n_psum, n_images=n, n_devices=d,
        psum_payload_bytes=int(payload),
        modeled_ici_bytes_per_device=int(payload * 2 * (d - 1) / max(d, 1)))
    canvas = torch.cat([blk.to(dev0) for blk in blocks])[:rows]
    pano = canvas.clamp_(min=0).to(torch.uint8)   # -1 sentinel -> 0
    if return_device:
        return pano, rows
    return pano.cpu().numpy()
