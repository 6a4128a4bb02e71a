"""K6: per-keypoint column sums of a window of an atlas.

Port of the round-4 Pallas prototype ``scripts/profile_r4_micro2.py::proto``
(the backbone of K2's band-streamed describe: for each keypoint a 24-row
window of the atlas is read and the column sums of its first 128 columns
are written).  The CUDA kernel is ``csrc/window_colsum.cu``;
``window_colsum_plain`` is the same function in plain PyTorch.

It is bound by device memory: a keypoint reads 24 rows of 512 bytes and
adds them.  The TPU version streamed the atlas in 256-row bands through
VMEM and found each band's keypoints from a prefetched ``starts`` table;
the kernel here reads each window straight from device memory, one block
per keypoint and one coalesced row at a time, and leaves the rows that
neighbouring keypoints share to L2.  So it takes no ``starts``, and the
keypoints need not be sorted.
"""
from __future__ import annotations

import torch

#: launches of the CUDA kernel since the counter was last set to 0
LAUNCHES = 0


def window_colsum_plain(atlas: torch.Tensor, r0: torch.Tensor,
                        ca: torch.Tensor, rows: int = 24, cols: int = 128
                        ) -> torch.Tensor:
    """Plain PyTorch ``window_colsum``: ``rows`` adds of a gathered
    (K, cols) slice, in row order from 0 (the kernel's order)."""
    r = r0.long()[:, None]
    c = ca.long()[:, None] + torch.arange(cols, device=atlas.device)
    out = torch.zeros((r0.shape[0], cols), dtype=atlas.dtype,
                      device=atlas.device)
    for i in range(rows):
        out = out + atlas[r + i, c]
    return out


def _launch(atlas, r0, ca, rows, cols):
    from ... import _build
    global LAUNCHES
    ah, aw = atlas.shape
    k = r0.shape[0]
    out = torch.empty((k, cols), dtype=torch.float32, device=atlas.device)
    lib = _build.library()
    with torch.cuda.device(atlas.device):      # the launch's current card
        err = lib.window_colsum_launch(
            atlas.data_ptr(), ah, aw, r0.data_ptr(), ca.data_ptr(), k, rows,
            cols, out.data_ptr(),
            torch.cuda.current_stream(atlas.device).cuda_stream)
    _build.check(err, "window_colsum")
    LAUNCHES += 1
    return out


def _check(atlas, r0, ca, rows, cols):
    if atlas.dim() != 2 or r0.dim() != 1 or r0.shape != ca.shape:
        raise ValueError(f"window_colsum expects a 2-D atlas and (K,) "
                         f"starts, got {tuple(atlas.shape)}, "
                         f"{tuple(r0.shape)}, {tuple(ca.shape)}")
    ah, aw = atlas.shape
    if not (1 <= rows <= ah and 1 <= cols <= aw):
        raise ValueError(f"window_colsum: a {rows}x{cols} window in an "
                         f"atlas of {ah}x{aw}")
    if r0.numel() == 0:
        return
    lo_r, hi_r, lo_c, hi_c = torch.stack(
        [r0.min(), r0.max(), ca.min(), ca.max()]).tolist()
    if lo_r < 0 or hi_r > ah - rows or lo_c < 0 or hi_c > aw - cols:
        raise ValueError(f"window_colsum: windows at rows [{lo_r}, {hi_r}] "
                         f"and cols [{lo_c}, {hi_c}] leave the "
                         f"{ah}x{aw} atlas")


def window_colsum(atlas: torch.Tensor, r0: torch.Tensor, ca: torch.Tensor,
                  rows: int = 24, cols: int = 128, use_kernel: bool = True
                  ) -> torch.Tensor:
    """(K, cols) column sums of the ``rows`` x ``cols`` window of ``atlas``
    at (r0[i], ca[i]) for each keypoint i.

    atlas: (HA, WA) float32; r0, ca: (K,) int32 window starts, each window
    inside the atlas.  A CUDA atlas runs the CUDA kernel unless
    ``use_kernel`` is False; a CPU atlas runs the plain version.
    """
    _check(atlas, r0, ca, rows, cols)
    if atlas.is_cuda and use_kernel:
        if atlas.dtype != torch.float32 or not atlas.is_contiguous():
            raise TypeError(f"window_colsum kernel needs a contiguous "
                            f"float32 atlas, got {atlas.dtype}")
        for t in (r0, ca):
            if t.dtype != torch.int32 or t.device != atlas.device \
                    or not t.is_contiguous():
                raise TypeError("window_colsum kernel needs contiguous "
                                "int32 starts on the atlas device")
        return _launch(atlas, r0, ca, rows, cols)
    return window_colsum_plain(atlas, r0, ca, rows, cols)
