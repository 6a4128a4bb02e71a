"""K2: upright SURF descriptors over the pyramid atlas.

Port of ``imagestitch_tpu/ops/pallas/describe.py::describe_atlas``.  The CUDA
kernel is ``csrc/describe.cu``; ``describe_atlas_plain`` is the same function
in plain PyTorch.  Inputs are the atlas as the pooled path builds it and the
per-keypoint window starts (r0, c0) in atlas coordinates; each descriptor is
taken from the 18x18 window at (r0, c0), clamped inside the atlas.  The
wrapper makes no host-to-device copy per call: the Gaussian window table
is built once per device (``features.describe.weight_table``).
"""
from __future__ import annotations

import torch

from ..features.describe import _gather_windows, describe_windows, weight_table

#: launches of the CUDA kernel since the counter was last set to 0
LAUNCHES = 0
WIN = 18     # window edge: S + 2 samples
MARGIN = 8   # window rows/cols [r - 8, r + 10) around a keypoint


def describe_atlas_plain(atlas: torch.Tensor, r0: torch.Tensor,
                         c0: torch.Tensor, extended: bool = True
                         ) -> torch.Tensor:
    """Plain PyTorch ``describe_atlas``: (K,) starts -> (K, 128|64)."""
    q = _gather_windows(atlas.to(torch.float32), r0, c0, WIN)
    return describe_windows(q, extended)


def _launch(atlas, r0, c0, extended):
    from ... import _build
    global LAUNCHES
    ah, aw = atlas.shape
    k = r0.shape[0]
    out = torch.empty((k, 128 if extended else 64), dtype=torch.float32,
                      device=atlas.device)
    if k == 0:
        return out                       # nothing to launch
    gw = weight_table(atlas.device).reshape(-1)
    lib = _build.library()
    with torch.cuda.device(atlas.device):      # the launch's current card
        err = lib.describe_launch(
            atlas.data_ptr(), ah, aw, r0.data_ptr(), c0.data_ptr(), k,
            gw.data_ptr(), int(extended), out.data_ptr(),
            torch.cuda.current_stream(atlas.device).cuda_stream)
    _build.check(err, "describe_atlas")
    LAUNCHES += 1
    return out


def describe_atlas(atlas: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                   extended: bool = True, use_kernel: bool = True
                   ) -> torch.Tensor:
    """Upright SURF-128 (SURF-64 when not ``extended``) per window start.

    atlas: (Ha, Wa) float32; r0, c0: (K,) int32 window starts.  A CUDA
    atlas runs the CUDA kernel unless ``use_kernel`` is False; a CPU atlas
    runs the plain version.
    """
    if atlas.dim() != 2 or r0.shape != c0.shape or r0.dim() != 1:
        raise ValueError("describe_atlas expects a 2-D atlas and (K,) starts")
    if atlas.shape[0] < WIN or atlas.shape[1] < WIN:
        raise ValueError(f"atlas {tuple(atlas.shape)} smaller than a window")
    if atlas.is_cuda and use_kernel:
        if atlas.dtype != torch.float32:
            raise TypeError(f"describe_atlas kernel needs float32, got "
                            f"{atlas.dtype}")
        if r0.device != atlas.device or c0.device != atlas.device:
            raise ValueError("describe_atlas: starts not on the atlas device")
        return _launch(atlas.contiguous(), r0.to(torch.int32).contiguous(),
                       c0.to(torch.int32).contiguous(), extended)
    return describe_atlas_plain(atlas, r0, c0, extended)
