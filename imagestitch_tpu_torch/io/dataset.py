"""Dataset discovery and batched loading.

Port of ``imagestitch_tpu/io/dataset.py``: files decode into one dense
(N, H, W[, 3]) uint8 batch, JPEGs through the runtime's thread-pool
libjpeg decoder (io/native_loader.py) and anything else through
io/codec.py on a thread pool.  Registration always runs on gray; in color mode the gray
frames are made from the color ones with cv2's fixed-point rule: on the
host (``bgr_to_gray``) or, where the color frames go to a device, there
(``bgr_to_gray_tensor``), with the same bits.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import profiling


def list_project_images(project_address: str, sub_project: int,
                        file_extension: str = "jpg") -> List[str]:
    """Files of numbered sub-project ``sub_project`` (reference
    Stitcher.py:167-168), extension matched case-insensitively, sorted."""
    d = os.path.join(project_address, str(sub_project))
    if not os.path.isdir(d):
        return []
    ext = file_extension.lower()
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith("." + ext))


@dataclass
class ImageBatch:
    """A decoded dataset resident as one dense batch.

    gray:  (N, H, W) uint8 (numpy or tensor) — registration runs on gray;
        None in a chunk decoded by ``load_color``, whose gray is made later.
    color: (N, H, W, 3) uint8 BGR (numpy or tensor), or None in gray mode.
    files: source paths, capture order.
    gray_host: host copy of ``gray`` when ``gray`` is a device tensor and
        the streamed-output composers need host frames; else None.
    """
    gray: np.ndarray
    color: Optional[np.ndarray]
    files: List[str]
    gray_host: Optional[np.ndarray] = None

    @property
    def num_images(self) -> int:
        return self.gray.shape[0]

    @property
    def image_shape(self):
        return tuple(self.gray.shape[1:3])


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) BGR uint8 -> (H, W) gray by cv2's 14-bit fixed-point rule,
    ``(1868 b + 9617 g + 4899 r + 8192) >> 14`` (native/stitch_runtime.cpp:
    190-199): in the runtime when it loads, else the same integer expression
    in numpy.  Both give the same bits."""
    from .native_loader import bgr_to_gray_native
    g = bgr_to_gray_native(bgr)
    if g is not None:
        return g
    x = bgr.astype(np.uint32)
    return ((1868 * x[..., 0] + 9617 * x[..., 1] + 4899 * x[..., 2] + 8192)
            >> 14).astype(np.uint8)


def bgr_to_gray_tensor(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR uint8 tensor -> (..., H, W) uint8 gray on its
    device, by ``bgr_to_gray``'s integer rule in int32: the same bits.
    Frame by frame, so that the int32 temporaries are one frame's."""
    gray = torch.empty(bgr.shape[:-1], dtype=torch.uint8, device=bgr.device)
    for out, x in zip(gray.view(-1, *gray.shape[-2:]),
                      bgr.reshape(-1, *bgr.shape[-3:])):
        x = x.to(torch.int32)
        out.copy_((x[..., 0] * 1868 + x[..., 1] * 9617 + x[..., 2] * 4899
                   + 8192) >> 14)
    return gray


def _stack(files: Sequence[str], frames) -> np.ndarray:
    """``frames``, decoded from ``files``, as one batch; mixed shapes are
    rejected."""
    shape0 = frames[0].shape
    for f, g in zip(files, frames):
        if g.shape != shape0:
            raise ValueError(f"inconsistent image shapes in sequence: "
                             f"{files[0]}={shape0} vs {f}={g.shape}")
    return np.stack(frames)


def _decode(files: Sequence[str], color_mode: bool, loader) -> list:
    if not files:
        raise ValueError("empty file list")
    # counters only: the decode worker thread runs this, where the profiler
    # keeps no annotation
    with profiling.span("ingest.decode", annotate=False):
        if loader is None:
            from .native_loader import NativeLoader
            loader = NativeLoader()
        return loader.read_all(files, color_mode)


def load_batch(files: Sequence[str], color_mode: bool,
               loader=None) -> ImageBatch:
    """Decode ``files`` into one contiguous batch; mixed shapes are
    rejected.  ``loader``: any object with ``read_all(files, color)``; by
    default the runtime's thread-pool decoder (io/native_loader.py)."""
    decoded = grays = _decode(files, color_mode, loader)
    if color_mode:
        with profiling.span("ingest.gray", annotate=False):
            with ThreadPoolExecutor(min(len(files),
                                        os.cpu_count() or 1)) as pool:
                grays = list(pool.map(bgr_to_gray, decoded))
    with profiling.span("ingest.decode", annotate=False):
        return ImageBatch(gray=_stack(files, grays),
                          color=np.stack(decoded) if color_mode else None,
                          files=list(files))


def load_color(files: Sequence[str], loader=None) -> ImageBatch:
    """``load_batch`` in color mode without the gray (``gray`` is None),
    for a caller that makes it where the frames go."""
    decoded = _decode(files, True, loader)
    with profiling.span("ingest.decode", annotate=False):
        return ImageBatch(gray=None, color=_stack(files, decoded),
                          files=list(files))
