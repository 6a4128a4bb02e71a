"""Image utilities: resize and tilt rectification.

Port of ``imagestitch_tpu/utils/image.py`` (the reference's resizeImg and
rectifyFinalImg, ImageUtility.py:311-368):
  * ``resize`` -- ``jax.image.resize(..., "linear", antialias=True)``,
    rounded half to even and clipped to uint8: the weights of
    ``ops/fusion/pyramid.resize_weights`` applied as one product per axis
    in float64, rounded once to float32 (gray and color);
  * ``rectify_final`` -- the corner-occupancy tilt heuristic, with its
    ``atan(x * 180 / pi)`` angle kept; ``_rotate`` is its bilinear inverse
    map, each operation rounded to float32 as the JAX function's eager
    operations are (the cosine and sine are Python doubles cast to
    float32).
Each computes on ``device`` (the card unless the caller passes
``device="cpu"``) and returns numpy, as the JAX functions do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..ops.fusion.pyramid import _resize_to


def _to_uint8(x: torch.Tensor) -> np.ndarray:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8).cpu().numpy()


def resize(image: np.ndarray, resize_times: float,
           device="cuda") -> np.ndarray:
    """Anti-aliased linear scaling by ``resize_times`` to (int(h * t),
    int(w * t)); the channels of a color image are resized alike."""
    dev = resolve_device(device, "resize")
    h, w = image.shape[:2]
    out_hw = (int(h * resize_times), int(w * resize_times))
    x = torch.as_tensor(np.asarray(image)).to(dev, torch.float32)
    x = x.movedim(-1, 0) if x.dim() == 3 else x
    y = _resize_to(x, out_hw, "linear")
    return _to_uint8(y.movedim(0, -1) if y.dim() == 3 else y)


def _rotate(image: np.ndarray, angle_deg: float, device="cuda") -> np.ndarray:
    """warpAffine-style rotation of a gray (H, W) image about its centre by
    the inverse map, bilinear; samples outside the image are 0."""
    dev = resolve_device(device, "_rotate")
    if np.ndim(image) != 2:
        raise ValueError("_rotate takes a gray (H, W) image, as the JAX "
                         "package's does")
    h, w = image.shape
    cy, cx = h // 2, w // 2
    a = math.radians(angle_deg)
    cos, sin = float(np.float32(math.cos(a))), float(np.float32(math.sin(a)))
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    # inverse map (dst -> src) of cv2.getRotationMatrix2D's convention
    xs = cos * (xx - cx) + sin * (yy - cy) + cx
    ys = -sin * (xx - cx) + cos * (yy - cy) + cy
    x0 = torch.floor(xs).to(torch.int64).clamp(0, w - 1)
    y0 = torch.floor(ys).to(torch.int64).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    fx = xs - torch.floor(xs)
    fy = ys - torch.floor(ys)
    img = torch.as_tensor(np.asarray(image)).to(dev, torch.float32)
    v = ((1 - fy) * (1 - fx) * img[y0, x0] + (1 - fy) * fx * img[y0, x1]
         + fy * (1 - fx) * img[y1, x0] + fy * fx * img[y1, x1])
    inside = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    return _to_uint8(torch.where(inside, v, torch.zeros_like(v)))


def rectify_final(image: np.ndarray, region_length: int = 10,
                  device="cuda") -> np.ndarray:
    """Tilt rectification heuristic (the reference's semantics): rotates
    only when exactly one diagonal pair of corner regions is empty,
    otherwise returns the input unchanged."""
    resolve_device(device, "rectify_final")
    h, w = image.shape[:2]
    ul = image[:region_length, :region_length].sum()
    ur = image[:region_length, w - region_length:].sum()
    bl = image[h - region_length:, :region_length].sum()
    br = image[h - region_length:, w - region_length:].sum()
    if np.count_nonzero(image[:, 0]) / h < 0.3:
        return image
    center = (w // 2, h // 2)
    angle = math.atan(center[1] / center[0] * 180 / math.pi)  # ref formula
    if ul == 0 and br == 0 and ur != 0 and bl != 0:
        return _rotate(image, -angle, device)
    if ul != 0 and br != 0 and ur == 0 and bl == 0:
        return _rotate(image, angle, device)
    return image
