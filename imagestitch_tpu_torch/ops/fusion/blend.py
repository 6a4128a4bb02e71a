"""fadeInAndFadeOut fusion.

Port of ``imagestitch_tpu/ops/fusion/blend.py:52-84, :144-208`` (reference:
ImageFusion.py:192-244) for gray (H, W) and color (H, W, 3) regions: int32
with ``-1`` background sentinels in, uint8 out.  The other fusion modes are
not ported yet (ROADMAP Queue 1 item 18).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .weights import corner_fade_weights, plain_fade_weights


def _fade_weights(image_a: torch.Tensor, drow: int, dcol: int,
                  color: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain separable ramps when more than 65% of A's elements (channels
    included) are valid, else the corner-quadrant weights
    (ImageFusion.py:209-239).  The fraction is float32 count / size, as in
    the JAX composer (blend.py:181-182), divided on the host (weights.py
    says why)."""
    valid_frac = (np.float32(int((image_a > -1).sum()))
                  / np.float32(image_a.numel()))
    if valid_frac > np.float32(0.65):
        return plain_fade_weights((image_a.shape[0], image_a.shape[1]),
                                  drow, dcol, device=image_a.device)
    return corner_fade_weights(image_a, color)


def _apply_weights(image_a: torch.Tensor, image_b: torch.Tensor,
                   wa: torch.Tensor, wb: torch.Tensor,
                   color: bool = False) -> torch.Tensor:
    """A[A<0] <- B; blend; clamp [0,255]; truncate to uint8
    (ImageFusion.py:240-243).  In color the (H, W) weights broadcast over
    the channels.

    The blend is rounded as fma(wb, b, wa * a): the fused multiply-add that
    XLA emits for the JAX package's ``wa * a + wb * b`` in its composer
    (the padded fuse step), gray and color alike; a plain float32 sum is
    one level off on a few 1e-4 of the blended pixels.  In float64 the
    product wb * b (24 x 8 significant bits) and the sum are exact, so
    casting that sum to float32 is the single FMA rounding.
    """
    if color:
        wa, wb = wa[..., None], wb[..., None]
    a = torch.where(image_a < 0, image_b, image_a)
    waa = wa * a.to(torch.float32)
    res = (wb.to(torch.float64) * image_b.to(torch.float64)
           + waa.to(torch.float64)).to(torch.float32)
    return res.clamp(0, 255).to(torch.uint8)


def fuse_fade(image_a: torch.Tensor, image_b: torch.Tensor, drow: int,
              dcol: int, color: bool = False) -> torch.Tensor:
    """fadeInAndFadeOut fusion (ImageFusion.py:192-244) of two regions;
    ``drow``/``dcol`` is the pairwise offset of the pair being fused."""
    wa, wb = _fade_weights(image_a, drow, dcol, color)
    return _apply_weights(image_a, image_b, wa, wb, color)
