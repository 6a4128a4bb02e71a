"""Seeded synthetic micrographs, made on the card.

A torch rewrite of the texture and sampling rules of the port's
``utils/synthetic.py`` (frozen here, so that a change to the program cannot
change the benchmark's inputs): Gaussian blobs of three widths at sub-pixel
centres on a flat level, unit Gaussian noise, per-channel gain, offset and
noise for color, then frames sampled bilinearly at fractional positions and
rounded to uint8.  The numpy original would take minutes for the 391 MP
scene of the dendritic grid; on the card it takes about a second.

The random draws come from ``torch.Generator`` on the texture's device;
``texture_from_draws`` and ``sample`` are deterministic functions of them, so
a test can feed the same draws to a numpy copy.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (h, w) float32 tensor, unit integral,
    zero outside: the taps summed in order, rows then columns."""
    r = int(math.ceil(3 * sigma))
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    h, w = x.shape
    xp = torch.nn.functional.pad(x[None, None], (r, r, r, r))[0, 0]
    y = torch.zeros((h, w + 2 * r), dtype=torch.float32, device=x.device)
    for i in range(2 * r + 1):
        y.add_(xp[i:i + h, :] * float(k[i]))
    del xp
    out = torch.zeros((h, w), dtype=torch.float32, device=x.device)
    for i in range(2 * r + 1):
        out.add_(y[:, i:i + w] * float(k[i]))
    return out


def draw_blobs(gen: torch.Generator, h: int, w: int, tex: Dict
               ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Per blob width, ``density * h * w / 3`` centres uniform over the
    scene and peak amplitudes uniform in ``amp`` (float64 draws)."""
    dev = gen.device
    n = int(tex["density"] * h * w) // 3
    lo, hi = tex["amp"]
    out = []
    for sigma in tex["sigmas"]:
        y = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) \
            * (h - 1)
        x = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) \
            * (w - 1)
        amp = (lo + (hi - lo) * torch.rand(n, generator=gen, device=dev,
                                           dtype=torch.float64)) \
            * (2 * math.pi * sigma * sigma)
        out.append((y, x, amp))
    return out


def texture_from_draws(h: int, w: int, tex: Dict, blobs, noise: torch.Tensor
                       ) -> torch.Tensor:
    """(h, w) float32 scene: ``level`` plus each width's blobs (bilinear
    impulses, blurred) plus ``noise``, clipped to [0, 255]."""
    dev = noise.device
    out = torch.full((h, w), float(tex["level"]), dtype=torch.float32,
                     device=dev)
    for sigma, (y, x, amp) in zip(tex["sigmas"], blobs):
        y0 = torch.clamp(torch.floor(y).to(torch.int64), max=h - 2)
        x0 = torch.clamp(torch.floor(x).to(torch.int64), max=w - 2)
        fy, fx = y - y0, x - x0
        imp = torch.zeros(h * w, dtype=torch.float32, device=dev)
        for dy, dx, wt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            imp.index_add_(0, (y0 + dy) * w + (x0 + dx),
                           (amp * wt).to(torch.float32))
        out += blur(imp.view(h, w), sigma)
        del imp
    out += noise
    return out.clamp_(0, 255)


def make_texture(gen: torch.Generator, h: int, w: int, tex: Dict
                 ) -> torch.Tensor:
    blobs = draw_blobs(gen, h, w, tex)
    noise = torch.randn((h, w), generator=gen, device=gen.device,
                        dtype=torch.float32) * float(tex["noise"])
    return texture_from_draws(h, w, tex, blobs, noise)


def color_planes(gen: torch.Generator, base: torch.Tensor,
                 channels: Sequence[Sequence[float]], noise: float
                 ) -> List[torch.Tensor]:
    """B, G, R planes: ``gain * base + offset`` plus each plane's own
    Gaussian noise, clipped to [0, 255]."""
    planes = []
    for gain, offset in channels:
        n = torch.randn(base.shape, generator=gen, device=base.device,
                        dtype=torch.float32) * float(noise)
        planes.append((base * float(gain) + float(offset) + n).clamp_(0, 255))
    return planes


def sample(plane: torch.Tensor, r: float, c: float, h: int, w: int
           ) -> torch.Tensor:
    """(h, w) uint8: ``plane`` sampled bilinearly at (r + i, c + j), float32
    weights, rounded half to even and clipped."""
    r0, c0 = int(math.floor(r)), int(math.floor(c))
    fr, fc = np.float32(r - r0), np.float32(c - c0)
    t = plane[r0:r0 + h + 1, c0:c0 + w + 1]
    one = np.float32(1)
    out = (t[:-1, :-1] * float((one - fr) * (one - fc))
           + t[:-1, 1:] * float((one - fr) * fc)
           + t[1:, :-1] * float(fr * (one - fc))
           + t[1:, 1:] * float(fr * fc))
    return torch.round(out).clamp_(0, 255).to(torch.uint8)
