"""Seeded synthetic micrograph sequences with known sub-pixel offsets.

A noisy Gaussian-blob texture is sampled bilinearly at fractional frame
positions and quantised to uint8, so every true pairwise offset is
fractional.  That matters for parity checks: the pooled replay truncates
the sub-pixel-refined mean displacement (``int()``), and at an integer true
offset the mean sits within float32 rounding of an integer, where the
summation order alone could move the result by 1 px.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _blur(x: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur (unit integral), zero outside."""
    r = int(np.ceil(3 * sigma))
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    h, w = x.shape
    xp = np.pad(x, r)
    y = sum(xp[i:i + h, :] * k[i] for i in range(2 * r + 1))
    return sum(y[:, i:i + w] * k[i] for i in range(2 * r + 1))


def textured(rng: np.random.Generator, h: int, w: int,
             density: float = 4e-3) -> np.ndarray:
    """(h, w) float32 texture: ``density * h * w`` Gaussian blobs (sigma
    1.2 / 1.8 / 2.6 px, peak U(40, 160)) at sub-pixel centres on a level of
    20, plus unit Gaussian noise, clipped to [0, 255].  Sub-pixel centres
    and noise leave no mirror-symmetric blob, so no two DoH responses tie
    exactly and the detector's candidate order is decided by the image."""
    tex = np.full((h, w), 20.0, np.float32)
    n = int(density * h * w) // 3
    for sigma in (1.2, 1.8, 2.6):
        y = rng.uniform(0, h - 1, n)
        x = rng.uniform(0, w - 1, n)
        amp = rng.uniform(40, 160, n) * (2 * np.pi * sigma * sigma)
        y0 = np.minimum(np.floor(y).astype(np.int64), h - 2)
        x0 = np.minimum(np.floor(x).astype(np.int64), w - 2)
        fy, fx = y - y0, x - x0
        imp = np.zeros((h, w), np.float32)
        for dy, dx, wt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            np.add.at(imp, (y0 + dy, x0 + dx), (amp * wt).astype(np.float32))
        tex += _blur(imp, sigma)
    tex += rng.normal(0.0, 1.0, (h, w)).astype(np.float32)
    return np.clip(tex, 0, 255).astype(np.float32)


def sample(tex: np.ndarray, r: float, c: float, h: int, w: int) -> np.ndarray:
    """(h, w) uint8 frame: bilinear sample of ``tex`` at (r + i, c + j)."""
    r0, c0 = int(np.floor(r)), int(np.floor(c))
    fr, fc = np.float32(r - r0), np.float32(c - c0)
    t = tex[r0:r0 + h + 1, c0:c0 + w + 1]
    out = ((1 - fr) * (1 - fc) * t[:-1, :-1] + (1 - fr) * fc * t[:-1, 1:]
           + fr * (1 - fc) * t[1:, :-1] + fr * fc * t[1:, 1:])
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def serpentine_positions(n_down: int, n_cols: int, step: Tuple[float, float],
                         drift: Tuple[float, float] = (0.37, 0.21),
                         origin: Tuple[float, float] = (0.43, 0.29)
                         ) -> List[Tuple[float, float]]:
    """Frame top-left positions of a column-major serpentine scan: ``n_down``
    frames down the first column, one step right, back up the next, ...
    Each row step also drifts ``drift[1]`` columns and each column step
    ``drift[0]`` rows, so no true offset is an integer; the fractional
    ``origin`` resamples every frame, so no blob keeps the mirror symmetry
    whose equal DoH responses would make candidate order a coin toss."""
    pos = []
    for j in range(n_cols):
        order = range(n_down) if j % 2 == 0 else range(n_down - 1, -1, -1)
        for i in order:
            pos.append((origin[0] + i * step[0] + j * drift[0],
                        origin[1] + j * step[1] + i * drift[1]))
    return pos


def _scene(seed: int, frame_hw: Tuple[int, int],
           positions: List[Tuple[float, float]]):
    """(rng after the texture, texture covering every frame, positions)."""
    h, w = frame_hw
    p = np.asarray(positions, np.float64)
    rng = np.random.default_rng(seed)
    tex = textured(rng, int(np.ceil(p[:, 0].max())) + h + 2,
                   int(np.ceil(p[:, 1].max())) + w + 2)
    return rng, tex, p


def sequence(seed: int, frame_hw: Tuple[int, int],
             positions: List[Tuple[float, float]]):
    """Frames at ``positions`` of one seeded texture.

    Returns ((N, H, W) uint8 frames, (N-1, 2) float64 true pairwise offsets
    (drow, dcol) = position[k+1] - position[k])."""
    h, w = frame_hw
    _, tex, p = _scene(seed, frame_hw, positions)
    frames = np.stack([sample(tex, r, c, h, w) for r, c in positions])
    return frames, np.diff(p, axis=0)


#: per-channel (gain, offset) of the color scene, B, G, R
CHANNELS = ((0.75, 20.0), (1.0, 0.0), (0.9, 10.0))


def color_sequence(seed: int, frame_hw: Tuple[int, int],
                   positions: List[Tuple[float, float]]):
    """The scene and truth of ``sequence`` in BGR color: each channel is the
    texture under its own gain and offset (``CHANNELS``) plus its own unit
    Gaussian noise, so a swapped or collapsed channel shows; the gray of the
    frames (cv2's rule) is the texture again up to scale and noise, and
    registers as the gray sequence does.

    Returns ((N, H, W, 3) uint8 frames, (N-1, 2) float64 true offsets)."""
    h, w = frame_hw
    rng, tex, p = _scene(seed, frame_hw, positions)
    chans = [np.clip(g * tex + o + rng.normal(0.0, 1.0, tex.shape), 0, 255
                     ).astype(np.float32) for g, o in CHANNELS]
    frames = np.stack([np.stack([sample(t, r, c, h, w) for t in chans], -1)
                       for r, c in positions])
    return frames, np.diff(p, axis=0)
