"""The reference stitcher's fuseByMultiBandBlending (ImageFusion.py:296-374)
of one gray overlap, in plain torch and numpy; it imports nothing of the
program.

- Pre-fill (Stitcher.py:498-504): -1 becomes 0, then the 0s of ``before``
  are filled from ``after``, and the 0s of ``after`` from the filled
  ``before``.
- Gaussian pyramid: gp[0] = x, gp[k + 1] the 5-tap binomial
  [1, 4, 6, 4, 1] / 16 with reflect-101 borders, rows then columns,
  keeping every second row and column.
- Expand: zero-stuff to twice the size, then the same filter with every
  weight doubled on each axis (a gain of 4).
- Resize of an expanded level to an odd finer level: the Keys cubic
  (a = -0.5) at half-pixel centres, the kernel widened by 1 / scale on a
  downscale, taps outside the input dropped and each output's weights
  divided by their sum; rows, then columns.
- The effective Laplacian stack: lp[0] = gp[3], lp[k] = gp[3 - k] -
  resize(expand(gp[4 - k])) for k = 1..3; each level blended 0.5 a +
  0.5 b, then out = resize(expand(out)) + lp[k]; clamped to [0, 255] and
  truncated to uint8.

Every step is an elementwise product or sum in float32 (no contraction,
so TF32 never enters), each rounded on its own; the resize weights are
worked out in float64 on the host and rounded once to float32.
``dtype="bfloat16"`` takes the same steps in bfloat16, the weights
rounded on from float32 (the control).

Departures from ImageFusion.py, as the program's pyramid departs:
- its Laplacian list is seeded with gp[level - 1] and its last entry reads
  gp[-1] (ImageFusion.py:343-351), but only its first ``level`` entries are
  read (:323-327, :337-339): this builds those entries alone;
- cv2.pyrUp treats its border rows and columns by its own scheme; here the
  zero-stuffed image is padded by reflect-101, which differs within two
  pixels of the edge;
- cv2.resize with INTER_CUBIC takes a = -0.75 and never widens its kernel;
  here jax.image.resize's documented "cubic" (above) is taken;
- cv2 runs the pyramid on uint8 and float64 images; here every level is
  float32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_K5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)
_K5_UP = tuple(2.0 * k for k in _K5)
LEVELS = 4


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each position of an axis of ``n`` padded by ``pad``
    on both sides, mirrored about the edge samples."""
    i = np.abs(np.arange(-pad, n + pad))
    if n > 1:
        period = 2 * (n - 1)
        i = i % period
        i = np.where(i >= n, period - i, i)
    else:
        i = np.zeros_like(i)
    return torch.from_numpy(i).to(device)


def _filter(x: torch.Tensor, k, dim: int) -> torch.Tensor:
    """Correlate along ``dim`` with the taps ``k``, reflect-101 borders,
    the taps summed in order, each product rounded in ``x``'s dtype."""
    n, pad = x.shape[dim], len(k) // 2
    xp = x.index_select(dim, _reflect101(n, pad, x.device))
    acc = xp.narrow(dim, 0, n) * k[0]
    for t in range(1, len(k)):
        acc = acc + xp.narrow(dim, t, n) * k[t]
    return acc


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    return _filter(_filter(x, _K5, 0), _K5, 1)[::2, ::2]


def expand(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    up = x.new_zeros((2 * h, 2 * w))
    up[::2, ::2] = x
    return _filter(_filter(up, _K5_UP, 0), _K5_UP, 1)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    near = (1.5 * x - 2.5) * x * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=256)
def _cubic_band(m: int, n: int):
    """(n, T) source indices and float64 weights of the resize from ``m``
    samples to ``n``; a tap outside [0, m) has index 0 and weight 0."""
    inv = m / n
    widen = max(inv, 1.0)
    pos = (np.arange(n) + 0.5) * inv - 0.5
    reach = int(np.ceil(2.0 * widen))
    idx = np.floor(pos).astype(np.int64)[:, None] + np.arange(
        -reach + 1, reach + 1)[None, :]
    w = _keys_cubic((pos[:, None] - idx) / widen)
    w = np.where((idx >= 0) & (idx < m), w, 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    inside = (pos >= -0.5) & (pos <= m - 0.5)
    w = np.where(inside[:, None], w, 0.0)
    return np.clip(idx, 0, m - 1), w


def _resize_axis(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    m = x.shape[dim]
    if m == n:
        return x
    idx, w = _cubic_band(m, n)
    idx = torch.from_numpy(idx).to(x.device)
    w = torch.from_numpy(w).to(x.device).to(torch.float32).to(x.dtype)
    acc = None
    for t in range(idx.shape[1]):
        wt = w[:, t, None] if dim == 0 else w[None, :, t]
        term = x.index_select(dim, idx[:, t]) * wt
        acc = term if acc is None else acc + term
    return acc


def resize(x: torch.Tensor, shape_hw) -> torch.Tensor:
    return _resize_axis(_resize_axis(x, shape_hw[0], 0), shape_hw[1], 1)


def laplacian(x: torch.Tensor):
    gp = [x]
    for _ in range(LEVELS - 1):
        gp.append(pyr_down(gp[-1]))
    lp = [gp[LEVELS - 1]]
    for k in range(1, LEVELS):
        finer = gp[LEVELS - 1 - k]
        lp.append(finer - resize(expand(gp[LEVELS - k]), finer.shape))
    return lp


def fuse(before: torch.Tensor, after: torch.Tensor, drow: int, dcol: int,
         color: bool, dtype: str = "float32") -> torch.Tensor:
    """Fuse the gray rect before (int32, -1 for empty) and after the
    paste; uint8 out, where ``before`` lies.  The offsets are not used."""
    if color:
        raise ValueError("multiBandBlending fuses gray frames only "
                         "(Stitcher.py:520)")
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    a = torch.where(before == -1, 0, before)
    b = torch.where(after == -1, 0, after)
    a = torch.where(a == 0, b, a)
    b = torch.where(b == 0, a, b)
    la, lb = laplacian(a.to(dt)), laplacian(b.to(dt))
    blended = [x * 0.5 + y * 0.5 for x, y in zip(la, lb)]
    out = blended[0]
    for k in range(1, LEVELS):
        out = resize(expand(out), blended[k].shape) + blended[k]
    return out.to(torch.float32).clamp(0, 255).to(torch.uint8)
