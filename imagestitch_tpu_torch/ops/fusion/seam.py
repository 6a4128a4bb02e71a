"""Optimal-seam-line fusion.

Port of ``imagestitch_tpu/ops/fusion/seam.py`` (reference:
ImageFusion.py:377-492): the seam energy as shifted-slice correlations,
the row-by-row dynamic programme with the reference's conventions, and the
masked multi-band blend (pyramid.py).  The reference's blocking cv2 debug
windows are dropped; ``draw_seam_overlay`` paints the seam instead.

The DP is sequential over rows.  Each row is two launches on the card (the
three-candidate minimum with its argmin into the move table, then the add
of the row's energy), into buffers allocated once; the table of moves is
read back once and the backtrack walks it on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .blend import _prefill_background
from .pyramid import _pad_reflect, blend_masked

_SX = np.array([[-2, 0, 2], [-1, 0, 1], [-2, 0, 2]], np.float32)
_SY = np.array([[-2, -1, -2], [0, 0, 0], [2, 1, 2]], np.float32)
_INFINITE = 10000.0
_W = 10.0


def _correlate2d_reflect(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """cv2.filter2D semantics: correlation, reflect-101 border, same size,
    as one shifted slice a nonzero tap.  The seam energy feeds it integer
    differences, so every product and sum is exact in float32."""
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    xp = _pad_reflect(_pad_reflect(x, ph, 0), pw, 1)
    h, w = x.shape
    out = torch.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            if k[i, j] != 0.0:
                out = out + float(k[i, j]) * xp[i:i + h, j:j + w]
    return out


def seam_energy(image_a: torch.Tensor, image_b: torch.Tensor
                ) -> torch.Tensor:
    """caculateVaule (ImageFusion.py:403-428): a scaled-difference weight
    times (E_color^2 + E_geometry) with the modified Sobel kernels; pixels
    whose normalised difference reaches 0.7 of its maximum get the
    'infinite' wall weight.  The divisions are by tensors, IEEE on the card
    too."""
    a = image_a.to(torch.float32)
    b = image_b.to(torch.float32)
    e_color = a - b
    e_geometry = (_correlate2d_reflect(e_color, _SX) ** 2
                  + _correlate2d_reflect(e_color, _SY) ** 2)
    diff = (a - b).abs() / torch.maximum(a, b).max()
    diff_max = diff.max()
    w = torch.where(diff < 0.7 * diff_max, _W * diff / diff_max,
                    torch.full_like(diff, _INFINITE))
    return w * (e_color ** 2 + e_geometry)


def find_optimal_seam(value: torch.Tensor, direction="horizontal"
                      ) -> torch.Tensor:
    """findOptimalSeamLine (ImageFusion.py:430-475): the uint8 mask, 1 right
    of the seam, on ``value``'s device, with the JAX package's conventions
    (seam.py:57-115): the DP's first row is the energy row; each step takes
    the least of LEFT, MID, RIGHT with the leftmost on ties and +inf beyond
    the edges; row 0 of the mask is never written (unless it is the only
    row) and the backtrack stops at row 1.  Only the string "vertical"
    transposes (the reference's dispatcher passes an int)."""
    if direction == "vertical":
        value = value.t()
    rows, cols = value.shape
    dev = value.device
    # ping-pong DP rows with +inf borders; moves[r - 1] holds row r's
    # argmin over (left, mid, right)
    dp = torch.full((2, cols + 2), float("inf"), dtype=value.dtype,
                    device=dev)
    dp[0, 1:cols + 1] = value[0]
    moves = torch.empty((max(rows - 1, 0), cols), dtype=torch.int64,
                        device=dev)
    for r in range(1, rows):
        src, dst = dp[(r - 1) % 2], dp[r % 2, 1:cols + 1]
        torch.min(src.unfold(0, 3, 1), dim=1, out=(dst, moves[r - 1]))
        dst.add_(value[r])
    last = dp[(rows - 1) % 2, 1:cols + 1].cpu().numpy()
    mv = moves.cpu().numpy() - 1
    start = int(np.argmin(last))            # first minimum
    # mask row rows-1 from the start; then mask row rows-2-k takes the
    # index before the k-th move (moves of table rows rows-1 .. 2)
    idx = np.empty(rows, np.int64)
    idx[rows - 1] = start
    cur = start
    for k in range(rows - 2):
        idx[rows - 2 - k] = cur
        cur = min(max(cur + int(mv[rows - 2 - k, cur]), 0), cols - 1)
    col = np.arange(cols)
    mask = np.zeros((rows, cols), np.uint8)
    first = 1 if rows > 1 else 0
    mask[first:] = col[None, :] >= idx[first:, None]
    out = torch.as_tensor(mask).to(dev)
    return out.t() if direction == "vertical" else out


def fuse_optimal_seam(image_a: torch.Tensor, image_b: torch.Tensor
                      ) -> torch.Tensor:
    """fuseByOptimalSeamLine (ImageFusion.py:377-401) of two gray int32
    regions with -1 sentinels: background pre-fill, seam mask, masked
    4-level multi-band blend; uint8 out."""
    a, b = _prefill_background(image_a, image_b)
    mask = 1 - find_optimal_seam(seam_energy(a, b))
    out = blend_masked(a.to(torch.float32), b.to(torch.float32),
                       mask.to(torch.float32), 4)
    return out.clamp(0, 255).to(torch.uint8)


def draw_seam_overlay(mask: np.ndarray, fuse_region: np.ndarray
                      ) -> np.ndarray:
    """drawOptimalLine (ImageFusion.py:477-492) without the window: the
    first seam pixel of each column painted red on a BGR copy."""
    mask = np.asarray(mask)
    gray = np.asarray(fuse_region)
    out = np.stack([gray, gray, gray], axis=-1).astype(np.uint8)
    first = np.argmax(mask == 1, axis=0)
    has = (mask == 1).any(axis=0)
    for j in np.nonzero(has)[0]:
        out[first[j], j] = (0, 0, 255)
    return out
