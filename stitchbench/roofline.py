"""Peaks of one H100 and the work the kernels' inputs need.

Frozen copies of the roofline arithmetic of the repository's chip smoke
test (``doh_operations``, ``bound``, K5's bytes), kept here so that a later
change to the program cannot change the yardstick.  The operations counted
are the work the inputs need, whatever implements it: K5's distances are
2 * D * Ka * Kb operations for each pair, counted once, at the TF32 peak
(the kernel runs three TF32 products to reach float32 accuracy; counting
them would let a cheaper route read above 100%).
"""
from __future__ import annotations

import math
from typing import Sequence

#: NVIDIA H100 SXM data sheet, dense
FP32_PEAK = 67e12
TF32_PEAK = 495e12
HBM_RATE = 3.35e12


def bound_s(ops: float, nbytes: float, peak: float = FP32_PEAK) -> float:
    """The least time: ``ops`` at ``peak`` against ``nbytes`` (each input
    read once, each output written once) at the memory rate."""
    return max(ops / peak, nbytes / HBM_RATE)


def scale_radii(n_scales: int, base_sigma: float, spacing: float):
    """The tap radius of each scale of the DoH response:
    max(2, ceil(3 sigma)), sigma = base_sigma * spacing ** s."""
    return [max(2, int(math.ceil(3.0 * base_sigma * spacing ** s)))
            for s in range(n_scales)]


def doh_operations(h: int, w: int, radii: Sequence[int]) -> int:
    """FP32 operations of the DoH response and NMS on one (h, w) octave:
    per scale of radius r (2r + 1 taps), three vertical correlations on the
    (h + 2) x (w + 2 + 2r) band and three horizontal ones on the
    (h + 2) x (w + 2) ring, 2 * taps - 1 operations a sample; the
    determinant (4) and the scale max (1) on the ring; then the 8
    neighbour maxima and the centre test of the NMS."""
    ring = (h + 2) * (w + 2)
    ops = 9 * h * w
    for s, r in enumerate(radii):
        taps = 2 * r + 1
        ops += 3 * (2 * taps - 1) * ((h + 2) * (w + 2 + 2 * r) + ring)
        ops += (4 + (s > 0)) * ring
    return ops


def doh_select_bound_s(bands, n_scales: int, base_sigma: float,
                       spacing: float) -> float:
    """K1 over one frame's bands (row_off, h, w, border, r_cands): the
    response of every octave, the octave read once (4 bytes a pixel) and
    four float32 outputs a candidate slot written."""
    radii = scale_radii(n_scales, base_sigma, spacing)
    ops = sum(doh_operations(h, w, radii) for _, h, w, _, _ in bands)
    nbytes = sum(4 * h * w + 16 * h * rc for _, h, w, _, rc in bands)
    return bound_s(ops, nbytes)


def top2_l2_bound_s(b: int, ka: int, kb: int, d: int) -> float:
    """K5 over (b, ka, d) queries and (b, kb, d) train rows: 2 * D
    operations a distance at the TF32 peak; both descriptor sets and the
    train mask read once, three (b, ka) outputs written."""
    ops = 2 * b * ka * kb * d
    nbytes = 4 * (b * ka * d + b * kb * d + 3 * b * ka) + b * kb
    return bound_s(ops, nbytes, TF32_PEAK)
