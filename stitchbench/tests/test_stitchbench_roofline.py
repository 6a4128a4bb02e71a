"""The frozen roofline arithmetic against the figures PERF.md's kernel
table gives: K1 over the 4 octaves of a 1936x2584 frame is 2.68 GFLOP,
bound 0.0400 ms by its operations; K5 counts each distance once."""
import pytest

from stitchbench import roofline

OCTAVES = [(1936, 2584), (968, 1292), (484, 646), (242, 323)]


def test_k1_operations_of_a_frame():
    radii = roofline.scale_radii(3, 1.2, 2.0 ** (1 / 3))
    assert radii == [4, 5, 6]
    ops = sum(roofline.doh_operations(h, w, radii) for h, w in OCTAVES)
    assert ops == pytest.approx(2.68e9, rel=2e-3)
    bands = [(0, h, w, 8, 4) for h, w in OCTAVES]
    t = roofline.doh_select_bound_s(bands, 3, 1.2, 2.0 ** (1 / 3))
    assert t * 1e3 == pytest.approx(0.0400, abs=5e-5)
    assert t == pytest.approx(ops / roofline.FP32_PEAK)


def test_k5_counts_each_distance_once():
    b, k, d = 10, 11616, 128
    t = roofline.top2_l2_bound_s(b, k, k, d)
    ops = 2 * b * k * k * d
    assert t == pytest.approx(ops / roofline.TF32_PEAK)
    # the chip smoke's bound counts the three TF32 products: 2.0935 ms
    assert 3 * t * 1e3 == pytest.approx(2.0935, abs=2e-3)
    small = roofline.top2_l2_bound_s(1, 1, 1, 128)
    assert small == pytest.approx((4 * (128 + 128 + 3) + 1)
                                  / roofline.HBM_RATE)
