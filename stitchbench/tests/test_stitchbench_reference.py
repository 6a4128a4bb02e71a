"""The plain reference's compose and placement give the port's panoramas
bit for bit on small color and gray layouts (serpentine corners, negative
rebases, a lone frame), and its bfloat16 control does not."""
import numpy as np
import pytest
import torch

from imagestitch_tpu_torch import StitchConfig
from imagestitch_tpu_torch.core import compose as port_compose
from stitchbench import project, reference

LAYOUTS = {
    "serpentine": [(250, 3), (262, 1), (4, 330), (-255, -1), (-262, -2)],
    "line_left": [(-20, -330), (7, -310), (15, -345)],
    "up_and_back": [(-250, 2), (3, -300), (255, 1), (-12, 310)],
}


def _frames(tiny, n, color=True):
    tiny["frame_hw"] = [320, 400]
    tiny["geometry"] = {"kind": "line", "rows": [0] * (n - 1),
                        "cols": [300] * (n - 1)}
    frames = project.build(tiny, 77, torch.device("cpu")).color
    return frames if color else frames[..., 1].copy()


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("color", [True, False])
def test_reference_compose_is_the_ports(tiny, name, color):
    offsets = LAYOUTS[name]
    frames = _frames(tiny, len(offsets) + 1, color)
    want = port_compose.compose(frames, offsets, StitchConfig(), device="cpu")
    got = reference.compose(frames, offsets)
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    place = port_compose.compute_placement(offsets, frames.shape[1:3])
    pos, shape, lo, hi = reference.placement(offsets, *frames.shape[1:3])
    assert shape == tuple(place.canvas_shape)
    assert [tuple(p) for p in pos.tolist()] == list(place.positions)
    assert [tuple(r) for r in np.stack([lo[:, 0], hi[:, 0]], 1).tolist()] \
        == list(place.range_rows)
    ctrl = reference.compose(frames, offsets, dtype="bfloat16")
    assert np.abs(ctrl.astype(int) - want.astype(int)).max() >= 1


def test_truth_segments_and_gray():
    truth = np.array([[512.4, 3.6], [3.3, 330.7], [-254.8, -0.4]])
    ok = reference.pair_overlaps(truth, (320, 400))
    assert ok.tolist() == [False, True, True]
    offs = reference.expected_offsets(truth)
    assert offs == [(512, 3), (3, 330), (-254, 0)]
    segs = reference.segments_from_decisions(ok, offs)
    assert segs == [((0, 1), []), ((1, 4), [(3, 330), (-254, 0)])]
    big = reference.expected_offsets(np.array([[1790.37, 2450.21]]),
                                     "bfloat16")
    assert big == [(1792, 2448)]
    bgr = np.random.default_rng(0).integers(0, 256, (8, 9, 3), np.uint8)
    from imagestitch_tpu_torch.io.dataset import bgr_to_gray
    assert np.array_equal(reference.gray(torch.from_numpy(bgr)).numpy(),
                          bgr_to_gray(bgr))
