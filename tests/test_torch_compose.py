"""Fade composition: the port's compose (exact-rect eager steps, static-shape
weights) against the JAX compose (bucketed lax.scan steps, dynamic-rect
weights) on gray frames, plus the host placement against the JAX one
(the other fusion modes: test_torch_fusion_modes.py).
Panoramas are bit-equal: the port rounds the blend as the fused
multiply-add that XLA emits in the JAX composer (ops/fusion/blend.py)."""
import numpy as np
import pytest
import torch

from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import compose as jcompose
from imagestitch_tpu_torch import StitchConfig
from imagestitch_tpu_torch.core import compose as tcompose
from imagestitch_tpu_torch.ops.fusion import blend as tblend
from imagestitch_tpu_torch.ops.fusion import weights as tweights

H, W = 120, 160
CASES = {
    # vertical chain: plain ramps across rows
    "down": [(50, 3), (48, -2), (51, 1)],
    # negative offsets: every step rebases the canvas
    "up_left_rebase": [(-50, 4), (-47, -3), (2, -120)],
    # row transition of a 2x2 grid: step 3's rect is < 65% valid before
    # its paste, so it takes the corner-quadrant weights
    "grid_corner": [(0, 100), (80, -100), (0, 100)],
    # the same transition leftwards and upwards
    "grid_corner_mirror": [(0, -100), (-80, 100), (0, -100)],
}


def _frames(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W),
                                                dtype=np.uint8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_compose_matches_jax(name):
    offsets = CASES[name]
    frames = _frames(len(name), len(offsets) + 1)
    jp = jcompose.compute_placement(offsets, (H, W))
    tp = tcompose.compute_placement(offsets, (H, W))
    assert vars(tp) == vars(jp)
    jcfg = JStitchConfig(color_mode=False)
    cfg = StitchConfig(color_mode=False)
    _, jsteps, _ = jcompose.plan_compose(offsets, (H, W), jcfg)
    _, tsteps, _ = tcompose.plan_compose(offsets, (H, W), cfg)
    assert tsteps == jsteps
    ref = np.asarray(jcompose.compose(frames, offsets, jcfg))
    got = tcompose.compose(frames, offsets, cfg, device="cpu")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_grid_corner_case_takes_corner_weights():
    offsets = CASES["grid_corner"]
    _, steps, _ = tcompose.plan_compose(offsets, (H, W), StitchConfig())
    kind, i, (r, c), (rr, rc), (rh, rw) = steps[3]
    assert kind == "fuse"
    frames = torch.as_tensor(_frames(3, 4))
    # rebuild the canvas before step 3 and check the weight choice
    canvas = torch.full((200, 260), -1, dtype=torch.int32)
    canvas[0:H, 0:W] = frames[0]
    canvas[0:H, 100:100 + W] = frames[1]
    canvas[80:80 + H, 0:W] = frames[2]
    roi_a = canvas[rr:rr + rh, rc:rc + rw]
    assert (roi_a > -1).float().mean() < 0.65
    wa, wb = tblend._fade_weights(roi_a, 0, 100)
    ca, cb = tweights.corner_fade_weights(roi_a)
    assert torch.equal(wa, ca) and torch.equal(wb, cb)


def test_unsupported_fusion_raises(monkeypatch):
    """Every fusion mode is ported: average composes as the JAX package
    does (each mode's parity is in test_torch_fusion_modes.py), and color
    multiband and optimal seam raise ValueError before any work, even
    before the card is looked for (the JAX package asserts gray)."""
    frames = _frames(0, 2)
    np.testing.assert_array_equal(
        tcompose.compose(frames, [(50, 0)],
                         StitchConfig(fuse_method="average"), device="cpu"),
        np.asarray(jcompose.compose(frames, [(50, 0)],
                                    JStitchConfig(fuse_method="average"))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for method in ("multiBandBlending", "optimalSeamLine"):
        with pytest.raises(ValueError, match="gray frames only"):
            tcompose.compose(np.zeros((2, H, W, 3), np.uint8), [(50, 0)],
                             StitchConfig(fuse_method=method))
