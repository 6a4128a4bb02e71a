"""Fade composition: the port's compose (exact-rect eager steps, static-shape
weights) against the JAX compose (bucketed lax.scan steps, dynamic-rect
weights) on gray frames, plus the host placement against the JAX one
(the other fusion modes: test_torch_fusion_modes.py).
Panoramas are bit-equal: the port rounds the blend as the fused
multiply-add that XLA emits in the JAX composer (ops/fusion/blend.py).
Last, the panorama's readback: unchanged on the CPU, and on the card into
page-locked host memory that the caller owns."""
import numpy as np
import pytest
import torch

from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import compose as jcompose
from imagestitch_tpu_torch import StitchConfig
from imagestitch_tpu_torch.core import compose as tcompose
from imagestitch_tpu_torch.ops.fusion import blend as tblend
from imagestitch_tpu_torch.ops.fusion import weights as tweights
from imagestitch_tpu_torch.utils import profiling

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


#: the readback's counters (utils/profiling.py): card panoramas read back,
#: of them those in a page-locked block already made, and the pageable ones
READBACK_COUNTERS = ("COMPOSE_READBACKS", "COMPOSE_READBACK_REUSED",
                     "COMPOSE_READBACK_PAGEABLE")


def _readback_counters():
    return {c: getattr(profiling, c) for c in READBACK_COUNTERS}


def _color_frames(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 3),
                                                dtype=np.uint8)


def _positions(offsets):
    """The absolute positions the pairwise ``offsets`` chain to."""
    return np.cumsum([(0, 0)] + list(offsets), axis=0).astype(np.float64)


def _compose(fn, frames, offsets, cfg, **kw):
    """``compose`` by pairwise offsets, or ``compose_from_positions`` at
    the positions the offsets chain to."""
    if fn == "compose":
        return tcompose.compose(frames, offsets, cfg, **kw)
    return tcompose.compose_from_positions(frames, _positions(offsets), cfg,
                                           **kw)


@pytest.mark.parametrize("fn", ["compose", "compose_from_positions"])
def test_cpu_readback_unchanged(fn):
    """On the CPU the panorama comes back as before: the canvas the steps
    built, as a C-contiguous host uint8 array of its shape, bit-equal to
    the JAX composer's; no card readback is counted."""
    offsets = CASES["grid_corner"]
    frames = _color_frames(7, len(offsets) + 1)
    before = _readback_counters()
    got = _compose(fn, frames, offsets, StitchConfig(), device="cpu")
    dev = _compose(fn, frames, offsets, StitchConfig(), device="cpu",
                   return_device=True)
    ref = np.asarray(
        jcompose.compose(frames, offsets, JStitchConfig()) if fn == "compose"
        else jcompose.compose_from_positions(frames, _positions(offsets),
                                             JStitchConfig()))
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert got.flags.c_contiguous and got.shape == tuple(dev.shape)
    np.testing.assert_array_equal(got, dev.numpy())
    np.testing.assert_array_equal(got, ref)
    assert _readback_counters() == before


@pytest.mark.cuda
def test_card_readback_bits_and_page_locked():
    """A card's panorama comes back bit-equal to ``pano.cpu().numpy()``,
    with its dtype, shape and C-contiguous layout, in page-locked memory,
    from both composers, color and gray; none falls back to pageable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    offsets = CASES["grid_corner"]
    before = _readback_counters()
    for k, (fn, color) in enumerate([("compose", True), ("compose", False),
                                     ("compose_from_positions", True),
                                     ("compose_from_positions", False)]):
        frames = _color_frames(k, len(offsets) + 1)
        frames = torch.as_tensor(frames if color else frames[..., 1],
                                 device="cuda")
        cfg = StitchConfig(color_mode=color)
        pano = _compose(fn, frames, offsets, cfg, return_device=True)
        got = _compose(fn, frames, offsets, cfg)
        want = pano.cpu().numpy()
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)
        assert torch.from_numpy(got).is_pinned()
    after = _readback_counters()
    assert after["COMPOSE_READBACKS"] - before["COMPOSE_READBACKS"] == 4
    assert after["COMPOSE_READBACK_PAGEABLE"] == \
        before["COMPOSE_READBACK_PAGEABLE"]


@pytest.mark.cuda
def test_card_readback_owned_by_the_caller():
    """Two panoramas held at once lie in distinct blocks, and the second
    leaves the first unchanged; once the first and a view of it are gone,
    the next panorama of that shape lands in a block already made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    offsets = CASES["down"]
    cfg = StitchConfig()
    a_frames, b_frames = (torch.as_tensor(_color_frames(s, len(offsets) + 1),
                                          device="cuda") for s in (1, 2))
    first = tcompose.compose(a_frames, offsets, cfg)
    view = first[10:20, 5:50]
    kept = first.copy()
    second = tcompose.compose(b_frames, offsets, cfg)
    assert second.ctypes.data != first.ctypes.data
    assert not np.array_equal(second, kept)
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(view, kept[10:20, 5:50])
    del first, view
    before = _readback_counters()
    third = tcompose.compose(a_frames, offsets, cfg)
    after = _readback_counters()
    np.testing.assert_array_equal(third, kept)
    assert after["COMPOSE_READBACKS"] == before["COMPOSE_READBACKS"] + 1
    assert after["COMPOSE_READBACK_REUSED"] == \
        before["COMPOSE_READBACK_REUSED"] + 1
    assert after["COMPOSE_READBACK_PAGEABLE"] == \
        before["COMPOSE_READBACK_PAGEABLE"]
