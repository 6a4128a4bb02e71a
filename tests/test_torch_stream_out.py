"""Streamed output of the port against the JAX package: the host float64
composers (``compose_host`` / ``compose_color_host``) bit-equal to the JAX
ones on the C++ runtime's route and on the numpy route (``get_lib``
patched to None in both packages), the rect-only readback
(``compose_streamed``) bit-equal to the port's own compose, and host
against device within one level on a small fraction of pixels (the JAX
package's bound, tests/test_stream_out.py:73-77)."""
import numpy as np
import pytest
import torch

from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import compose as jcompose
from imagestitch_tpu.core import stream_out as jstream
from imagestitch_tpu.io import native_loader as jnative
from imagestitch_tpu_torch import StitchConfig
from imagestitch_tpu_torch.core import compose as tcompose
from imagestitch_tpu_torch.core import stream_out as tstream
from imagestitch_tpu_torch.io import native_loader as tnative
from test_torch_jax_chain import two_threads

SHAPE = (120, 160)
OFFSET_CASES = [
    [(80, 3), (80, -2)],                         # linear strip
    [(100, 1), (-10, 120), (-95, -2)],           # serpentine row transition
    [(-50, 10), (30, -40)],                      # negative rebase both axes
    [(30, 40), (40, -30), (-30, 35)],            # corner overlaps
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _tiles(seed, offsets, color):
    """Tiles cut from one base image, so that overlaps agree."""
    p = tcompose.compute_placement(offsets, SHAPE)
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 255, p.canvas_shape + ((3,) if color else ()),
                        np.uint8)
    h, w = SHAPE
    return np.stack([base[r:r + h, c:c + w] for r, c in p.positions])


def _route(monkeypatch, route):
    if route == "numpy":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    elif tnative.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("the C++ runtime does not build here (g++ and libjpeg "
                    "headers are needed)")


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_compose_host_matches_jax(monkeypatch, route, color):
    _route(monkeypatch, route)
    t_fn = tstream.compose_color_host if color else tstream.compose_host
    j_fn = jstream.compose_color_host if color else jstream.compose_host
    for k, offsets in enumerate(OFFSET_CASES):
        tiles = _tiles(k, offsets, color)
        got = t_fn(tiles, offsets, StitchConfig(color_mode=color))
        ref = j_fn(tiles, offsets, JStitchConfig(color_mode=color))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("color", [False, True])
def test_compose_streamed_equals_compose(color):
    cfg = StitchConfig(color_mode=color)
    for k, offsets in enumerate(OFFSET_CASES):
        tiles = _tiles(10 + k, offsets, color)
        full = tcompose.compose(tiles, offsets, cfg, device="cpu")
        np.testing.assert_array_equal(
            tstream.compose_streamed(tiles, offsets, cfg, device="cpu"),
            full)
        np.testing.assert_array_equal(
            tstream.compose_streamed(tiles, offsets, cfg,
                                     frames_dev=torch.as_tensor(tiles)), full)


def test_host_matches_device_within_one_level():
    """float64 host blend against the device composer's single-rounded
    float32 blend."""
    for color in (False, True):
        cfg = StitchConfig(color_mode=color)
        for k, offsets in enumerate(OFFSET_CASES):
            tiles = _tiles(20 + k, offsets, color)
            host = tstream.compose_host(tiles, offsets, cfg).astype(np.int32)
            dev = tcompose.compose(tiles, offsets, cfg,
                                   device="cpu").astype(np.int32)
            diff = np.abs(host - dev)
            assert diff.max() <= 1 and (diff != 0).mean() < 5e-2


def test_visible_rect_pieces_match_jax():
    for offsets in OFFSET_CASES + [[(0, 100), (80, -100), (0, 100)]]:
        _, steps, _ = tcompose.plan_compose(offsets, SHAPE, StitchConfig())
        _, jsteps, _ = jcompose.plan_compose(offsets, SHAPE, JStitchConfig())
        assert tstream.visible_rect_pieces(steps, SHAPE) == \
            jstream.visible_rect_pieces(jsteps, SHAPE)


def test_streamed_single_image():
    tiles = np.random.default_rng(5).integers(1, 255, (1, 60, 80, 3),
                                              np.uint8)
    np.testing.assert_array_equal(
        tstream.compose_streamed(tiles, [], StitchConfig(), device="cpu"),
        tiles[0])
    np.testing.assert_array_equal(
        tstream.compose_color_host(tiles, [], StitchConfig()), tiles[0])
    with pytest.raises(ValueError, match="uint8"):     # runtime takes u8*
        tstream.compose_host(tiles.astype(np.int16), [], StitchConfig())
