"""The sharded canvas (imagestitch_tpu_torch/parallel/compose_sharded.py)
against the port's own ``compose`` and the JAX package's
``compose_sharded``, on tests/test_compose_sharded.py's tiles and offsets
(including the serpentine turn: a negative row step and a corner overlap
across block boundaries), in every mode the JAX composer allows: all eight
in gray, the six paddable ones in color.

Held: bit-equal to the port's ``compose`` on the same input (every fused
rect is gathered exactly and blended by the same code), so to the JAX
single-device composer wherever the port's is; within 1 level of JAX's
``compose_sharded``, the bound the JAX package's own tests hold its sharded
canvas to (XLA schedules the float32 blend differently under shard_map);
the same number of fuse psums as jax (one a fused image)."""
import numpy as np
import pytest
import torch

from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.parallel import compose_sharded as jcs
from imagestitch_tpu.parallel.mesh import make_mesh as jmake_mesh
from imagestitch_tpu_torch import StitchConfig, compose
from imagestitch_tpu_torch.parallel import compose_sharded as tcs
from imagestitch_tpu_torch.parallel import mesh as tmesh
from test_torch_jax_chain import two_threads

GRAY_MODES = ["notFuse", "average", "maximum", "minimum", "fadeInAndFadeOut",
              "trigonometric", "multiBandBlending", "optimalSeamLine"]
COLOR_MODES = GRAY_MODES[:6]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the shards lie on the card")
    return torch.device("cuda", 0)


def _tiles(rng, n, shape, step):
    """tests/test_compose_sharded.py's tiles: a step down and 2 columns
    right a frame, with a row jitter."""
    h, w = shape
    base = rng.integers(1, 255, (step * n + h + 50, w + 60), np.uint8)
    tl = [(step * i + (i % 3), 2 * i) for i in range(n)]
    tiles = np.stack([base[r:r + h, c:c + w] for r, c in tl])
    offsets = [(tl[i + 1][0] - tl[i][0], tl[i + 1][1] - tl[i][1])
               for i in range(n - 1)]
    return tiles, offsets


def _color(tiles):
    return np.stack([np.stack([t, t // 2, t // 3], axis=-1) for t in tiles])


def _hold(tiles, offsets, modes, d, color):
    mesh = tmesh.make_mesh(devices=["cpu"] * d)
    for mode in modes:
        kw = dict(color_mode=color, fuse_method=mode,
                  registration="phase_incre")
        cfg = StitchConfig(**kw)
        got = tcs.compose_sharded(tiles, offsets, cfg, mesh)
        psums = tcs.LAST_COMPOSE_STATS["fuse_psums"]
        np.testing.assert_array_equal(
            got, compose(tiles, offsets, cfg, device="cpu"), err_msg=mode)
        ref = np.asarray(jcs.compose_sharded(tiles, offsets,
                                             JStitchConfig(**kw),
                                             jmake_mesh(d, axis="blocks")))
        assert got.shape == ref.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref).max() <= 1, mode
        assert psums == jcs.LAST_COMPOSE_STATS["fuse_psums"], mode


def test_gray_modes_on_8_shards():
    tiles, offsets = _tiles(np.random.default_rng(0), 4, (96, 128), 64)
    _hold(tiles, offsets, GRAY_MODES, 8, False)


def test_color_modes_on_8_shards():
    tiles, offsets = _tiles(np.random.default_rng(1), 3, (80, 100), 50)
    _hold(_color(tiles), offsets, COLOR_MODES, 8, True)


def test_serpentine_turn_on_4_shards():
    """Negative rebasing and a corner overlap that crosses block rows."""
    tiles, _ = _tiles(np.random.default_rng(2), 3, (96, 128), 60)
    offsets = [(60, 2), (-5, 100)]
    _hold(tiles, offsets, GRAY_MODES, 4, False)
    _hold(_color(tiles), offsets, ["fadeInAndFadeOut", "trigonometric"], 4,
          True)


def test_stats_count_steps_psums_and_payload():
    tiles, offsets = _tiles(np.random.default_rng(3), 4, (96, 128), 64)
    cfg = StitchConfig(color_mode=False, registration="phase_incre")
    tmesh.reset_collectives()
    pano, rows = tcs.compose_sharded(tiles, offsets, cfg,
                                     tmesh.make_mesh(devices=["cpu"] * 4),
                                     return_device=True)
    assert isinstance(pano, torch.Tensor) and rows == pano.shape[0]
    s = tcs.LAST_COMPOSE_STATS
    # 3 fuse steps of (32 + jitter) x 122-126 int16 rects
    assert (s["dispatches"], s["fuse_psums"], s["n_images"],
            s["n_devices"]) == (4, 3, 4, 4)
    assert s["psum_payload_bytes"] == tmesh.COLLECTIVES["psum_bytes"] > 0
    assert tmesh.COLLECTIVES["psum"] == 3
    assert s["modeled_ici_bytes_per_device"] == int(
        s["psum_payload_bytes"] * 2 * 3 / 4)
    nf = StitchConfig(color_mode=False, fuse_method="notFuse",
                      registration="phase_incre")
    tcs.compose_sharded(tiles, offsets, nf,
                        tmesh.make_mesh(devices=["cpu"] * 4))
    assert tcs.LAST_COMPOSE_STATS["fuse_psums"] == 0


def test_color_gray_only_modes_raise_before_any_work():
    tiles, offsets = _tiles(np.random.default_rng(4), 3, (80, 100), 50)
    tmesh.reset_collectives()
    for mode in GRAY_MODES[6:]:
        cfg = StitchConfig(color_mode=True, fuse_method=mode,
                           registration="phase_incre")
        with pytest.raises(ValueError, match="gray"):
            tcs.compose_sharded(_color(tiles), offsets, cfg,
                                tmesh.make_mesh(devices=["cpu"] * 2))
    assert tmesh.COLLECTIVES["psum"] == 0
    with pytest.raises(ValueError, match="offsets"):
        tcs.compose_sharded(tiles, offsets[:1], StitchConfig(),
                            tmesh.make_mesh(devices=["cpu"] * 2))


@pytest.mark.cuda
def test_cuda_four_shards_equal_the_cards_compose(cuda_device):
    """Four shards on one card: every gray mode bit-equal to the card's
    ``compose``; the integer modes bit-equal to the CPU shards too."""
    tiles, offsets = _tiles(np.random.default_rng(5), 4, (96, 128), 64)
    card = tmesh.make_mesh(devices=["cuda:0"] * 4)
    for mode in GRAY_MODES:
        cfg = StitchConfig(color_mode=False, fuse_method=mode,
                           registration="phase_incre")
        got = tcs.compose_sharded(tiles, offsets, cfg, card)
        np.testing.assert_array_equal(
            got, compose(tiles, offsets, cfg, device=cuda_device),
            err_msg=mode)
        if mode in ("notFuse", "maximum", "minimum"):
            np.testing.assert_array_equal(got, tcs.compose_sharded(
                tiles, offsets, cfg, tmesh.make_mesh(devices=["cpu"] * 4)))
