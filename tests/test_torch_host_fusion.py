"""The host float64 fusion of the port and its routing against the JAX
package: ``fuse_region_np`` and ``stream_out.compose_host`` in every mode
the host composers run (the JAX ``_PADDABLE_METHODS``), bit-equal on the
numpy route and on the C++ runtime's route (fade and trigonometric,
weight modes 0-3); the ``stream_output`` routing of the other modes (gray
multiband and seam through ``compose_streamed``, color raising); and the
CLI with ``--fuse-method optimalSeamLine --gray``, whose PNGs decode to
the JAX CLI's pixels."""
import os

import numpy as np
import pytest

from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu import cli as jcli
from imagestitch_tpu.core import stream_out as jstream
from imagestitch_tpu.io import prefetch as jprefetch
from imagestitch_tpu.ops.fusion import host_blend as jhost
from imagestitch_tpu_torch import StitchConfig, Stitcher, cli
from imagestitch_tpu_torch.core import compose as tcompose
from imagestitch_tpu_torch.core import stream_out as tstream
from imagestitch_tpu_torch.core.registration import PairRegistration
from imagestitch_tpu_torch.io import codec
from imagestitch_tpu_torch.io.dataset import ImageBatch
from imagestitch_tpu_torch.ops.fusion import host_blend as thost
from imagestitch_tpu_torch.utils import synthetic
from test_torch_fusion_modes import PADDABLE, _regions
from test_torch_jax_chain import route_pools_as_on_tpu, two_threads
from test_torch_stream_out import OFFSET_CASES, _route, _tiles

GRAY_ONLY = ("multiBandBlending", "optimalSeamLine")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def test_fuse_region_np_matches_jax():
    """Every mode, bit-equal to the JAX numpy route: both ramp
    orientations, plain and each corner quadrant, both offset signs, gray
    and color."""
    rng = np.random.default_rng(8)
    for method in PADDABLE:
        for color in (False, True):
            for rh, rw in ((40, 30), (30, 50)):
                for corner in (None, "ul", "ur", "ll", "lr"):
                    for sign in (1, -1):
                        a, b = _regions(rng, rh, rw, color, corner)
                        got = thost.fuse_region_np(a, b, 7 * sign, 5 * sign,
                                                   method, color)
                        ref = jhost.fuse_region_np(a, b, 7 * sign, 5 * sign,
                                                   method, color,
                                                   use_native=False)
                        assert got.dtype == np.uint8
                        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="host fusion"):
        thost.fuse_region_np(a, b, 1, 1, "multiBandBlending", False)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_compose_host_matches_jax(monkeypatch, route):
    """``compose_host`` in every mode it runs, gray and color, bit-equal
    to the JAX package's on the same route."""
    _route(monkeypatch, route)
    for seed, offsets in enumerate(OFFSET_CASES):
        for color in (False, True):
            frames = _tiles(seed, offsets, color)
            for method in PADDABLE:
                got = tstream.compose_host(frames, offsets,
                                           StitchConfig(fuse_method=method))
                ref = jstream.compose_host(frames, offsets,
                                           JStitchConfig(fuse_method=method))
                np.testing.assert_array_equal(got, ref)


def test_host_composer_rejects_gray_only_modes():
    frames = _tiles(0, OFFSET_CASES[0], False)
    for method in GRAY_ONLY:
        with pytest.raises(ValueError, match="host composer"):
            tstream.compose_host(frames, OFFSET_CASES[0],
                                 StitchConfig(fuse_method=method))


def _records(offsets):
    return [PairRegistration(True, o, tuple(map(float, o)), 1, 1, 9.0, 1)
            for o in offsets]


def _spy(monkeypatch):
    """Record which streamed composer each stitch takes."""
    calls = []
    for name in ("compose_host", "compose_color_host", "compose_streamed"):
        real = getattr(tstream, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(tstream, name, spy)
    return calls


@pytest.mark.parametrize("method", GRAY_ONLY)
def test_stream_output_routes_gray_only_modes(monkeypatch, method):
    """Gray multiband and seam with ``stream_output`` compose on the device
    with a rect-only readback, even with the runtime present, equal to
    ``compose``; color goes to ``compose``, which raises."""
    offsets = OFFSET_CASES[1]
    frames = _tiles(1, offsets, True)
    gray = np.ascontiguousarray(frames[..., 1])
    files = [f"f{i}" for i in range(len(frames))]
    cfg = StitchConfig(fuse_method=method, stream_output=True,
                       color_mode=False)
    recs = _records(offsets)
    want = tcompose.compose(gray, offsets, cfg, device="cpu")
    calls = _spy(monkeypatch)
    res = Stitcher(cfg, device="cpu").stitch_batch(
        ImageBatch(gray=gray, color=None, files=files), recs=recs)
    assert calls == ["compose_streamed"]
    np.testing.assert_array_equal(res[0].image, want)
    with pytest.raises(ValueError, match="gray frames only"):
        Stitcher(cfg.replace(color_mode=True), device="cpu").stitch_batch(
            ImageBatch(gray=gray, color=frames, files=files), recs=recs)
    assert calls == ["compose_streamed"]


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_stream_output_routes_trigonometric(monkeypatch, route):
    """A mode the host composers run: gray on the host in float64 with the
    runtime, else through the rect-only readback; color on the host on
    either route."""
    _route(monkeypatch, route)
    offsets = OFFSET_CASES[3]
    frames = _tiles(3, offsets, True)
    gray = np.ascontiguousarray(frames[..., 1])
    files = [f"f{i}" for i in range(len(frames))]
    cfg = StitchConfig(fuse_method="trigonometric", stream_output=True)
    want = {False: (tstream.compose_host(gray, offsets, cfg)
                    if route == "native" else
                    tcompose.compose(gray, offsets, cfg, device="cpu")),
            True: tstream.compose_color_host(frames, offsets, cfg)}
    calls = _spy(monkeypatch)
    for color, first in ((False, "compose_host" if route == "native"
                          else "compose_streamed"),
                         (True, "compose_color_host")):
        del calls[:]
        res = Stitcher(cfg.replace(color_mode=color), device="cpu"
                       ).stitch_batch(ImageBatch(
                           gray=gray, color=frames if color else None,
                           files=files), recs=_records(offsets))
        assert calls[0] == first
        np.testing.assert_array_equal(res[0].image, want[color])


def test_cli_optimal_seam_matches_jax_cli(tmp_path, monkeypatch):
    """``stitch --fuse-method optimalSeamLine --gray`` on a PNG project of
    gray blob frames (a 2 x 2 serpentine whose fusion rects halve to even
    sizes, and an unrelated frame): the same two files as the JAX CLI's,
    decoding to its pixels."""
    positions = synthetic.serpentine_positions(2, 2, (192.37, 224.21))
    frames = np.concatenate([
        synthetic.sequence(11, (256, 320), positions)[0],
        synthetic.sequence(99, (256, 320), [(0.5, 0.5)])[0]])
    d = tmp_path / "proj" / "1"
    d.mkdir(parents=True)
    for i, f in enumerate(frames):
        codec.imwrite(str(d / f"tile_{i:02d}.png"), f)
    args = ["--file-extension", "png", "--output-extension", "png",
            "--max-keypoints", "256", "--quiet", "--gray",
            "--fuse-method", "optimalSeamLine"]
    proj = str(tmp_path / "proj")
    assert cli.main(["stitch", proj, str(tmp_path / "t"), "--device", "cpu"]
                    + args) == 0
    route_pools_as_on_tpu(monkeypatch)
    monkeypatch.setattr(jprefetch, "_warm_pool_programs_async",
                        lambda *a, **k: None)
    assert jcli.main(["stitch", proj, str(tmp_path / "j")] + args) == 0
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "stitching_result_1_1.png", "stitching_result_1_2.png"]
    for name in names:
        got = codec.imread(str(tmp_path / "t" / name), False)
        assert got.ndim == 2
        np.testing.assert_array_equal(
            got, codec.imread(str(tmp_path / "j" / name), False))
