"""The port's user-facing entry points against the JAX package:
registration checkpoints (the same JSON, loadable by either package),
``Stitcher.stitch_project_set``'s output names, the routing of
``stream_output``, and the CLI on a tiny PNG project, whose written
panoramas must decode to the JAX CLI's pixels (the JAX pools routed as on a
TPU, test_torch_jax_chain.py)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from imagestitch_tpu import cli as jcli
from imagestitch_tpu.core import checkpoint as jckpt
from imagestitch_tpu.core.registration import PairRegistration as JPair
from imagestitch_tpu.io import native_loader as jnative
from imagestitch_tpu.io import prefetch as jprefetch
from imagestitch_tpu_torch import FeatureConfig, StitchConfig, Stitcher, cli
from imagestitch_tpu_torch.core import checkpoint, compose, stream_out
from imagestitch_tpu_torch.core.registration import PairRegistration
from imagestitch_tpu_torch.io import codec, native_loader
from imagestitch_tpu_torch.io.dataset import ImageBatch
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import route_pools_as_on_tpu, two_threads

H, W = 320, 400


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def color():
    """A 2x2 color serpentine plus an unrelated color frame."""
    positions = synthetic.serpentine_positions(2, 2, (270.37, 330.21))
    return np.concatenate([
        synthetic.color_sequence(0, (H, W), positions)[0],
        synthetic.color_sequence(99, (H, W), [(0.5, 0.5)])[0]])


def _project(root, frames):
    d = root / "proj" / "1"
    d.mkdir(parents=True)
    for i, f in enumerate(frames):
        codec.imwrite(str(d / f"tile_{i:02d}.png"), f)
    return str(root / "proj")


def _gray_cfg(**kw):
    return StitchConfig(registration="feature_incre", direction=1,
                        direct_incre=1, roi_ratio=0.2, color_mode=False,
                        features=FeatureConfig(upright=True,
                                               max_keypoints=256)).replace(**kw)


RECS = [PairRegistration(True, (250, 3), (250.4, 3.7), 1, 1, 12.0, 1),
        PairRegistration(False, (0, 0), (0.0, 0.0), 0, 0, 2.0, 12)]


def test_checkpoint_interop_both_ways(tmp_path):
    files = ["a.png", "b.png", "c.png"]
    checkpoint.save_registration(str(tmp_path / "t.json"), files, RECS)
    got = jckpt.load_registration(str(tmp_path / "t.json"), files)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in RECS]
    jckpt.save_registration(str(tmp_path / "j.json"), files,
                            [JPair(**dataclasses.asdict(r)) for r in RECS])
    assert checkpoint.load_registration(str(tmp_path / "j.json"),
                                        files) == RECS
    assert checkpoint.load_registration(str(tmp_path / "j.json"),
                                        files[:2]) is None
    assert checkpoint.load_registration(str(tmp_path / "none.json")) is None


def test_checkpoint_skips_registration(color, tmp_path, monkeypatch):
    gray = color[:4, ..., 1]
    batch = ImageBatch(gray=gray, color=None, files=[f"f{i}" for i in
                                                     range(4)])
    first = Stitcher(_gray_cfg(), checkpoint_dir=str(tmp_path),
                     device="cpu").stitch_batch(batch)
    assert len(os.listdir(tmp_path)) == 1

    def no_register(self, gray):
        raise AssertionError("registered again")
    monkeypatch.setattr(Stitcher, "register", no_register)
    again = Stitcher(_gray_cfg(), checkpoint_dir=str(tmp_path),
                     device="cpu").stitch_batch(batch)
    assert again[0].offsets == first[0].offsets
    np.testing.assert_array_equal(again[0].image, first[0].image)


@pytest.mark.parametrize("n, names", [
    (4, ["stitching_result_1.png"]),
    (5, ["stitching_result_1_1.png", "stitching_result_1_2.png"])])
def test_stitch_project_set_names(color, tmp_path, capsys, n, names):
    proj = _project(tmp_path, color[:n])
    out = str(tmp_path / "out")
    written = Stitcher(_gray_cfg(print_log=True),
                       device="cpu").stitch_project_set(
        proj, out, 2, file_extension="png", output_extension="png")
    assert written == [os.path.join(out, f) for f in names]
    assert sorted(os.listdir(out)) == names
    log = capsys.readouterr().out
    assert f"Time consuming for {proj}/1: " in log
    assert "no *.png files under" in log          # sub-project 2 is absent


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_stream_output_routes(color, monkeypatch, route):
    """Gray ``stream_output`` composes on the host in float64 with the
    runtime, else on the device with a rect-only readback; color composes
    on the host in float64 on either route."""
    if route == "numpy":
        monkeypatch.setattr(native_loader, "get_lib", lambda: None)
    elif native_loader.get_lib() is None:
        pytest.skip("the C++ runtime does not build here")
    gray = color[:4, ..., 1]
    files = [f"f{i}" for i in range(4)]
    res = Stitcher(_gray_cfg(stream_output=True), device="cpu").stitch_batch(
        ImageBatch(gray=gray, color=None, files=files))
    offs = res[0].offsets
    want = (stream_out.compose_host(gray, offs, _gray_cfg())
            if route == "native"
            else compose.compose(gray, offs, _gray_cfg(), device="cpu"))
    np.testing.assert_array_equal(res[0].image, want)
    cfg = _gray_cfg(stream_output=True, color_mode=True)
    res = Stitcher(cfg, device="cpu").stitch_batch(
        ImageBatch(gray=gray, color=color[:4], files=files))
    np.testing.assert_array_equal(
        res[0].image, stream_out.compose_color_host(color[:4], offs, cfg))


def test_default_configurations_construct():
    Stitcher(StitchConfig(), device="cpu")
    Stitcher(StitchConfig(stream_output=True), device="cpu")
    Stitcher(StitchConfig(color_mode=False, stream_output=True), device="cpu")
    # every --fuse-method choice reaches a Stitcher that constructs
    for method in ("notFuse", "average", "maximum", "minimum",
                   "fadeInAndFadeOut", "trigonometric", "multiBandBlending",
                   "optimalSeamLine"):
        args = cli.build_parser().parse_args(["stitch", "p", "o",
                                              "--fuse-method", method])
        st = Stitcher(cli.config_from_args(args), device="cpu")
        assert st.cfg.fuse_method == method
    # the global solver and the other feature families construct too, from
    # the CLI's flags
    for flags, field, want in (
            (["--use-solver"], "use_global_solver", True),
            (["--feature-method", "sift"], "method", "sift"),
            (["--feature-method", "orb"], "method", "orb"),
            (["--box-filter"], "box_filter", True)):
        args = cli.build_parser().parse_args(["stitch", "p", "o"] + flags)
        st = Stitcher(cli.config_from_args(args), device="cpu")
        holder = st.cfg if field == "use_global_solver" else st.cfg.features
        assert getattr(holder, field) == want


def test_cli_device_cuda_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        cli.main(["stitch", str(tmp_path), str(tmp_path / "out"),
                  "--device", "cuda"])


@pytest.mark.parametrize("gray", [False, True])
def test_cli_matches_jax_cli(color, tmp_path, monkeypatch, gray):
    """``stitch`` with the CLI's defaults (color unless --gray, the default
    FeatureConfig with its oriented fallback) on a 5-frame PNG project:
    the same files, decoding to the JAX CLI's pixels."""
    if not gray and jnative.get_lib() is None:
        pytest.skip("without its runtime the JAX package makes the gray of "
                    "a color frame with a float rule")
    proj = _project(tmp_path, color)
    args = ["--file-extension", "png", "--output-extension", "png",
            "--max-keypoints", "256", "--quiet"] + (["--gray"] if gray else [])
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
        got = codec.imread(str(tmp_path / "t" / name), not gray)
        ref = codec.imread(str(tmp_path / "j" / name), not gray)
        assert got.ndim == (2 if gray else 3)
        np.testing.assert_array_equal(got, ref)
