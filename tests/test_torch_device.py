"""The port's entry points run on the card unless the caller asks for the
CPU: ``Stitcher`` with no device and the CLI with no ``--device`` raise on
a machine without CUDA instead of falling back to the CPU."""
import pytest
import torch

from imagestitch_tpu_torch import StitchConfig, Stitcher, cli


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_stitcher_without_device_needs_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Stitcher(StitchConfig())
    # an unported configuration still names its ROADMAP item (or list)
    # first; a ported option needs the card like any other
    with pytest.raises(NotImplementedError, match="item 22"):
        Stitcher(StitchConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Stitcher(StitchConfig(compute_dtype="bfloat16"))
    for ported in (dict(fuse_method="average"), dict(use_global_solver=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Stitcher(StitchConfig(**ported))
    assert Stitcher(StitchConfig(), device="cpu").device.type == "cpu"


def test_cli_without_device_needs_cuda(no_cuda, tmp_path):
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["stitch", str(tmp_path), str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_compose_numpy_frames_need_cuda_or_cpu(no_cuda):
    """``compose`` and ``compose_streamed`` take numpy frames to the card
    unless the caller passes ``device="cpu"``; with it, ``compose`` gives
    the JAX package's panorama."""
    import numpy as np

    from imagestitch_tpu.config import StitchConfig as JStitchConfig
    from imagestitch_tpu.core import compose as jcompose
    from imagestitch_tpu_torch import compose
    from imagestitch_tpu_torch.core import stream_out

    frames = np.random.default_rng(0).integers(0, 255, (3, 60, 80, 3),
                                               np.uint8)
    offsets = [(40, 3), (-2, 50)]
    cfg = StitchConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compose(frames, offsets, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_out.compose_streamed(frames, offsets, cfg)
    np.testing.assert_array_equal(
        compose(frames, offsets, cfg, device="cpu"),
        np.asarray(jcompose.compose(frames, offsets, JStitchConfig())))
