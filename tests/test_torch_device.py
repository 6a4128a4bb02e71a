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
    # an unported configuration still names its ROADMAP item first
    with pytest.raises(NotImplementedError, match="item 18"):
        Stitcher(StitchConfig(fuse_method="average"))
    assert Stitcher(StitchConfig(), device="cpu").device.type == "cpu"


def test_cli_without_device_needs_cuda(no_cuda, tmp_path):
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["stitch", str(tmp_path), str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
