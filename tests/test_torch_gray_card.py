"""The gray of color files made where the color frames go
(``io/dataset.bgr_to_gray_tensor``): the host rule's bits on every BGR
triple, on the CPU and on the card, and the streamed-output color route,
which still composes host frames."""
import numpy as np
import pytest
import torch

from imagestitch_tpu_torch import FeatureConfig, StitchConfig, Stitcher
from imagestitch_tpu_torch.core import stream_out
from imagestitch_tpu_torch.io import codec, dataset
from imagestitch_tpu_torch.utils import profiling, synthetic

H, W = 320, 400


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Test workers share the machine's cores; PyTorch's default of one
    thread per core each makes them stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_gray_rule_matches_host_on_every_triple(device):
    """All 2^24 BGR triples, as 256 frames of 256 x 256 (one blue level a
    frame): the tensor rule equals ``bgr_to_gray`` bit for bit."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    levels = np.arange(256, dtype=np.uint8)
    triples = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                       axis=-1)
    want = dataset.bgr_to_gray(triples.reshape(4096, 4096, 3))
    got = dataset.bgr_to_gray_tensor(torch.from_numpy(triples).to(device))
    assert got.dtype == torch.uint8 and got.device.type == device
    np.testing.assert_array_equal(got.cpu().numpy().reshape(4096, 4096),
                                  want)


def test_color_stream_output_composes_host_frames(tmp_path, monkeypatch):
    """``stitch_files`` in color with ``stream_output`` makes the gray on
    the device and still hands the host composer the decoded color frames
    as numpy."""
    positions = synthetic.serpentine_positions(2, 2, (270.37, 330.21))
    color = synthetic.color_sequence(0, (H, W), positions)[0]
    files = [str(tmp_path / f"{k:02d}.png") for k in range(len(color))]
    for f, im in zip(files, color):
        codec.imwrite(f, im)
    calls = []
    real = stream_out.compose_color_host

    def compose_color_host(frames, offsets, cfg):
        calls.append(frames)
        return real(frames, offsets, cfg)

    monkeypatch.setattr(stream_out, "compose_color_host", compose_color_host)
    cfg = StitchConfig(registration="feature_incre", direction=1,
                       direct_incre=1, roi_ratio=0.2, color_mode=True,
                       stream_output=True,
                       features=FeatureConfig(max_keypoints=256))
    before = profiling.INGEST_GRAY_CARD
    res = Stitcher(cfg, device="cpu").stitch_files(files)
    assert profiling.INGEST_GRAY_CARD - before == len(files)
    assert [r.file_range for r in res] == [(0, 4)]
    (frames,) = calls
    assert isinstance(frames, np.ndarray)
    np.testing.assert_array_equal(frames, color)
    np.testing.assert_array_equal(
        res[0].image, real(color, res[0].offsets, cfg))
