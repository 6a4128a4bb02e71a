"""File ingest of the port against the JAX package: the gray frames made
from color files (cv2's fixed-point rule), JPEG decode through the shared
C++ runtime, the chunk prefetcher and the pipelined loaders.

Tests of the runtime's route skip when either package's runtime does not
load (no g++ or no libjpeg headers); the numpy route always runs."""
import numpy as np
import pytest
import torch

from imagestitch_tpu.io import codec as jcodec
from imagestitch_tpu.io import dataset as jdataset
from imagestitch_tpu.io import native_loader as jnative
from imagestitch_tpu_torch import FeatureConfig, StitchConfig
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.io import codec, dataset, native_loader, prefetch
from imagestitch_tpu_torch.utils import profiling, synthetic
from test_torch_jax_chain import two_threads

H, W = 320, 400


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def frames():
    """A 2x2 serpentine and an unrelated frame, gray and color."""
    positions = synthetic.serpentine_positions(2, 2, (270.37, 330.21))
    gray = np.concatenate([synthetic.sequence(0, (H, W), positions)[0],
                           synthetic.sequence(99, (H, W), [(0.5, 0.5)])[0]])
    color = np.concatenate([
        synthetic.color_sequence(0, (H, W), positions)[0],
        synthetic.color_sequence(99, (H, W), [(0.5, 0.5)])[0]])
    return gray, color


def _write(tmp_path, frames, ext):
    files = [str(tmp_path / f"t{i:02d}.{ext}") for i in range(len(frames))]
    for f, im in zip(files, frames):
        codec.imwrite(f, im)
    return files


def _fixed_point_gray(bgr):
    x = bgr.astype(np.int64)
    return ((1868 * x[..., 0] + 9617 * x[..., 1] + 4899 * x[..., 2] + 8192)
            >> 14).astype(np.uint8)


def _needs_both_runtimes():
    if native_loader.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("the C++ runtime does not build here (g++ and libjpeg "
                    "headers are needed)")


def test_gray_from_color_is_cv2_fixed_point(tmp_path, monkeypatch):
    """A PNG of BGR triples on which cv2's 14-bit fixed-point gray and a
    rounded float32 weighted sum differ by one level: the port's gray of a
    color file is the fixed-point one on the runtime's route and on the
    numpy route, and equals the JAX package's (runtime present)."""
    rng = np.random.default_rng(3)
    bgr = rng.integers(0, 256, (400_000, 3), dtype=np.uint8)
    float_rule = jcodec.to_gray(bgr[None])[0]
    differ = bgr[float_rule != _fixed_point_gray(bgr)]
    assert len(differ) >= 384
    img = differ[:384].reshape(16, 24, 3)
    f = str(tmp_path / "triples.png")
    codec.imwrite(f, img)
    want = _fixed_point_gray(img)
    assert (want != jcodec.to_gray(img)).all()
    got = dataset.load_batch([f], True)
    np.testing.assert_array_equal(got.color[0], img)
    np.testing.assert_array_equal(got.gray[0], want)
    if jnative.get_lib() is not None:
        np.testing.assert_array_equal(
            got.gray, jdataset.load_batch([f], True).gray)
    monkeypatch.setattr(native_loader, "get_lib", lambda: None)
    np.testing.assert_array_equal(dataset.load_batch([f], True).gray[0], want)


@pytest.mark.parametrize("color", [False, True])
def test_jpeg_decode_matches_jax(frames, tmp_path, color):
    """The runtime's libjpeg batch decoder, the port's build against the
    JAX package's, bit for bit; and the batches load_batch makes."""
    _needs_both_runtimes()
    files = _write(tmp_path, frames[1][:3], "jpg")
    got = native_loader.NativeLoader(threads=2).read_all(files, color)
    ref = jnative.NativeLoader(threads=2).read_all(files, color)
    assert [g.shape for g in got] == [(H, W, 3) if color else (H, W)] * 3
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    assert native_loader.probe_dims(files[0]) == jnative.probe_dims(
        files[0]) == (H, W)
    tb, jb = dataset.load_batch(files, color), jdataset.load_batch(files,
                                                                  color)
    np.testing.assert_array_equal(tb.gray, jb.gray)
    assert (tb.color is None) == (jb.color is None) == (not color)


def test_chunk_prefetcher_covers_every_file_in_order(frames, tmp_path):
    files = _write(tmp_path, frames[0], "png")
    chunks = list(prefetch.ChunkPrefetcher(files, chunk_frames=2))
    assert [c.files for c in chunks] == [files[0:2], files[2:4], files[4:5]]
    np.testing.assert_array_equal(np.concatenate([c.gray for c in chunks]),
                                  frames[0])
    assert native_loader.probe_dims(files[0]) == (H, W)


@pytest.mark.parametrize("color,to_device,host_color", [
    (False, True, False), (True, True, False), (True, False, False),
    (True, True, True)], ids=["gray", "color", "color-host", "host-color"])
def test_load_batch_pipelined_matches_load_batch(frames, tmp_path, color,
                                                 to_device, host_color):
    """The batch equals ``load_batch``'s.  Color bound for a device comes
    back as tensors, the gray made from the uploaded color (counted in
    ``INGEST_GRAY_CARD``), or with ``host_color`` the color as numpy;
    without ``to_device`` both stay numpy, the gray made on the host."""
    files = _write(tmp_path, frames[1] if color else frames[0], "png")
    before = (profiling.INGEST_GRAY_FRAMES, profiling.INGEST_GRAY_CARD)
    got = prefetch.load_batch_pipelined(files, color, to_device,
                                        chunk_frames=2,
                                        host_color=host_color, device="cpu")
    counted = (profiling.INGEST_GRAY_FRAMES - before[0],
               profiling.INGEST_GRAY_CARD - before[1])
    ref = dataset.load_batch(files, color)
    assert got.files == files
    assert isinstance(got.gray, torch.Tensor if to_device else np.ndarray)
    np.testing.assert_array_equal(np.asarray(got.gray), ref.gray)
    if color:
        on_device = to_device and not host_color
        assert isinstance(got.color,
                          torch.Tensor if on_device else np.ndarray)
        np.testing.assert_array_equal(np.asarray(got.color), ref.color)
        assert counted == (len(files), len(files) if to_device else 0)
    else:
        assert got.color is None
        assert counted == (0, 0)


def _cfg():
    return StitchConfig(registration="feature_incre", direction=1,
                        direct_incre=1, roi_ratio=0.2, color_mode=False,
                        features=FeatureConfig(max_keypoints=256))


def test_register_sequence_pipelined_matches_serial(frames, tmp_path):
    """Chunks of 2 over 5 frames: the chunk pools concatenate to the
    batch's pool, so the records (the fallback of the unrelated pair
    included) equal register_sequence_features_incre's."""
    files = _write(tmp_path, frames[0], "png")
    recs, gray_dev, gray_host = prefetch.register_sequence_pipelined(
        files, _cfg(), chunk_frames=2, keep_host=True, device="cpu")
    ref = tfr.register_sequence_features_incre(frames[0], _cfg(),
                                               device="cpu")
    assert recs == ref
    assert [r.ok for r in recs] == [True, True, True, False]
    np.testing.assert_array_equal(gray_dev.numpy(), frames[0])
    np.testing.assert_array_equal(gray_host, frames[0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_pipelined_ingest_matches_serial(frames, tmp_path, cuda_device):
    """2-frame chunks sent through the card's staging ring give the serial
    run's frames and records; each chunk of each loader is one chunk of
    the ring."""
    files = _write(tmp_path, frames[0], "png")
    chunks = -(-len(files) // 2)
    before = profiling.UPLOAD_CHUNKS
    recs, gray_dev, _ = prefetch.register_sequence_pipelined(
        files, _cfg(), chunk_frames=2, device=cuda_device)
    assert profiling.UPLOAD_CHUNKS - before == chunks
    assert gray_dev.device.type == "cuda"
    np.testing.assert_array_equal(gray_dev.cpu().numpy(), frames[0])
    ref = tfr.register_sequence_features_incre(frames[0], _cfg(),
                                               device=cuda_device)
    assert recs == ref
    before = profiling.UPLOAD_CHUNKS
    batch = prefetch.load_batch_pipelined(files, False, chunk_frames=2,
                                          device=cuda_device)
    assert profiling.UPLOAD_CHUNKS - before == chunks
    assert torch.equal(batch.gray, gray_dev)
