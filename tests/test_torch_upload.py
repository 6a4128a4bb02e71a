"""Host frames to the card through the page-locked staging ring
(``device.to_device``, ``device.StagingRing``).

On the CPU: the chunk plan covers every element of gray and color
batches once, in C order, also for a view that is not contiguous and a
frame smaller than one chunk, and the fill of a block writes them in that
order; a CPU target and a tensor already where it is sent pass through;
the pipelined loaders' chunks and the registrars' numpy frames take that
route.
On the card (``cuda``): the bytes equal a pageable ``.to("cuda")`` when a
kernel reads them with no host sync and the host overwrites its array at
once; a second upload reuses the ring and locks no block; a failure to
lock takes the pageable copy and counts it; and two batches of one shape,
in one host buffer one after the other, each reach the card whole."""
import numpy as np
import pytest
import torch

from imagestitch_tpu_torch import FeatureConfig, StitchConfig, Stitcher, device
from imagestitch_tpu_torch.core import compose as tcompose
from imagestitch_tpu_torch.core import registration as treg
from imagestitch_tpu_torch.core.registration import PairRegistration
from imagestitch_tpu_torch.io import codec, prefetch
from imagestitch_tpu_torch.io.dataset import ImageBatch
from imagestitch_tpu_torch.utils import profiling, synthetic

UPLOAD = ("UPLOAD_CHUNKS", "UPLOAD_CHUNKS_REUSED", "UPLOAD_PAGEABLE")


def _counters():
    return {k: getattr(profiling, k) for k in UPLOAD}


def _delta(before):
    return {k: getattr(profiling, k) - before[k] for k in UPLOAD}


def _indexed(shape):
    """A tensor of ``shape`` whose every element holds its C-order index."""
    return torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape)


# (source, chunk in elements): none a multiple of its chunk
PLANS = {
    "gray": (lambda: _indexed((3, 37, 53)), 1000),
    "color": (lambda: _indexed((2, 29, 31, 3)), 1000),
    "frame_below_one_chunk": (lambda: _indexed((1, 5, 7, 3)), 4096),
    "strided_view": (lambda: _indexed((5, 30, 40, 3))[::2, 3:, 5:37], 700),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_chunk_plan_covers_every_element_once(case):
    """Every chunk but the last is full, each is made of views of the
    source (no copy), and the chunks' elements, filled into a block, are
    the source's in C order, each once."""
    make, chunk = PLANS[case]
    src = make()
    want = src.contiguous().reshape(-1)
    chunks = list(device.chunk_views(src, chunk))
    assert len(chunks) == -(-src.numel() // chunk)
    block = torch.full((chunk,), -1, dtype=src.dtype)
    a = 0
    for k, views in enumerate(chunks):
        for v in views:
            assert v.untyped_storage().data_ptr() == \
                src.untyped_storage().data_ptr()
        n = device.fill(block, views)
        assert n == (chunk if k < len(chunks) - 1 else src.numel() - a)
        assert torch.equal(block[:n], want[a:a + n])
        a += n
    assert a == src.numel()


def test_cpu_target_and_a_tensor_in_place_pass_through():
    """Sent to the CPU, a host array is wrapped without a copy and a CPU
    tensor is returned as it is, also to the Stitcher's device; no upload
    is counted."""
    x = np.random.default_rng(3).integers(0, 256, (2, 9, 11, 3),
                                          dtype=np.uint8)
    t = torch.from_numpy(x.copy())
    before = _counters()
    got = device.to_device(x, "cpu")
    assert got.data_ptr() == x.ctypes.data and torch.equal(
        got, torch.from_numpy(x))
    assert device.to_device(t, "cpu") is t
    st = Stitcher(StitchConfig(), device="cpu")
    assert device.to_device(t, st.device) is t
    assert torch.equal(device.to_device(x, st.device), t)
    assert _delta(before) == dict.fromkeys(UPLOAD, 0)


def test_loaders_and_registrars_send_host_frames_through_to_device(
        tmp_path, monkeypatch):
    """Each chunk of both pipelined loaders, under the ``ingest.upload``
    span, and the numpy frames a registrar is given, go to their device
    by ``device.to_device``; a tensor stays where it lies."""
    gray = synthetic.sequence(4, (96, 128), [(0.0, 0.0), (0.0, 60.5),
                                             (0.0, 121.0)])[0]
    files = [str(tmp_path / f"{k}.png") for k in range(len(gray))]
    for f, im in zip(files, gray):
        codec.imwrite(f, im)
    sent, real = [], device.to_device

    def spy(x, dev):
        sent.append((type(x), tuple(x.shape), torch.device(dev)))
        return real(x, dev)

    monkeypatch.setattr(device, "to_device", spy)
    chunks = [(np.ndarray, (2, 96, 128), torch.device("cpu")),
              (np.ndarray, (1, 96, 128), torch.device("cpu"))]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ns = profiling.INGEST_UPLOAD_NS
        batch = prefetch.load_batch_pipelined(files, False, chunk_frames=2,
                                              device="cpu")
        assert sent == chunks and profiling.INGEST_UPLOAD_NS > ns
        np.testing.assert_array_equal(batch.gray.numpy(), gray)
        sent.clear()
        cfg = StitchConfig(features=FeatureConfig(max_keypoints=64))
        _, gray_dev, _ = prefetch.pooled_features_pipelined(
            files, cfg, chunk_frames=2, device="cpu")
        assert sent == chunks
        np.testing.assert_array_equal(gray_dev.numpy(), gray)
    finally:
        torch.set_num_threads(n)
    sent.clear()
    got = treg._as_images(gray, "cpu", "test")
    assert sent == [(np.ndarray, gray.shape, torch.device("cpu"))]
    assert treg._as_images(got, "cpu", "test") is got and len(sent) == 1
    np.testing.assert_array_equal(got.numpy(), gray)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
def test_card_bytes_equal_without_a_host_sync():
    """Gray, color and strided batches, through the shared ring and a
    ring of 1 MB blocks (many chunks, each block used again within the
    call): the card's tensor equals ``torch.as_tensor(x).to("cuda")``
    when a kernel on the current stream reads it before any host sync,
    and after the host has overwritten its array.  A tensor on the card
    passes through."""
    _need_card()
    rng = np.random.default_rng(11)
    small = device.StagingRing("cuda", block_bytes=1 << 20, blocks=2)
    gray = rng.integers(0, 256, (5, 1936, 2584), dtype=np.uint8)
    color = rng.integers(0, 256, (3, 1000, 1500, 3), dtype=np.uint8)
    for base, view in ((gray, lambda a: a), (color, lambda a: a),
                       (color, lambda a: a[:, 7:, ::2])):
        for send in (lambda h: device.to_device(h, "cuda"),
                     lambda h: small.upload(torch.as_tensor(h))):
            parent = base.copy()
            host = view(parent)
            want = torch.as_tensor(np.array(host)).to("cuda")
            got = send(host)
            sums = got.to(torch.int64).sum(dim=0)        # no sync before
            parent[...] = 0
            assert got.shape == want.shape and got.dtype == want.dtype
            assert torch.equal(sums, want.to(torch.int64).sum(dim=0))
            assert torch.equal(got, want)
    on_card = torch.zeros(4, device="cuda")
    assert device.to_device(on_card, "cuda") is on_card


@pytest.mark.cuda
def test_card_second_upload_reuses_the_ring():
    """A ring of three 1 MB blocks: the second upload of a 5.5 MB batch
    sends all its chunks through blocks the first had used, locks no new
    block, and takes no pageable copy."""
    _need_card()
    ring = device.StagingRing("cuda", block_bytes=1 << 20, blocks=3)
    x = np.random.default_rng(5).integers(0, 256, (2, 1000, 2750),
                                          dtype=np.uint8)
    chunks = -(-x.nbytes // (1 << 20))
    first = _counters()
    ring.upload(torch.from_numpy(x))
    assert _delta(first) == {"UPLOAD_CHUNKS": chunks,
                             "UPLOAD_CHUNKS_REUSED": chunks - 3,
                             "UPLOAD_PAGEABLE": 0}
    blocks = [b.data_ptr() for b in ring.blocks]
    stats = getattr(torch.cuda, "host_memory_stats", None)
    allocs = stats()["num_host_alloc"] if stats else None
    second = _counters()
    got = ring.upload(torch.from_numpy(x))
    assert _delta(second) == {"UPLOAD_CHUNKS": chunks,
                              "UPLOAD_CHUNKS_REUSED": chunks,
                              "UPLOAD_PAGEABLE": 0}
    assert [b.data_ptr() for b in ring.blocks] == blocks
    if stats:
        assert stats()["num_host_alloc"] == allocs
    assert torch.equal(got.cpu(), torch.from_numpy(x))


@pytest.mark.cuda
def test_card_pinning_failure_goes_pageable(monkeypatch):
    """Where no block can be locked, the batch goes up from pageable
    memory, whole and equal, and the fallback is counted."""
    _need_card()
    empty = torch.empty

    def refuse_to_lock(*args, pin_memory=False, **kwargs):
        if pin_memory:
            raise RuntimeError("cannot lock host memory")
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", refuse_to_lock)
    ring = device.StagingRing("cuda")
    x = np.random.default_rng(2).integers(0, 256, (3, 700, 900, 3),
                                          dtype=np.uint8)
    before = _counters()
    got = ring.upload(torch.from_numpy(x))
    assert _delta(before) == {"UPLOAD_CHUNKS": 0, "UPLOAD_CHUNKS_REUSED": 0,
                              "UPLOAD_PAGEABLE": 1}
    assert ring.blocks == []
    assert torch.equal(got.cpu(), torch.from_numpy(x))


@pytest.mark.cuda
def test_card_two_batches_in_one_buffer_each_stitched_whole():
    """Two color batches of one shape, stitched one after the other from
    the same host buffer (the second written over the first): each
    panorama equals the compose of that batch sent by a pageable copy.
    No upload is skipped on the identity of a host array."""
    _need_card()
    n, h, w = 4, 1200, 1600
    offsets = [(0, 1200), (900, 0), (0, -1200)]
    recs = [PairRegistration(True, o, tuple(map(float, o)), 1, 1, 1.0, 1)
            for o in offsets]
    batches = [np.random.default_rng(s).integers(0, 256, (n, h, w, 3),
                                                 dtype=np.uint8)
               for s in (21, 22)]
    cfg = StitchConfig()
    st = Stitcher(cfg, device="cuda")
    buf = np.empty_like(batches[0])
    panos = []
    for frames in batches:
        buf[...] = frames
        batch = ImageBatch(gray=buf[..., 1].copy(), color=buf,
                           files=[f"{k}.png" for k in range(n)])
        (res,) = st.stitch_batch(batch, recs=recs)
        want = tcompose.compose(torch.as_tensor(frames).to("cuda"), offsets,
                                cfg)
        np.testing.assert_array_equal(res.image, want)
        panos.append(res.image.copy())
    assert not np.array_equal(panos[0], panos[1])
