"""The port's spans and counters (``utils/profiling.py``) on the CPU.

A tiny color project, a 2x2 serpentine of 320x400 frames and a frame of an
unrelated texture (whose pair fails upright with some valid matches, so the
oriented fallback runs), goes through ``Stitcher.stitch_batch`` and, as PNG
files, through ``Stitcher.stitch_files``.  Every test reads counter deltas:
the counters only grow, and xdist runs other tests in the same process."""
import json
import sys
import threading

import numpy as np
import pytest
import torch

from imagestitch_tpu_torch import FeatureConfig, StitchConfig, Stitcher
from imagestitch_tpu_torch.io import codec
from imagestitch_tpu_torch.io.dataset import ImageBatch, bgr_to_gray
from imagestitch_tpu_torch.utils import profiling, synthetic

H, W = 320, 400
REGISTER = ("REGISTER_UPLOAD_NS", "REGISTER_POOL_NS", "REGISTER_MATCH_NS",
            "REGISTER_FALLBACK_NS")
COMPOSE = ("COMPOSE_UPLOAD_NS", "COMPOSE_FUSE_NS", "COMPOSE_READBACK_NS")
INGEST = ("INGEST_DECODE_NS", "INGEST_GRAY_NS", "INGEST_WAIT_NS",
          "INGEST_UPLOAD_NS", "INGEST_CONCAT_NS")
COUNTERS = [k for k in vars(profiling)
            if k.isupper() and isinstance(getattr(profiling, k), int)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Test workers share the machine's cores; PyTorch's default of one
    thread per core each makes them stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def color():
    positions = synthetic.serpentine_positions(2, 2, (270.37, 330.21))
    return np.concatenate([
        synthetic.color_sequence(0, (H, W), positions)[0],
        synthetic.color_sequence(99, (H, W), [(0.5, 0.5)])[0]])


def _cfg(registration="feature_incre"):
    return StitchConfig(registration=registration, direction=1,
                        direct_incre=1, roi_ratio=0.2, color_mode=True,
                        features=FeatureConfig(max_keypoints=256))


def _batch(color):
    return ImageBatch(gray=np.stack([bgr_to_gray(c) for c in color]),
                      color=color, files=[f"f{k}" for k in range(len(color))])


def _counted(fn):
    """``fn()``'s result, the counters' deltas, and how many annotations
    the program entered (``torch.profiler.record_function`` calls)."""
    calls = []
    real = torch.profiler.record_function

    def record_function(*a, **k):
        calls.append(a)
        return real(*a, **k)

    before = {k: getattr(profiling, k) for k in COUNTERS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", record_function)
        out = fn()
    return out, {k: getattr(profiling, k) - before[k] for k in COUNTERS}, \
        len(calls)


@pytest.fixture(scope="module")
def batch_run(color):
    return _counted(lambda: Stitcher(_cfg(), device="cpu").stitch_batch(
        _batch(color)))


@pytest.fixture(scope="module")
def files_run(color, tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    files = [str(d / f"{k:02d}.png") for k in range(len(color))]
    for f, im in zip(files, color):
        codec.imwrite(f, im)
    return _counted(lambda: Stitcher(_cfg(), device="cpu").stitch_files(
        files))


@pytest.mark.parametrize("registration", ["feature_incre", "feature"])
def test_layer_counters_of_stitch_batch(color, batch_run, registration):
    """FRAMES rises by the project's frames; every register and compose
    counter rises, the fallback's included; the sub-spans sum to 80-100%
    of the report's t_register and t_compose, which their layer spans
    give; no ingest counter moves."""
    if registration == "feature_incre":
        res, d, _ = batch_run
    else:
        res, d, _ = _counted(lambda: Stitcher(
            _cfg(registration), device="cpu").stitch_batch(_batch(color)))
    rep = res[0].report
    assert [r.file_range for r in res] == [(0, 4), (4, 5)]
    assert d["FRAMES"] == 5
    assert d["REGISTER_DISPATCHES"] >= 2
    assert all(d[k] > 0 for k in REGISTER + COMPOSE), d
    assert all(d[k] == 0 for k in INGEST), d
    assert d["REGISTER_NS"] * 1e-9 == pytest.approx(rep.t_register)
    assert d["COMPOSE_NS"] * 1e-9 == pytest.approx(rep.t_compose)
    for layer, parts in (("REGISTER_NS", REGISTER), ("COMPOSE_NS", COMPOSE)):
        share = sum(d[k] for k in parts) / d[layer]
        assert 0.8 <= share <= 1.0, (layer, share)


def test_ingest_counters_of_stitch_files(files_run, batch_run):
    """Decode, gray, the wait on the decode worker, the upload and the
    join each rise, and every frame's gray is made on the device;
    registration and composition count as they do from decoded frames,
    but for the compose upload: the color frames went up at ingest."""
    res, d, _ = files_run
    assert d["FRAMES"] == 5
    assert d["INGEST_GRAY_FRAMES"] == d["INGEST_GRAY_CARD"] == 5
    assert all(d[k] > 0 for k in INGEST), d
    assert d["COMPOSE_UPLOAD_NS"] == 0
    assert all(d[k] > 0 for k in REGISTER + COMPOSE
               if k != "COMPOSE_UPLOAD_NS"), d
    assert d["REGISTER_DISPATCHES"] == batch_run[1]["REGISTER_DISPATCHES"]
    assert [r.offsets for r in res] == [r.offsets for r in batch_run[0]]


def test_no_fallback_on_a_clean_chain(color):
    """The serpentine alone registers every pair upright: the fallback's
    counter stays where it was."""
    res, d, _ = _counted(lambda: Stitcher(_cfg(), device="cpu").stitch_batch(
        _batch(color[:4])))
    assert [r.file_range for r in res] == [(0, 4)]
    assert d["FRAMES"] == 4
    assert d["REGISTER_FALLBACK_NS"] == 0
    assert d["REGISTER_POOL_NS"] > 0 and d["REGISTER_MATCH_NS"] > 0


def test_no_annotation_with_the_profiler_off(batch_run, files_run):
    assert not torch._C._autograd._profiler_enabled()
    assert batch_run[2] == 0
    assert files_run[2] == 0


def test_trace_holds_the_main_thread_spans(color, tmp_path):
    """Under ``utils.profiling.trace`` the Chrome trace names every span
    the main thread entered, the gray made on the device included;
    decode, counted on the decode worker, is not annotated, and compose
    uploads nothing."""
    files = [str(tmp_path / f"{k:02d}.png") for k in range(len(color))]
    for f, im in zip(files, color):
        codec.imwrite(f, im)
    stitcher = Stitcher(_cfg(), device="cpu")
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        stitcher.stitch_files(files)
    with open(f"{log_dir}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    spans = {n[len(profiling.PREFIX):] for n in names
             if n.startswith(profiling.PREFIX)}
    assert spans == {"ingest.wait", "ingest.upload", "ingest.gray",
                     "ingest.concat", "register", "register.upload",
                     "register.pool", "register.match", "register.fallback",
                     "compose", "compose.fuse", "compose.readback"}


class _NoSpan:
    def __init__(self, name, annotate=True):
        self.seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_spans_change_no_record_or_panorama(color, batch_run, monkeypatch):
    """Records and panoramas equal those of a run with the spans and
    counters stubbed out."""
    monkeypatch.setattr(profiling, "span", _NoSpan)
    monkeypatch.setattr(profiling, "count", lambda counter, n=1: None)
    before = {k: getattr(profiling, k) for k in COUNTERS}
    bare = Stitcher(_cfg(), device="cpu").stitch_batch(_batch(color))
    assert {k: getattr(profiling, k) for k in COUNTERS} == before
    res = batch_run[0]
    assert [r.file_range for r in bare] == [r.file_range for r in res]
    assert [r.offsets for r in bare] == [r.offsets for r in res]
    for a, b in zip(bare, res):
        np.testing.assert_array_equal(a.image, b.image)


def test_span_counts_its_body_and_knows_its_counters():
    before = profiling.COMPOSE_FUSE_NS
    with profiling.span("compose.fuse") as s:
        pass
    assert s.ns >= 0 and s.seconds == s.ns * 1e-9
    assert profiling.COMPOSE_FUSE_NS - before == s.ns
    with pytest.raises(ValueError, match="no counter COMPOSE_BLEND_NS"):
        profiling.span("compose.blend")


def test_counters_lose_no_update_across_threads():
    """More threads than cores add to one counter with a short switch
    interval: the total is every addition."""
    threads, adds = 16, 2000
    before = profiling.INGEST_GRAY_NS
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            profiling.count("INGEST_GRAY_NS", 3) for _ in range(adds)])
            for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.INGEST_GRAY_NS - before == 3 * threads * adds
