"""The phase-correlation registrations against the JAX package: the
incremental strips (``register_sequence_phase``, with and without a pair
subset), whole frames (``register_sequence_phase_whole``) and features
with a phase fallback (``register_sequence_hybrid``), then each through
``Stitcher.stitch_batch``.  Integer record fields are equal, sub-pixel
offsets within 1e-3 px (float32 FFTs of another library), and so are the
attempt-cache statistics.

The frames are a 2x2 serpentine of 240x320 frames with 41% row and 40%
column overlap and fractional true offsets, plus one frame of an unrelated
texture.  The hybrid's frames have frame 2 at 5% contrast: it has no
keypoint above the detector's threshold, so pairs 1 and 2 fail the feature
path and phase correlation, which whitens the spectrum, registers them."""
import numpy as np
import pytest
import torch

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import Stitcher as JStitcher
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import registration as jreg
from imagestitch_tpu.io.dataset import ImageBatch as JImageBatch
from imagestitch_tpu_torch import Stitcher
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.core import registration as treg
from imagestitch_tpu_torch.io.dataset import ImageBatch
from imagestitch_tpu_torch.parallel.mesh import make_mesh
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import (assert_segments_equal,
                                  route_pools_as_on_tpu, two_threads)

H, W = 240, 320


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def frames():
    positions = synthetic.serpentine_positions(2, 2, (140.37, 190.21))
    seq, truth = synthetic.sequence(0, (H, W), positions)
    other, _ = synthetic.sequence(99, (H, W), [(0.5, 0.5)])
    return np.concatenate([seq, other]), truth


@pytest.fixture(scope="module")
def low_contrast(frames):
    """The serpentine with frame 2 at 5% contrast (no unrelated frame)."""
    seq = frames[0][:4].copy()
    seq[2] = np.clip(np.rint((seq[2].astype(np.float32) - 20) * 0.05 + 100),
                     0, 255).astype(np.uint8)
    return seq


def _jcfg(registration, **kw):
    return JStitchConfig(registration=registration, direction=1,
                         direct_incre=1, roi_ratio=0.2, color_mode=False,
                         features=JFeatureConfig(max_keypoints=256), **kw)


def assert_phase_records_equal(got, ref, subpix_atol=1e-3):
    """Integer fields equal; sub-pixel offsets to ``subpix_atol`` px and
    confidences to 1e-3 (a phase response, or a vote count, equal)."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.ok, g.offset, g.direction, g.scale, g.attempts) == \
            (r.ok, r.offset, r.direction, r.scale, r.attempts), (g, r)
        np.testing.assert_allclose(g.offset_subpix, r.offset_subpix,
                                   rtol=0, atol=subpix_atol)
        np.testing.assert_allclose(g.confidence, r.confidence, rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("pairs", [None, [1, 3]])
def test_register_sequence_phase_matches_jax(frames, pairs):
    frames, truth = frames
    jcfg = _jcfg("phase_incre")
    ref = jreg.register_sequence_phase(frames, jcfg, pairs=pairs)
    jstats = dict(jreg.LAST_PHASE_STATS)
    got = treg.register_sequence_phase(frames, config_from_jax(jcfg),
                                       pairs=pairs, device="cpu")
    assert_phase_records_equal(got, ref)
    assert treg.LAST_PHASE_STATS == jstats
    ks = range(4) if pairs is None else pairs
    assert [r.ok for r in got] == [k < 3 for k in ks]
    for k, r in zip(ks, got):
        if r.ok:
            assert np.abs(np.subtract(r.offset, truth[k])).max() < 1


def test_register_sequence_phase_whole_matches_jax(frames):
    frames, truth = frames
    jcfg = _jcfg("phase")
    ref = jreg.register_sequence_phase_whole(frames, jcfg)
    got = treg.register_sequence_phase_whole(
        torch.as_tensor(frames), config_from_jax(jcfg))
    # the failed pair's offset is a noise peak: its centroid moves more
    assert_phase_records_equal(got[:3], ref[:3])
    assert_phase_records_equal(got[3:], ref[3:], subpix_atol=1e-2)
    assert [r.ok for r in got] == [True, True, True, False]
    for r, t in zip(got, truth):
        assert np.abs(np.subtract(r.offset, t)).max() < 1
    # a mesh within phase_hbm_budget runs on its first device: the same
    # records (the over-budget raise: tests/test_torch_parallel_eval.py)
    mesh = make_mesh(devices=["cpu"] * 2)
    assert treg.register_sequence_phase_whole(
        frames, config_from_jax(jcfg), mesh=mesh) == got


def test_register_sequence_hybrid_matches_jax(low_contrast, monkeypatch):
    jcfg = _jcfg("hybrid")
    route_pools_as_on_tpu(monkeypatch)
    feat = jreg.register_sequence_features_incre(low_contrast, jcfg)
    assert [r.ok for r in feat] == [True, False, False]
    ref = jreg.register_sequence_hybrid(low_contrast, jcfg)
    jstats = dict(jreg.LAST_PHASE_STATS)
    got = treg.register_sequence_hybrid(low_contrast, config_from_jax(jcfg),
                                        device="cpu")
    assert_phase_records_equal(got, ref)
    # the phase fallback saw only the failed pairs, and registered them;
    # the feature-ok pair keeps its feature record
    assert treg.LAST_PHASE_STATS == jstats
    assert jstats["pairs_evaluated"] == [1, 2]
    assert [r.ok for r in got] == [True, True, True]
    assert got[0].confidence == feat[0].confidence


@pytest.mark.parametrize("registration", ["phase_incre", "phase", "hybrid"])
def test_stitch_batch_matches_jax_stitcher(frames, low_contrast, monkeypatch,
                                           registration):
    """Stitcher(device="cpu").stitch_batch: records, segments and panoramas
    equal to the JAX Stitcher's."""
    seq = low_contrast if registration == "hybrid" else frames[0]
    jcfg = _jcfg(registration)
    route_pools_as_on_tpu(monkeypatch)
    files = [f"f{i}" for i in range(len(seq))]
    jst = JStitcher(jcfg)
    ref = jst.stitch_batch(JImageBatch(gray=seq, color=None, files=files))
    st = Stitcher(config_from_jax(jcfg), device="cpu")
    got = st.stitch_batch(ImageBatch(gray=seq, color=None, files=files))
    assert_segments_equal(got, ref)
    assert [r.file_range for r in got] == (
        [(0, 4)] if registration == "hybrid" else [(0, 4), (4, 5)])
    assert got[0].report.directions == ref[0].report.directions
    assert got[0].report.attempts == ref[0].report.attempts
    # the persisted direction: the last registered pair's (always the
    # configured one on the whole-image path)
    assert st._direction == jst._direction == (
        1 if registration == "phase" else 3)


def test_chunked_phase_batches_give_the_same_records(frames, monkeypatch):
    """One pair per FFT call gives the records of one call per
    configuration."""
    frames, _ = frames
    cfg = config_from_jax(_jcfg("phase_incre"))
    ref = treg.register_sequence_phase(frames, cfg, device="cpu")
    stats = dict(treg.LAST_PHASE_STATS)
    monkeypatch.setattr(treg, "PHASE_BATCH_BYTES", 1)
    got = treg.register_sequence_phase(frames, cfg, device="cpu")
    assert_phase_records_equal(got, ref, subpix_atol=1e-4)
    assert treg.LAST_PHASE_STATS == stats


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port runs the phase paths there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_full_size_phase_paths_match_jax(cuda_device):
    """chip_smoke.py's phase frames (10 frames of 1936x2584 in a serpentine
    with the iron demo's 1698-row step, plus an unrelated frame): the
    port's records on the card against the JAX package's on the CPU, for
    phase_incre, phase, and the phase part of hybrid (the pairs the port's
    feature path leaves, searched from its last direction).  Prints the JAX
    records."""
    positions = synthetic.serpentine_positions(5, 2, (1698.37, 2284.21))
    seq, truth = synthetic.sequence(7, (1936, 2584), positions)
    other, _ = synthetic.sequence(99, (1936, 2584), [(0.5, 0.5)])
    frames = np.concatenate([seq, other])
    gray = torch.as_tensor(frames, device=cuda_device)

    def show(label, recs):
        print(f"JAX {label}: " + "; ".join(
            f"{k}: ok={r.ok} offset={r.offset} subpix=("
            f"{r.offset_subpix[0]:.4f}, {r.offset_subpix[1]:.4f}) "
            f"dir={r.direction} scale={r.scale} conf={r.confidence:.4f} "
            f"attempts={r.attempts}" for k, r in enumerate(recs)))

    for reg in ("phase_incre", "phase"):
        jcfg = JStitchConfig(registration=reg, direction=1, direct_incre=1,
                             roi_ratio=0.2, color_mode=False)
        jfn = (jreg.register_sequence_phase if reg == "phase_incre"
               else jreg.register_sequence_phase_whole)
        tfn = (treg.register_sequence_phase if reg == "phase_incre"
               else treg.register_sequence_phase_whole)
        ref = jfn(frames, jcfg)
        show(reg, ref)
        got = tfn(gray, config_from_jax(jcfg))
        ok = [r.ok for r in ref]
        # whole frames pad to 3888x5184: float32 FFTs of 20M points in two
        # libraries move the centroid by up to ~1e-3 px
        assert_phase_records_equal([g for g, o in zip(got, ok) if o],
                                   [r for r, o in zip(ref, ok) if o],
                                   subpix_atol=5e-3 if reg == "phase"
                                   else 1e-3)
        assert [r.ok for r in got] == ok
        for r, t in zip(got, truth):
            if r.ok:
                assert np.abs(np.subtract(r.offset, t)).max() < 1
    cfg = config_from_jax(JStitchConfig(
        registration="hybrid", direction=1, direct_incre=1, roi_ratio=0.2,
        color_mode=False))
    from imagestitch_tpu_torch.core import feature_registration as tfr
    feat = tfr.register_sequence_features_incre(gray, cfg)
    print("port feature_incre on the card: " + "; ".join(
        f"{k}: ok={r.ok} offset={r.offset} dir={r.direction} "
        f"attempts={r.attempts}" for k, r in enumerate(feat)))
    failed = [k for k, r in enumerate(feat) if not r.ok]
    direction = next((feat[k].direction for k in range(failed[0] - 1, -1, -1)
                      if feat[k].ok and feat[k].direction), cfg.direction)
    ref = jreg.register_sequence_phase(
        frames, JStitchConfig(registration="hybrid", direction=direction,
                              direct_incre=1, roi_ratio=0.2,
                              color_mode=False), pairs=failed)
    show(f"hybrid phase part (pairs {failed}, direction {direction})", ref)
    got = treg.register_sequence_hybrid(gray, cfg)
    assert_phase_records_equal([got[k] for k in failed], ref)
    assert treg.LAST_PHASE_STATS["pairs_evaluated"] == failed
