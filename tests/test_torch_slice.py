"""The slice end to end: the port's Stitcher(cfg).stitch_batch on the CPU
against the JAX chain — fused pool with its Pallas kernels in interpret
mode, replay_from_pool, segmentation at failed pairs, fade compose per
segment — on the flagship configuration with upright descriptors (small
frames, max_keypoints=256).  Segments, ok flags and integer offsets must be
bit-equal, and so must the panoramas.

The frames are a 2x2 serpentine with fractional true offsets (see
utils/synthetic.py: the replay truncates the refined mean displacement, so
integer true offsets would leave parity to summation order) plus one frame
of an unrelated texture, which breaks the sequence into two segments."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import compose as jcompose
from imagestitch_tpu.core import feature_registration as jfr
from imagestitch_tpu_torch import (FeatureConfig, StitchConfig, Stitcher,
                                   compose)
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.io import codec
from imagestitch_tpu_torch.io.dataset import ImageBatch, list_project_images
from imagestitch_tpu_torch.utils import synthetic

H, W = 320, 400


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Test workers share the machine's cores; PyTorch's default of one
    thread per core each makes them stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    positions = synthetic.serpentine_positions(2, 2, (270.37, 330.21))
    seq, truth = synthetic.sequence(0, (H, W), positions)
    other, _ = synthetic.sequence(99, (H, W), [(0.5, 0.5)])
    return np.concatenate([seq, other]), truth


def _jax_chain(frames, jcfg):
    dp, sp = jfr._detect_params(jcfg), jfr._describe_params(jcfg)
    pool = jax.lax.map(
        lambda im: jfr._detect_describe_image_pallas_v2(im, dp, sp,
                                                        interpret=True),
        jnp.asarray(frames))
    recs = jfr.replay_from_pool(pool, len(frames), (H, W), jcfg)
    segs, start = [], 0
    while start < len(frames):
        end = start
        while end < len(frames) - 1 and recs[end].ok:
            end += 1
        offs = [recs[k].offset for k in range(start, end)]
        img = (np.asarray(frames[start]) if end == start else
               np.asarray(jcompose.compose(frames[start:end + 1], offs, jcfg)))
        segs.append(((start, end + 1), offs, img))
        start = end + 1
    return recs, segs


def test_stitch_batch_matches_jax_chain(frames):
    frames, truth = frames
    jcfg = JStitchConfig(registration="feature_incre", direction=1,
                         direct_incre=1, roi_ratio=0.2, color_mode=False,
                         fuse_method="fadeInAndFadeOut",
                         features=JFeatureConfig(upright=True,
                                                 max_keypoints=256))
    jrecs, jsegs = _jax_chain(frames, jcfg)
    res = Stitcher(config_from_jax(jcfg), device="cpu").stitch_batch(
        ImageBatch(gray=frames, color=None,
                   files=[f"f{i}" for i in range(len(frames))]))
    rep = res[0].report
    assert [r.ok for r in jrecs] == [True, True, True, False]
    assert rep.num_ok == 3
    assert rep.offsets == [r.offset for r in jrecs]
    assert rep.directions == [r.direction for r in jrecs] == [1, 2, 3, 0]
    assert rep.confidences == [r.confidence for r in jrecs]
    assert rep.attempts == [r.attempts for r in jrecs]
    assert len(res) == len(jsegs) == 2
    for r, (rng, offs, img) in zip(res, jsegs):
        assert r.file_range == rng and r.offsets == offs
        assert r.image.dtype == np.uint8
        np.testing.assert_array_equal(r.image, img)
    for off, t in zip(res[0].offsets, truth):
        assert np.abs(np.subtract(off, t)).max() < 1


def test_stitch_files_and_direction_persistence(frames, tmp_path):
    frames, _ = frames
    d = tmp_path / "1"
    d.mkdir()
    for i, f in enumerate(frames[:4]):
        codec.imwrite(str(d / f"tile_{i:02d}.png"), f)
    files = list_project_images(str(tmp_path), 1, "png")
    assert len(files) == 4
    cfg = StitchConfig(registration="feature_incre", direction=1,
                       direct_incre=1, roi_ratio=0.2, color_mode=False,
                       features=FeatureConfig(upright=True, max_keypoints=256))
    st = Stitcher(cfg, device="cpu")
    res = st.stitch_files(files)
    ref = st.stitch_batch(ImageBatch(gray=frames[:4], color=None,
                                     files=files))
    assert len(res) == 1 and res[0].offsets == ref[0].offsets
    np.testing.assert_array_equal(res[0].image, ref[0].image)
    # the last successful direction (3) persists into the next sequence
    assert st._direction == 3


@pytest.fixture(scope="module")
def upright_records(frames):
    """The records of the 5 frames (upright, 256 keypoints), registered
    once for the composition-only cases."""
    cfg = StitchConfig(color_mode=False,
                       features=FeatureConfig(upright=True, max_keypoints=256))
    return Stitcher(cfg, device="cpu").register(frames[0])


@pytest.mark.parametrize("change", [
    dict(fuse_method="average"),
    dict(fuse_method="trigonometric"),
    dict(fuse_method="multiBandBlending"),
    dict(use_global_solver=True),
])
def test_outside_the_slice_raises(frames, upright_records, change):
    """Stitcher-level options, each once raising, now ported.  The fusion
    modes: the Stitcher composes each segment as ``compose`` does (their
    parity with the JAX package is in test_torch_fusion_modes.py and
    test_torch_pyramid_seam.py), and color multiband raises ValueError.
    The global solver: on the same records, the JAX Stitcher's segments
    and panoramas (loop closure over the 4-frame segment, the pose-graph
    solve, composition from the rounded positions; more in
    test_torch_solver.py).  The registration-level options are in
    test_torch_unported.py."""
    cfg = StitchConfig(color_mode=False).replace(**change)
    frames, _ = frames
    files = [f"f{i}" for i in range(len(frames))]
    if cfg.use_global_solver:
        from imagestitch_tpu import Stitcher as JStitcher
        from imagestitch_tpu.io.dataset import ImageBatch as JImageBatch
        from test_torch_jax_chain import assert_segments_equal
        ref = JStitcher(JStitchConfig(color_mode=False).replace(
            **change)).stitch_batch(
            JImageBatch(gray=frames, color=None, files=files),
            recs=upright_records)
        got = Stitcher(cfg, device="cpu").stitch_batch(
            ImageBatch(gray=frames, color=None, files=files),
            recs=upright_records)
        assert [r.file_range for r in got] == [(0, 4), (4, 5)]
        assert_segments_equal(got, ref)
        return
    res = Stitcher(cfg, device="cpu").stitch_batch(
        ImageBatch(gray=frames, color=None, files=files),
        recs=upright_records)
    assert [r.file_range for r in res] == [(0, 4), (4, 5)]
    np.testing.assert_array_equal(
        res[0].image, compose(frames[:4], res[0].offsets, cfg, device="cpu"))
    if cfg.fuse_method == "multiBandBlending":
        color = np.repeat(frames[..., None], 3, axis=-1)
        with pytest.raises(ValueError, match="gray"):
            Stitcher(cfg.replace(color_mode=True), device="cpu").stitch_batch(
                ImageBatch(gray=frames, color=color, files=files),
                recs=upright_records)


def test_mesh_and_oriented_fallback_raise(frames, monkeypatch):
    """A mesh still raises.  The default configuration (auto_upright) no
    longer does: upright registers pairs 0-2, pair 3 (unrelated frame) fails
    with some matches, and the oriented fallback retries it exactly as the
    JAX package does (the whole configuration's stitch is held against the
    JAX Stitcher in test_torch_fallback.py)."""
    from imagestitch_tpu_torch.core import feature_registration as tfr
    from test_torch_jax_chain import (assert_records_equal,
                                      count_score_map_frames,
                                      route_pools_as_on_tpu)
    frames, _ = frames
    cfg = StitchConfig(color_mode=False,
                       features=FeatureConfig(max_keypoints=256))
    with pytest.raises(NotImplementedError, match="item 22"):
        Stitcher(cfg, mesh=object(), device="cpu")
    up = Stitcher(cfg.replace(features=dataclasses.replace(
        cfg.features, upright=True)), device="cpu").register(frames)
    assert not up[3].ok and up[3].confidence > 0
    route_pools_as_on_tpu(monkeypatch)
    calls = count_score_map_frames(monkeypatch, tfr)
    recs = Stitcher(cfg, device="cpu").register(frames)
    assert calls == [(H, W)] * 2          # the fallback's two-frame pool
    # roi_ratio 0.1: six scales x four directions, all tried again
    assert recs[:3] == up[:3] and recs[3].attempts == up[3].attempts == 24
    jcfg = JStitchConfig(color_mode=False,
                         features=JFeatureConfig(max_keypoints=256))
    assert_records_equal(recs,
                         jfr.register_sequence_features_incre(frames, jcfg))
