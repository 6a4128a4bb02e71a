"""The score-map pool paths of ``feature_incre`` against the JAX package,
whose pools run as on a TPU (test_torch_jax_chain.py):

  (a) the default FeatureConfig: the upright fused pool, then the oriented
      fallback over the frames of the pairs it could not register;
  (b) ``auto_upright=False``: every frame through the oriented score-map
      pool;
  (c) ``upright=True, fused_select=False``: upright descriptors over the
      score-map pool.

Records, segments and panoramas must be equal.  (a) runs on
test_torch_slice.py's frames: a 2x2 serpentine with fractional true offsets
plus a frame of an unrelated texture, whose pair fails upright with some
valid matches; (b) and (c) on the serpentine alone."""
import dataclasses

import numpy as np
import pytest
import torch

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import feature_registration as jfr
from imagestitch_tpu_torch import FeatureConfig, StitchConfig
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.core.registration import PairRegistration
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import (assert_records_equal, assert_segments_equal,
                                  count_score_map_frames,
                                  route_pools_as_on_tpu, stitch_both,
                                  two_threads)

H, W = 320, 400


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def frames():
    positions = synthetic.serpentine_positions(2, 2, (270.37, 330.21))
    seq, truth = synthetic.sequence(0, (H, W), positions)
    other, _ = synthetic.sequence(99, (H, W), [(0.5, 0.5)])
    return np.concatenate([seq, other]), truth


def _jcfg(**feat):
    return JStitchConfig(registration="feature_incre", direction=1,
                         direct_incre=1, roi_ratio=0.2, color_mode=False,
                         fuse_method="fadeInAndFadeOut",
                         features=JFeatureConfig(max_keypoints=256, **feat))


def test_default_config_fallback_matches_jax(frames, monkeypatch):
    """(a): the oriented fallback runs (pool_keypoints=6144 over the failed
    pair's two frames) and the whole stitch equals the JAX Stitcher's."""
    frames, truth = frames
    route_pools_as_on_tpu(monkeypatch)
    calls = count_score_map_frames(monkeypatch, tfr)
    jcfg = _jcfg()
    ref = jfr.register_sequence_features_incre(frames, jcfg)
    got = tfr.register_sequence_features_incre(frames, config_from_jax(jcfg),
                                               device="cpu")
    assert calls == [(H, W)] * 2
    assert_records_equal(got, ref)
    assert [r.ok for r in got] == [True, True, True, False]
    assert [r.direction for r in got] == [1, 2, 3, 0]
    # the fallback's replay: every direction at every scale, some matches
    assert got[3].attempts == 12 and got[3].confidence > 0
    for r, t in zip(got, truth):
        assert np.abs(np.subtract(r.offset, t)).max() < 1
    res, jres = stitch_both(frames, jcfg)
    assert_segments_equal(res, jres)
    assert [r.file_range for r in res] == [(0, 4), (4, 5)]
    assert res[0].report.offsets == [r.offset for r in ref]


@pytest.mark.parametrize("feat", [dict(auto_upright=False),
                                  dict(upright=True, fused_select=False)],
                         ids=["oriented", "upright_score_map"])
def test_score_map_pool_paths_match_jax(frames, feat, monkeypatch):
    """(b) and (c): every frame through the score-map pool; records and the
    panorama equal the JAX Stitcher's, every pair within 1 px."""
    frames, truth = frames
    seq = frames[:4]
    route_pools_as_on_tpu(monkeypatch)
    calls = count_score_map_frames(monkeypatch, tfr)
    jcfg = _jcfg(**feat)
    ref = jfr.register_sequence_features_incre(seq, jcfg)
    got = tfr.register_sequence_features_incre(seq, config_from_jax(jcfg),
                                               device="cpu")
    assert calls == [(H, W)] * 4
    assert_records_equal(got, ref)
    assert [r.direction for r in got] == [1, 2, 3]
    for r, t in zip(got, truth):
        assert r.ok and np.abs(np.subtract(r.offset, t)).max() < 1
    res, jres = stitch_both(seq, jcfg)
    assert_segments_equal(res, jres)


def _rec(ok, direction=0, confidence=0.0):
    return PairRegistration(ok=ok, offset=(0, 0), offset_subpix=(0.0, 0.0),
                            direction=direction, scale=1 if ok else 0,
                            confidence=confidence, attempts=1)


@pytest.mark.parametrize("recs, frames, direction, pairs", [
    # pair 3 has no valid match at all (confidence 0): not retried; the
    # direction is the last registered pair's before pair 1
    ([_rec(True, 2), _rec(False, confidence=2.0), _rec(True, 3),
      _rec(False)], [1, 2], 2, [0]),
    # the first pair fails: no earlier direction, cfg.direction (4) holds;
    # pairs 0 and 2 share no frame, so the mini pool has four frames and
    # mini-index(k) + 1 == mini-index(k + 1) for both
    ([_rec(False, confidence=1.0), _rec(True, 1),
      _rec(False, confidence=5.0)], [0, 1, 2, 3], 4, [0, 2]),
])
def test_fallback_frames_and_direction(recs, frames, direction, pairs,
                                       monkeypatch):
    seen = {}
    monkeypatch.setattr(tfr, "_precompute_pool",
                        lambda images, cfg: seen.setdefault(
                            "frames", images[:, 0, 0].tolist()))

    def replay(n, cfg, cache, accept, extract, shape, offsets_are_full,
               pairs):
        seen.update(n=n, direction=cfg.direction, pairs=list(pairs))
        return [_rec(True, cfg.direction) for _ in pairs]

    monkeypatch.setattr(tfr.reg, "_replay_incremental", replay)
    images = torch.arange(len(recs) + 1, dtype=torch.uint8)[:, None, None]
    cfg = StitchConfig(direction=4, color_mode=False)
    out = tfr._oriented_fallback_incre(images.expand(-1, 4, 4), recs, cfg,
                                       (4, 4))
    assert seen == dict(frames=frames, n=len(frames) - 1,
                        direction=direction, pairs=pairs)
    retried = [k for k, r in enumerate(recs) if not r.ok and r.confidence]
    for k, r in enumerate(out):
        assert r == (_rec(True, direction) if k in retried else recs[k])


def test_pool_features_dispatch():
    """Upright SURF with fused_select takes the fused pool (structural
    capacity: rows x per-row candidates over the octaves); anything else
    the score-map pool of max_pool slots."""
    rng = np.random.default_rng(2)
    img = torch.as_tensor(np.rint(synthetic.textured(rng, 300, 260)))[None]
    cfg = StitchConfig(color_mode=False)
    dp = tfr._detect_params(cfg)
    for upright, fused, width in ((True, True, 300 * 4 + 150 * 2),
                                  (True, False, 700), (False, True, 700)):
        sp = dataclasses.replace(tfr._describe_params(cfg), upright=upright)
        assert tfr._fused_select_ok(dp, sp) == upright
        rows, cols, scores, descs = tfr.pool_features(
            img, dp, sp, max_pool=700, fused_select=fused)
        assert rows.shape == scores.shape == (1, width)
        assert descs.shape == (1, width, 128)
        assert int((scores > 0).sum()) > 300
    assert not tfr._fused_select_ok(dp, tfr._describe_params(cfg.replace(
        features=FeatureConfig(method="sift", upright=True))))
