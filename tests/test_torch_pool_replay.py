"""The pooled stage and the replay: the port's pool (K1 + atlas + K2, plain
versions on the CPU) against the JAX fused pool run with its Pallas kernels
in interpret mode, and the port's replay_from_pool against the JAX replay.

The JAX Stitcher gates every Pallas call on a TPU backend, so on the CPU
its reference pool is built as tests/test_pallas_select_describe.py builds
it: _detect_describe_image_pallas_v2(interpret=True) under lax.map, then
replay_from_pool (whose matcher on the CPU is the XLA path).

Frames are a seeded chain with fractional true offsets (+0.37 / +0.21 px
drifts on a fractional origin): the replay truncates the sub-pixel-refined
mean displacement, and at an integer true offset that mean sits within
float32 rounding of an integer, where summation order alone could flip
the integer offset by 1 px."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import feature_registration as jfr
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.utils import synthetic

H, W = 448, 420


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Test workers share the machine's cores; PyTorch's default of one
    thread per core each makes them stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    positions = synthetic.serpentine_positions(2, 2, (380.37, 350.21))[:3]
    frames, truth = synthetic.sequence(21, (H, W), positions)
    jcfg = JStitchConfig(registration="feature_incre", direction=1,
                         direct_incre=1, roi_ratio=0.2, color_mode=False,
                         features=JFeatureConfig(upright=True,
                                                 max_keypoints=256))
    cfg = config_from_jax(jcfg)
    dp, sp = jfr._detect_params(jcfg), jfr._describe_params(jcfg)
    jpool = jax.lax.map(
        lambda im: jfr._detect_describe_image_pallas_v2(im, dp, sp,
                                                        interpret=True),
        jnp.asarray(frames))
    tpool = tfr.pool_features(torch.as_tensor(frames),
                              tfr._detect_params(cfg),
                              tfr._describe_params(cfg))
    return dict(frames=frames, truth=truth, jcfg=jcfg, cfg=cfg,
                jpool=tuple(np.array(a) for a in jpool), tpool=tpool)


def test_pool_matches_interpret_pool(case):
    jr, jc, js, jd = case["jpool"]
    tr, tc, ts, td = (a.numpy() for a in case["tpool"])
    assert tr.shape == jr.shape == (3, H * 4 + (H // 2) * 2)
    assert td.shape == jd.shape == (3, tr.shape[1], 128)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-4)
    live = js > 0
    np.testing.assert_array_equal(ts > 0, live)
    assert live.sum() > 2000
    # positions: K1 sub-pixel offsets agree to 1e-5, times the octave scale
    np.testing.assert_allclose(tr[live], jr[live], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc[live], jc[live], rtol=0, atol=1e-4)
    np.testing.assert_allclose(td[live], jd[live], rtol=0, atol=1e-5)


def _assert_records_equal(got, ref):
    """Integer fields bit-equal; the sub-pixel mean to 1e-4 px (a float32
    mean over up to k_sel matches, summed in another order)."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.ok, g.offset, g.direction, g.scale, g.confidence,
                g.attempts) == (r.ok, r.offset, r.direction, r.scale,
                                r.confidence, r.attempts), (g, r)
        np.testing.assert_allclose(g.offset_subpix, r.offset_subpix,
                                   rtol=0, atol=1e-4)


def test_replay_matches_jax(case):
    n = len(case["frames"])
    jrecs = jfr.replay_from_pool(tuple(jnp.asarray(a) for a in case["jpool"]),
                                 n, (H, W), case["jcfg"])
    jstats = dict(jfr.LAST_REPLAY_STATS)
    # the port's replay on the JAX pool, then on its own pool
    trecs_j = tfr.replay_from_pool(
        tuple(torch.as_tensor(a) for a in case["jpool"]), n, (H, W),
        case["cfg"])
    assert tfr.LAST_REPLAY_STATS == jstats
    trecs = tfr.replay_from_pool(case["tpool"], n, (H, W), case["cfg"])
    assert tfr.LAST_REPLAY_STATS == jstats
    _assert_records_equal(trecs_j, jrecs)
    _assert_records_equal(trecs, jrecs)
    assert [r.direction for r in trecs] == [1, 2]
    for r, t in zip(trecs, case["truth"]):
        assert r.ok and np.abs(np.subtract(r.offset_subpix, t)).max() < 0.5


def test_register_sequence_matches_replay(case):
    recs = tfr.register_sequence_features_incre(case["frames"], case["cfg"],
                                                device="cpu")
    ref = tfr.replay_from_pool(case["tpool"], 3, (H, W), case["cfg"])
    assert recs == ref
    cfg = case["cfg"].replace(features=dataclasses.replace(
        case["cfg"].features, upright=False))
    # auto_upright: the upright pool registers every pair, no fallback
    assert tfr.register_sequence_features_incre(case["frames"], cfg,
                                                device="cpu") == ref
