"""Whole-image feature registration (``registration="feature"``) and K5.

K5 (top2_l2): the port's plain version against the Pallas kernel in
interpret mode, the CUDA kernel against the plain version on a GPU.  Then
match_batch, displacement_from_matches, register_sequence_features and
``Stitcher(registration="feature")`` against the JAX package, whose pools
run as on a TPU (test_torch_jax_chain.py).

The frames are test_torch_slice.py's: a 2x2 serpentine with fractional
true offsets plus one frame of an unrelated texture, whose pair fails the
upright whole-image vote with some valid matches and so takes the oriented
retry over a two-frame mini pool."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import feature_registration as jfr
from imagestitch_tpu.ops.features import match as jmatch
from imagestitch_tpu.ops.features import vote as jvote
from imagestitch_tpu.ops.pallas import matcher as jmatcher
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.ops.features import match as tmatch
from imagestitch_tpu_torch.ops.features import vote as tvote
from imagestitch_tpu_torch.ops.kernels import matcher as tkmatch
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


def _descriptors(rng, k, d=128):
    x = rng.normal(size=(k, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_top2_l2_plain_matches_pallas_interpret():
    """Ka a multiple of the Pallas tile (256), Kb ragged, some train rows
    masked: d0/d1 within 1e-5, i0 equal (no near-ties in Gaussian data)."""
    rng = np.random.default_rng(4)
    da, db = _descriptors(rng, 512), _descriptors(rng, 300)
    vb = rng.random(300) > 0.2
    ref = [np.asarray(a) for a in jmatcher.top2_l2(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(vb), interpret=True)]
    got = tkmatch.top2_l2(torch.as_tensor(da)[None], torch.as_tensor(db)[None],
                          torch.as_tensor(vb)[None])
    assert got[1].dtype == torch.int32 and got[0].shape == (1, 512)
    np.testing.assert_allclose(got[0][0].numpy(), ref[0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[1][0].numpy(), ref[1])
    np.testing.assert_allclose(got[2][0].numpy(), ref[2], rtol=1e-5,
                               atol=1e-5)
    assert vb[got[1][0].numpy()].all()


def test_match_batch_and_displacements_match_jax():
    rng = np.random.default_rng(6)
    p, k = 3, 200
    da = np.stack([_descriptors(rng, k) for _ in range(p)])
    # B: A's descriptors permuted and perturbed, so most queries match
    perm = np.stack([rng.permutation(k) for _ in range(p)])
    db = np.take_along_axis(da, perm[..., None], 1) + rng.normal(
        0, 0.02, (p, k, 128)).astype(np.float32)
    va, vb = rng.random((p, k)) > 0.1, rng.random((p, k)) > 0.1
    rows = rng.uniform(0, 300, (2, p, k)).astype(np.float32)
    cols = rng.uniform(0, 300, (2, p, k)).astype(np.float32)
    jti, jok = (np.asarray(a) for a in jmatch.match_batch(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(va), jnp.asarray(vb),
        0.75, 30.0, "l2"))
    t = torch.as_tensor
    ti, ok = tmatch.match_batch(t(da), t(db), t(va), t(vb), 0.75, 30.0, "l2")
    np.testing.assert_array_equal(ok.numpy(), jok)
    assert jok.sum() > 0.5 * p * k
    np.testing.assert_array_equal(ti.numpy()[jok], jti[jok])
    jd = [np.asarray(a) for a in jnp.vectorize(
        jvote.displacement_from_matches, signature="(k),(k),(k),(k),(k),(k)"
        "->(k),(k),(k)")(*(jnp.asarray(a) for a in (
            rows[0], cols[0], rows[1], cols[1], jti, jok)))]
    td = tvote.displacement_from_matches(t(rows[0]), t(cols[0]), t(rows[1]),
                                         t(cols[1]), ti, ok)
    for g, r in zip(td, jd):
        np.testing.assert_array_equal(g.numpy(), r)
    with pytest.raises(NotImplementedError, match="item 17"):
        tmatch.match_batch(t(da), t(db), t(va), t(vb), 0.75, 30.0, "hamming")


def _jcfg(**feat):
    return JStitchConfig(registration="feature", direction=1, direct_incre=1,
                         roi_ratio=0.2, color_mode=False,
                         fuse_method="fadeInAndFadeOut",
                         features=JFeatureConfig(max_keypoints=256, **feat))


def test_register_sequence_features_matches_jax(frames, monkeypatch):
    """Default FeatureConfig: the fused upright pool, whole-image match and
    vote of every pair, and the oriented retry of the failed pair."""
    frames, truth = frames
    route_pools_as_on_tpu(monkeypatch)
    calls = count_score_map_frames(monkeypatch, tfr)
    jcfg = _jcfg()
    ref = jfr.register_sequence_features(frames, jcfg)
    got = tfr.register_sequence_features(frames, config_from_jax(jcfg),
                                         device="cpu")
    assert_records_equal(got, ref, subpix_atol=0)
    assert [r.ok for r in got] == [True, True, True, False]
    assert got[3].attempts == 1 and got[0].scale == 0
    # the oriented retry ran over the failed pair's two frames
    assert calls == [(H, W)] * 2
    for r, t in zip(got, truth):
        assert np.abs(np.subtract(r.offset, t)).max() < 1


def test_stitcher_feature_matches_jax(frames, monkeypatch):
    """Stitcher(registration="feature").stitch_batch: records, segments and
    panoramas equal to the JAX Stitcher's."""
    frames, _ = frames
    route_pools_as_on_tpu(monkeypatch)
    got, ref = stitch_both(frames, _jcfg())
    assert_segments_equal(got, ref)
    assert [r.file_range for r in got] == [(0, 4), (4, 5)]
    assert got[0].report.offsets == ref[0].report.offsets
    assert got[0].report.confidences == ref[0].report.confidences


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_top2_kernel_matches_plain(cuda_device):
    """Ragged query and train counts (not multiples of the 64-row tiles),
    masked train rows and one batch with every train row masked."""
    rng = np.random.default_rng(8)
    da = np.stack([_descriptors(rng, 1000) for _ in range(3)])
    db = np.stack([_descriptors(rng, 777) for _ in range(3)])
    vb = rng.random((3, 777)) > 0.3
    vb[2] = False
    args = [torch.as_tensor(a, device=cuda_device) for a in (da, db, vb)]
    before = tkmatch.TOP2_LAUNCHES
    d0, i0, d1 = tkmatch.top2_l2(*args)
    assert tkmatch.TOP2_LAUNCHES == before + 1
    p0, pi0, p1 = tkmatch.top2_l2(*args, use_kernel=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(d0, p0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d1, p1, rtol=1e-5, atol=1e-5)
    differ = i0 != pi0
    tied = (p1 - p0) <= 1e-5 * p1.abs().clamp_min(1e-30)
    assert not bool((differ & ~tied).any())
    assert bool((d0[2] == 3.4e38).all()) and bool((i0[2] == 0).all())


@pytest.mark.cuda
def test_cuda_register_sequence_features_matches_plain(frames, cuda_device):
    """The whole-image path on the card launches K5 (and K4 for the retry)
    and gives the plain run's records."""
    frames, _ = frames
    cfg = config_from_jax(_jcfg())
    x = torch.as_tensor(frames, device=cuda_device)
    tkmatch.TOP2_LAUNCHES = 0
    from imagestitch_tpu_torch.ops.kernels import doh as tkdoh
    tkdoh.SCORE_MAP_LAUNCHES = 0
    got = tfr.register_sequence_features(x, cfg)
    # K4: one call a frame over its octave bands, for the retry's 2 frames
    assert tkmatch.TOP2_LAUNCHES == 2 and tkdoh.SCORE_MAP_LAUNCHES == 2
    ref = tfr.register_sequence_features(x, cfg.replace(use_kernels=False))
    assert_records_equal(got, ref, subpix_atol=0)
