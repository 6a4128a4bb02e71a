"""Oriented SURF descriptors and the score-map pool against the JAX package.

The orientation estimate (cumsum integral image, atan2, the 72 window
memberships, a 109-sample einsum, argmax) runs in other code on XLA-CPU and
in PyTorch, so near-ties can differ by an ulp.  The tables are held
bit-equal; theta and descriptors to 1e-4 for a stated share of keypoints.
Frames are integer-valued, as real uint8 frames are: the patch integral
image is then exact in float32 and theta agrees to ~3e-7 rad everywhere
(measured: 100% of 3,000 keypoints within 1e-4 rad, 99.97% of the oriented
descriptors within 1e-4, the rest a gradient sign flip in one SURF-128
sign-split bin).

The score-map pool is held against ``_detect_describe_image_pallas`` with
its K4 in interpret mode: the same live slots (score > 0) in the same
order, positions and scores to float32 rounding (XLA on the CPU contracts
some of the correlations into FMAs, so the scores are not bit-equal; the
CUDA K4 is bit-equal to the port's plain version, test_torch_score_map.py),
descriptors to the tolerance above."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagestitch_tpu.core import feature_registration as jfr
from imagestitch_tpu.ops.features import describe as jdescribe
from imagestitch_tpu.ops.features import detect as jdetect
from imagestitch_tpu.ops.pallas import doh as jdoh
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.ops.features import describe as tdescribe
from imagestitch_tpu_torch.ops.features import detect as tdetect
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _case(seed=3, h=200, w=240, k=1500):
    rng = np.random.default_rng(seed)
    img = np.rint(synthetic.textured(rng, h, w)).astype(np.float32)
    rows = rng.uniform(0, h - 1, k).astype(np.float32)
    cols = rng.uniform(0, w - 1, k).astype(np.float32)
    return img, rows, cols


def test_orientation_tables_match_jax():
    np.testing.assert_array_equal(tdescribe._ORI_PTS, jdescribe._ORI_PTS)
    np.testing.assert_array_equal(tdescribe._ORI_WTS, jdescribe._ORI_WTS)
    assert tdescribe._ORI_PTS.shape == (109, 2)
    starts = np.arange(jdescribe._ORI_STEPS, dtype=np.float32) * (
        2 * np.pi / jdescribe._ORI_STEPS)
    assert tdescribe._ORI_STARTS.dtype == np.float32
    np.testing.assert_array_equal(tdescribe._ORI_STARTS, starts)
    for name in ("_ORI_G", "_ORI_R", "_ORI_SPACING", "_ORI_RADIUS",
                 "_ORI_HAAR", "_ORI_WIN", "_ORI_STEPS"):
        assert getattr(tdescribe, name) == getattr(jdescribe, name), name


def test_bilinear_and_rot_match_jax():
    rng = np.random.default_rng(1)
    patch = rng.uniform(0, 255, (50, 29, 29)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, 50).astype(np.float32)
    base = np.arange(18, dtype=np.float32) - 8.5
    u = np.broadcast_to(base[:, None], (1, 18, 18)).copy()
    v = np.broadcast_to(base[None, :], (1, 18, 18)).copy()
    ju, jv = jdescribe._rot(jnp.asarray(-theta), jnp.asarray(u),
                            jnp.asarray(v))
    tu, tv = tdescribe._rot(torch.as_tensor(-theta), torch.as_tensor(u),
                            torch.as_tensor(v))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    # sample on the JAX grid (incl. points outside the patch: clamped cells)
    pr, pc = np.asarray(ju) + 14, np.asarray(jv) + 14
    ref = np.asarray(jdescribe._bilinear_from_patch(
        jnp.asarray(patch), jnp.asarray(pr), jnp.asarray(pc)))
    got = tdescribe._bilinear_from_patch(torch.as_tensor(patch),
                                         torch.as_tensor(pr),
                                         torch.as_tensor(pc))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


def test_dominant_orientation_matches_jax():
    img, rows, cols = _case()
    jp = jdescribe._patch_gather(jnp.asarray(img), jnp.asarray(rows),
                                 jnp.asarray(cols), 29, 14)
    tp = tdescribe._patch_gather(torch.as_tensor(img), torch.as_tensor(rows),
                                 torch.as_tensor(cols), 29, 14)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    ref = np.asarray(jdescribe._dominant_orientation(jp), np.float64)
    got = tdescribe._dominant_orientation(tp).numpy().astype(np.float64)
    err = np.abs(np.angle(np.exp(1j * (got - ref))))
    assert (err < 1e-4).mean() >= 0.99, np.sort(err)[-5:]


@pytest.mark.parametrize("family", ["surf-extended", "surf"])
def test_oriented_describe_matches_jax(family):
    img, rows, cols = _case(k=1000)
    ref = np.asarray(jdescribe.describe_batch(
        jnp.asarray(img)[None], jnp.asarray(rows)[None],
        jnp.asarray(cols)[None],
        jdescribe.DescribeParams(family=family, upright=False)))[0]
    got = tdescribe.describe_batch(
        torch.as_tensor(img)[None], torch.as_tensor(rows)[None],
        torch.as_tensor(cols)[None],
        tdescribe.DescribeParams(family=family, upright=False))[0].numpy()
    assert got.shape == ref.shape == (1000, 128 if family != "surf" else 64)
    err = np.abs(got - ref).max(axis=1)
    assert (err < 1e-4).mean() >= 0.99, np.sort(err)[-5:]


@pytest.mark.parametrize("upright", [True, False])
def test_score_map_pool_matches_jax(upright, monkeypatch):
    monkeypatch.setattr(jdoh, "doh_score_map",
                        functools.partial(jdoh.doh_score_map, interpret=True))
    rng = np.random.default_rng(17)
    img = np.rint(synthetic.textured(rng, 300, 340)).astype(np.uint8)
    dp = jdetect.DetectParams()
    fam = "surf-extended"
    max_kp = 2048
    ref = [np.asarray(a) for a in jfr._detect_describe_image_pallas(
        jnp.asarray(img), max_kp, dp,
        jdescribe.DescribeParams(family=fam, upright=upright))]
    got = [a.numpy() for a in tfr.score_map_pool(
        torch.as_tensor(img), max_kp, tdetect.DetectParams(),
        tdescribe.DescribeParams(family=fam, upright=upright))]
    assert got[3].shape == ref[3].shape == (max_kp, 128)
    live = ref[2] > 0
    np.testing.assert_array_equal(got[2] > 0, live)
    assert 500 < live.sum() < max_kp      # both octaves fill, empty slots too
    # same slot order: measured scores within 1.3e-6 relative (a quarter
    # bit-equal) and positions within 3.1e-5 px, where distinct NMS
    # survivors lie at least a pixel apart
    np.testing.assert_allclose(got[2][live], ref[2][live], rtol=1e-5,
                               atol=0)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g[live], r[live], rtol=0, atol=1e-4)
    err = np.abs(got[3][live] - ref[3][live]).max(axis=1)
    assert (err < 1e-4).mean() >= (1.0 if upright else 0.99)
