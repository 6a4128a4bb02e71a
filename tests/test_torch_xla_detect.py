"""The XLA detector (ops/features/detect.py) against the JAX package's, as
its jitted CPU code runs it: ``select_candidates``, ``detect_batch``,
``detect_describe_image`` and the XLA pool of ``pool_features``.

The response rounds as XLA's CPU code does (fused multiply-adds,
``hessian_response(fused=True)``), so positions and scores are bit-equal;
upright descriptors agree within 1e-5, oriented ones within 1e-4 (the
oriented describe's own tolerance, test_torch_oriented.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagestitch_tpu.core import feature_registration as jfr
from imagestitch_tpu.ops.features import describe as jdescribe
from imagestitch_tpu.ops.features import detect as jdetect
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.ops.features import describe as tdescribe
from imagestitch_tpu_torch.ops.features import detect as tdetect
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def frames():
    pos = [(0.5, 0.5), (40.37, 9.21), (81.74, 18.42)]
    return synthetic.sequence(3, (160, 224), pos)[0]


def test_select_candidates_bit_equal(frames):
    """Top-k of an NMS map with many zeros (ties to the lower index) and a
    k larger than the map (zero padding)."""
    x = frames[0, :40, :50].astype(np.float32)
    p = jdetect.DetectParams()
    raw = np.array(jax.jit(lambda v: jdetect.octave_response(v, p))(x))
    score = np.where(raw > 400.0, raw, 0.0).astype(np.float32)
    for k in (64, 2500):
        ref = jdetect.select_candidates(jnp.asarray(raw), jnp.asarray(score),
                                        k, (3, 37, 2, 48), True)
        got = tdetect.select_candidates(torch.from_numpy(raw),
                                        torch.from_numpy(score), k,
                                        (3, 37, 2, 48), True)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_detect_batch_bit_equal(frames):
    """Two octave loops: 160 x 224 pools down to 20 x 28 (stops below 32);
    a 48 x 70 frame stops after one pool."""
    p = jdetect.DetectParams()
    for imgs, k in ((frames[:2], 300), (frames[:2, :48, :70], 64)):
        ref = jdetect.detect_batch(jnp.asarray(imgs), k, p)
        got = tdetect.detect_batch(torch.from_numpy(imgs), k,
                                   tdetect.DetectParams())
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("upright", [True, False])
def test_detect_describe_image(frames, upright):
    jp = jdescribe.DescribeParams(family="surf-extended", upright=upright)
    tp = tdescribe.DescribeParams(family="surf-extended", upright=upright)
    ref = jax.jit(lambda v: jdetect.detect_describe_image(
        v, 256, jdetect.DetectParams(), jp))(frames[0])
    got = tdetect.detect_describe_image(torch.from_numpy(frames[0]), 256,
                                        tdetect.DetectParams(), tp)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=0,
                               atol=1e-5 if upright else 1e-4)


def test_xla_pool_of_pool_features(frames):
    """``use_pallas=False``: every frame through the XLA detector, as the
    JAX package's _pool_features_jit off the TPU."""
    dp = tfr._detect_params(tfr.StitchConfig())
    sp = tdescribe.DescribeParams(family="surf-extended", upright=True)
    jdp = jfr._detect_params(jfr.StitchConfig())
    jsp = jdescribe.DescribeParams(family="surf-extended", upright=True)
    ref = jfr._pool_features_jit(jnp.asarray(frames), 384, jdp, jsp,
                                 use_pallas_doh=False, fused_select=True)
    got = tfr.pool_features(torch.from_numpy(frames), dp, sp, max_pool=384,
                            fused_select=True, use_pallas=False)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=0,
                               atol=1e-5)


def test_box_filter_and_corner_raise():
    img = torch.zeros((64, 64))
    for p in (tdetect.DetectParams(box_filter=True),
              tdetect.DetectParams(family="corner")):
        with pytest.raises(NotImplementedError, match="item 17"):
            tdetect.detect_image(img, 16, p)
