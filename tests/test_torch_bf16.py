"""``compute_dtype="bfloat16"``: the port's XLA detector in bfloat16
(ops/features/detect.py, ``DetectParams.dtype``) against the JAX
package's, as its jitted CPU code runs it.

The JAX detector casts the frame to bfloat16 (JAX detect.py:354, :392,
:458); XLA's CPU code computes each bfloat16 operation in float32 and
rounds it, the box-filter integral images accumulate in float32, and the
Harris response's last difference stays in float32 where the detector
widens it (excess precision).  Tolerances, each held where it is stated:
  * the three detectors (Gaussian DoH, box filter, FAST-9 + Harris over
    bfloat16 ORB levels): scores bit-equal, positions within 1e-4 px (one
    ORB column of 512 differs in its sub-pixel step; measured 0 for the
    others);
  * descriptors within 1e-5 (the float32 describe's own tolerance);
  * a gray ``Stitcher`` with ``use_pallas=False``: the JAX Stitcher's
    records and panorama, bit-equal; the kernel pools ignore the dtype, as
    the Pallas kernels do, so the default pool gives the float32 records.
"""
import jax
import numpy as np
import pytest
import torch

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.ops.features import describe as jdescribe
from imagestitch_tpu.ops.features import detect as jdetect
from imagestitch_tpu_torch import StitchConfig, Stitcher
from imagestitch_tpu_torch.ops.features import describe as tdescribe
from imagestitch_tpu_torch.ops.features import detect as tdetect
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import (assert_segments_equal, stitch_both,
                                  two_threads)

FAMILIES = {"doh": dict(), "box": dict(box_filter=True),
            "corner": dict(family="corner")}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def image():
    return synthetic.sequence(5, (240, 320), [(0.3, 0.6)])[0][0]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_detectors_match_jax(family, image):
    kw = FAMILIES[family]
    jp = jdetect.DetectParams(dtype="bfloat16", **kw)
    fn = (jdetect.detect_image_corner if family == "corner"
          else jdetect.detect_image_hessian)
    ref = [np.asarray(a) for a in jax.jit(lambda v: fn(v, 512, jp))(image)]
    got = tdetect.detect_batch(torch.from_numpy(image)[None], 512,
                               tdetect.DetectParams(dtype="bfloat16", **kw))
    (rr, rc, rs), (gr, gc, gs) = ref, (a[0].numpy() for a in got)
    assert (rs > 0).sum() == (gs > 0).sum() == 512
    np.testing.assert_array_equal(gs, rs)
    np.testing.assert_allclose(gr, rr, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gc, rc, rtol=0, atol=1e-4)
    # and bfloat16 is not float32: the scores move
    f32 = tdetect.detect_batch(torch.from_numpy(image)[None], 512,
                               tdetect.DetectParams(**kw))[2][0].numpy()
    assert (f32 != gs).any()


@pytest.mark.parametrize("family", ["doh", "corner"])
def test_bf16_detect_describe_matches_jax(family, image):
    kw = FAMILIES[family]
    desc = "orb" if family == "corner" else "surf"
    jp = jdetect.DetectParams(dtype="bfloat16", **kw)
    js = jdescribe.DescribeParams(family=desc, upright=True)
    ref = [np.asarray(a) for a in jax.jit(
        lambda v: jdetect.detect_describe_image(v, 256, jp, js))(image)]
    got = [a.numpy() for a in tdetect.detect_describe_image(
        torch.from_numpy(image), 256,
        tdetect.DetectParams(dtype="bfloat16", **kw),
        tdescribe.DescribeParams(family=desc, upright=True))]
    np.testing.assert_array_equal(got[2], ref[2])
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=1e-5)


def test_bf16_stitcher_gives_jax_records():
    """A gray 3-frame serpentine through the XLA detector's pool
    (``use_pallas=False``), as the JAX package off the TPU."""
    pos = synthetic.serpentine_positions(3, 1, (131.37, 180.21))
    frames = synthetic.sequence(11, (160, 224), pos)[0]
    jcfg = JStitchConfig(color_mode=False, roi_ratio=0.2, use_pallas=False,
                         compute_dtype="bfloat16",
                         features=JFeatureConfig(max_keypoints=256))
    got, ref = stitch_both(frames, jcfg)
    assert_segments_equal(got, ref)
    g, r = got[0].report, ref[0].report
    for f in ("offsets", "confidences", "directions", "scales", "attempts"):
        assert getattr(g, f) == getattr(r, f), f
    assert g.num_ok == 2


def test_kernel_pool_ignores_bf16():
    """The fused pool (the default, K1/K2's plain versions on the CPU) runs
    in float32 whatever ``compute_dtype`` says: the bfloat16 Stitcher's
    records are the float32 one's."""
    pos = synthetic.serpentine_positions(3, 1, (131.37, 180.21))
    frames = synthetic.sequence(11, (160, 224), pos)[0]
    recs = [Stitcher(StitchConfig(color_mode=False, roi_ratio=0.2,
                                  compute_dtype=dt), device="cpu"
                     ).register(frames)
            for dt in ("float32", "bfloat16")]
    assert recs[0] == recs[1] and all(r.ok for r in recs[1])
