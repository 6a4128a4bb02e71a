"""Registration configurations outside the ported slice raise
NotImplementedError naming the ROADMAP item that will port them (the
Stitcher-level options are in test_torch_slice.py); the ones this slice
ported construct a ``Stitcher`` and run a 3-frame CPU sequence like the JAX
package's (records and panorama equal)."""
import pytest

from imagestitch_tpu import EnhanceConfig as JEnhanceConfig
from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu_torch import FeatureConfig, StitchConfig, Stitcher
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import (assert_segments_equal,
                                  route_pools_as_on_tpu, stitch_both,
                                  two_threads)
from test_torch_strict_paths import static_clip


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.mark.parametrize("change", [
    dict(compute_dtype="bfloat16"),
    dict(features=FeatureConfig(method="orb")),
    dict(features=FeatureConfig(box_filter=True)),
    dict(features=FeatureConfig(method="sift")),
])
def test_registration_outside_the_slice_raises(change):
    cfg = StitchConfig(color_mode=False).replace(**change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Stitcher(cfg, device="cpu")


@pytest.fixture(scope="module")
def frames():
    pos = synthetic.serpentine_positions(3, 1, (131.37, 180.21))
    return synthetic.sequence(11, (160, 224), pos)[0]


@pytest.mark.parametrize("change", [
    dict(enhance=JEnhanceConfig(enabled=True, use_clahe=False)),
    dict(offset_calculate="ransac"),
    dict(offset_calculate="ransac_translation"),
    dict(features=JFeatureConfig(max_keypoints=256, strict_roi_detect=True)),
    dict(enhance=JEnhanceConfig(enabled=True, use_clahe=True)),
], ids=["equalize", "ransac", "ransac_translation", "strict_roi_detect",
        "clahe"])
def test_registration_now_in_the_slice_runs_like_jax(change, frames,
                                                     monkeypatch):
    """Once raising (ROADMAP items 15 and 16): enhancement and strict-ROI
    detection take the strict attempt, RANSAC votes on the pooled path
    (pools routed as on a TPU)."""
    route_pools_as_on_tpu(monkeypatch)
    static_clip(monkeypatch)
    jcfg = JStitchConfig(color_mode=False, roi_ratio=0.2,
                         features=JFeatureConfig(max_keypoints=256)
                         ).replace(**change)
    got, ref = stitch_both(frames, jcfg)
    assert_segments_equal(got, ref)
    g, r = got[0].report, ref[0].report
    for f in ("offsets", "confidences", "directions", "scales", "attempts"):
        assert getattr(g, f) == getattr(r, f), f
    assert g.num_ok == 2
