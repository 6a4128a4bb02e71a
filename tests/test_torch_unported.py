"""Registration configurations outside the ported slice raise
NotImplementedError naming the ROADMAP list that holds them (the
Stitcher-level options are in test_torch_slice.py); the ones the port
gained since construct a ``Stitcher`` and run a 3-frame CPU sequence like
the JAX package's (records and panorama equal, pools routed as on a
TPU)."""
import pytest

from imagestitch_tpu import EnhanceConfig as JEnhanceConfig
from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu_torch import StitchConfig, Stitcher
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
])
def test_registration_outside_the_slice_raises(change):
    cfg = StitchConfig(color_mode=False).replace(**change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Stitcher(cfg, device="cpu")


@pytest.fixture(scope="module")
def frames():
    pos = synthetic.serpentine_positions(3, 1, (131.37, 180.21))
    return synthetic.sequence(11, (160, 224), pos)[0]


@pytest.fixture(scope="module")
def orb_frames():
    pos = synthetic.serpentine_positions(3, 1, (180.37, 260.21))
    return synthetic.sequence(11, (320, 448), pos)[0]


@pytest.mark.parametrize("change", [
    dict(enhance=JEnhanceConfig(enabled=True, use_clahe=False)),
    dict(offset_calculate="ransac"),
    dict(offset_calculate="ransac_translation"),
    dict(features=JFeatureConfig(max_keypoints=256, strict_roi_detect=True)),
    dict(enhance=JEnhanceConfig(enabled=True, use_clahe=True)),
    dict(features=JFeatureConfig(max_keypoints=256, method="orb"),
         roi_ratio=0.5),
    dict(features=JFeatureConfig(max_keypoints=256, box_filter=True)),
    dict(features=JFeatureConfig(max_keypoints=256, method="sift")),
], ids=["equalize", "ransac", "ransac_translation", "strict_roi_detect",
        "clahe", "orb", "box_filter", "sift"])
def test_registration_now_in_the_slice_runs_like_jax(change, frames,
                                                     monkeypatch, request):
    """Once raising (ROADMAP items 15, 16 and 17): enhancement and
    strict-ROI detection take the strict attempt, RANSAC votes on the
    pooled path; ORB (the corner pool of the XLA detector, Hamming
    matches), box-filter SURF (the XLA box pool) and SIFT (the score-map
    pool, K4's Pallas kernel in interpret mode on the JAX side) register
    on the pooled path (pools routed as on a TPU).  ORB takes larger
    frames that overlap by 140 rows: its 31-px edge border leaves no
    keypoint in the 29-row overlap of the others."""
    route_pools_as_on_tpu(monkeypatch)
    static_clip(monkeypatch)
    jcfg = JStitchConfig(color_mode=False, roi_ratio=0.2,
                         features=JFeatureConfig(max_keypoints=256)
                         ).replace(**change)
    if jcfg.features.method == "orb":
        frames = request.getfixturevalue("orb_frames")
    got, ref = stitch_both(frames, jcfg)
    assert_segments_equal(got, ref)
    g, r = got[0].report, ref[0].report
    for f in ("offsets", "confidences", "directions", "scales", "attempts"):
        assert getattr(g, f) == getattr(r, f), f
    assert g.num_ok == 2
