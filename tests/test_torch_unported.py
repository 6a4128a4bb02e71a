"""Registration configurations outside the ported slice raise
NotImplementedError naming the ROADMAP item that will port them (the
Stitcher-level options are in test_torch_slice.py)."""
import pytest

from imagestitch_tpu_torch import (EnhanceConfig, FeatureConfig, StitchConfig,
                                   Stitcher)


@pytest.mark.parametrize("change", [
    dict(enhance=EnhanceConfig(enabled=True, use_clahe=False)),
    dict(offset_calculate="ransac"),
    dict(offset_calculate="ransac_translation"),
    dict(compute_dtype="bfloat16"),
    dict(features=FeatureConfig(method="orb")),
    dict(features=FeatureConfig(box_filter=True)),
    dict(features=FeatureConfig(strict_roi_detect=True)),
    dict(enhance=EnhanceConfig(enabled=True, use_clahe=True)),
    dict(features=FeatureConfig(method="sift")),
])
def test_registration_outside_the_slice_raises(change):
    cfg = StitchConfig(color_mode=False).replace(**change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Stitcher(cfg, device="cpu")
