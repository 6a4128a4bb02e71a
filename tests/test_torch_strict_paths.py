"""The paths of this slice end to end against the JAX package's
``Stitcher`` on the CPU: records (offsets, confidences, directions, scales,
attempts) and panoramas equal.

  * ``use_pallas=False``: every pool through the XLA detector, which is
    what the JAX package runs off the TPU whatever ``use_pallas`` says,
    the oriented fallback included (an unrelated frame makes the last pair
    fail with some valid matches);
  * strict per-ROI detection with CLAHE and translation RANSAC;
  * whole-image ``feature`` with equalization and homography RANSAC;
  * the pooled path with homography RANSAC, pools routed as on a TPU
    (test_torch_jax_chain.route_pools_as_on_tpu);
  * the CLI's enhancement and offset flags, files against the JAX CLI's.

The RANSAC sequences hold no unrelated frame: with RANSAC any four random
matches fit a homography and "register" (the reference's own incomplete
estimator), at an offset that the two packages' float32 solves place
differently (test_torch_ransac.py)."""
import os

import jax
import numpy as np
import pytest

from imagestitch_tpu import EnhanceConfig as JEnhanceConfig
from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import feature_registration as jfr
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.ops.features import detect as tdetect
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import (assert_segments_equal,
                                  route_pools_as_on_tpu, stitch_both,
                                  two_threads)

H, W = 160, 224


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def frames():
    """A 3-frame column and a 2-frame row of one texture, fractional true
    offsets, and a frame of another texture."""
    pos = synthetic.serpentine_positions(3, 2, (131.37, 180.21))[:4]
    seq, truth = synthetic.sequence(5, (H, W), pos)
    other, _ = synthetic.sequence(98, (H, W), [(0.5, 0.5)])
    return np.concatenate([seq, other]), truth


def static_clip(monkeypatch):
    """The JAX package's strict attempt passes ``enhance_clip`` traced,
    and CLAHE needs it as a number (``int()`` of the clip limit), so its
    ``feature_incre`` with CLAHE raises ConcretizationTypeError; this
    re-jits the same function with the clip limit static (no file of the
    JAX package changes)."""
    f = jfr._feature_attempt_pairs_jit
    monkeypatch.setattr(jfr, "_feature_attempt_pairs_jit", jax.jit(
        f.__wrapped__, static_argnames=(
            "direction", "ratio", "max_kp", "dparams", "sparams", "metric",
            "vote_method", "enhance_mode", "enhance_tiles", "use_pallas",
            "enhance_clip")))


def _jcfg(**kw):
    feat = kw.pop("features", {})
    return JStitchConfig(roi_ratio=0.2, color_mode=False, **kw,
                         features=JFeatureConfig(max_keypoints=256,
                                                 pool_keypoints=768, **feat))


def _assert_like(got, ref, truth, n_ok, px=1):
    """Equal to the JAX package's; the first ``n_ok`` pairs registered
    within ``px`` of the truth (unless ``px`` is None)."""
    assert_segments_equal(got, ref)
    g, r = got[0].report, ref[0].report
    for f in ("offsets", "confidences", "directions", "scales", "attempts"):
        assert getattr(g, f) == getattr(r, f), f
    assert g.num_ok == n_ok
    for o, t in zip(g.offsets[:n_ok] if px else [], truth):
        assert np.abs(np.subtract(o, t)).max() < px


def test_use_pallas_false_is_the_xla_pool(frames, monkeypatch):
    """F4: the XLA pool, upright then oriented for the failed pair; no
    kernel pool runs."""
    seq, truth = frames
    used = []
    for name in ("score_map_pool", "detect_describe_image"):
        monkeypatch.setattr(tfr, name, lambda *a, **k: used.append(name))
    calls = []
    orig = tdetect.detect_describe_image
    monkeypatch.setattr(tdetect, "detect_describe_image",
                        lambda img, *a: calls.append(img.shape) or
                        orig(img, *a))
    got, ref = stitch_both(seq, _jcfg(use_pallas=False))
    _assert_like(got, ref, truth, 3)
    assert used == [] and calls == [(H, W)] * 7   # 5 upright, 2 oriented
    assert [r.file_range for r in got] == [(0, 4), (4, 5)]


def test_strict_clahe_ransac_translation(frames, monkeypatch):
    seq, truth = frames
    static_clip(monkeypatch)
    got, ref = stitch_both(seq[:4], _jcfg(
        offset_calculate="ransac_translation",
        enhance=JEnhanceConfig(enabled=True, use_clahe=True, clip_limit=4.0),
        features=dict(strict_roi_detect=True)))
    _assert_like(got, ref, truth, 3)


def test_feature_equalize_ransac(frames):
    seq, truth = frames
    got, ref = stitch_both(seq[:4], _jcfg(
        registration="feature", offset_calculate="ransac",
        enhance=JEnhanceConfig(enabled=True)))
    assert_segments_equal(got, ref)
    g, r = got[0].report, ref[0].report
    assert (g.offsets, g.confidences, g.num_ok) == (r.offsets,
                                                   r.confidences, r.num_ok)


def test_pooled_ransac_as_on_tpu(frames, monkeypatch):
    seq, truth = frames
    route_pools_as_on_tpu(monkeypatch)
    got, ref = stitch_both(seq[:4], _jcfg(offset_calculate="ransac"))
    # the first attempt of every pair is accepted: the column pairs near
    # their truth (the translation column of a homography fit to 45-row
    # strips, within 3 px), the row pair at a coincidental fit of its
    # direction-1 strips, as the JAX package's records have them too
    _assert_like(got, ref, truth, 3, px=None)
    assert [s for s in got[0].report.scales] == [1, 1, 1]


def test_cli_enhance_and_offset_flags(frames, tmp_path, monkeypatch):
    """``--enhance --clahe --clip-limit --tile-size --offset-calculate``
    run through the port's CLI: the files it writes equal the JAX CLI's
    (its strict attempt re-jitted with the clip limit static)."""
    from imagestitch_tpu import cli as jcli
    from imagestitch_tpu.io import prefetch as jprefetch
    from imagestitch_tpu_torch import cli
    from imagestitch_tpu_torch.io import codec
    seq, _ = frames
    proj = tmp_path / "proj"
    for i, im in enumerate(seq[:3]):
        codec.imwrite(str(proj / "1" / f"tile_{i}.png"), im)
    args = ["--file-extension", "png", "--output-extension", "png", "--gray",
            "--roi-ratio", "0.2", "--max-keypoints", "256", "--enhance",
            "--clahe", "--clip-limit", "4", "--tile-size", "4",
            "--offset-calculate", "ransac_translation", "--quiet"]
    assert cli.main(["stitch", str(proj), str(tmp_path / "t"), "--device",
                     "cpu"] + args) == 0
    static_clip(monkeypatch)
    monkeypatch.setattr(jprefetch, "_warm_pool_programs_async",
                        lambda *a, **k: None)
    assert jcli.main(["stitch", str(proj), str(tmp_path / "j")] + args) == 0
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "stitching_result_1.png"]
    np.testing.assert_array_equal(
        codec.imread(str(tmp_path / "t" / names[0]), False),
        codec.imread(str(tmp_path / "j" / names[0]), False))
