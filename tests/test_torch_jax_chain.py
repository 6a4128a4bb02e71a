"""The JAX package's registration chain as it runs on a TPU, run on the CPU
as the oracle of the port's parity tests (helpers only: no tests here).

The JAX package gates every Pallas call on a TPU backend
(imagestitch_tpu/core/feature_registration.py:394, :650, :786), so on the
CPU its own entry points would take the XLA detector, which is not the path
the port follows.  ``route_pools_as_on_tpu`` patches two names for one test,
and changes no file of the JAX package:
  * ``ops.pallas.doh.doh_score_map`` runs in interpret mode
    (``_detect_describe_image_pallas`` imports the module at call time, so
    the patch reaches it);
  * ``core.feature_registration._pool_features_jit`` maps every frame
    through the pool the TPU dispatch picks (its ``per_image``): the fused
    pool (``_detect_describe_image_pallas_v2``, interpret mode) for upright
    SURF with ``fused_select``, the score-map pool
    (``_detect_describe_image_pallas``) for the other Gaussian-DoH frames,
    and the XLA detector (``detect.detect_describe_image``) for the corner
    (ORB) and box-filter families.
Then the JAX entry points themselves run: ``register_sequence_features_incre``
with its oriented fallback, ``register_sequence_features`` with its
oriented retry, and ``Stitcher.stitch_batch``.  The matchers stay on the
XLA path, which computes the same function as the Pallas matchers (the
kernels themselves are held against the port in test_torch_feature_whole.py
and test_torch_match_vote.py).
"""
import functools

import jax
import numpy as np
import torch

from imagestitch_tpu import Stitcher as JStitcher
from imagestitch_tpu.core import feature_registration as jfr
from imagestitch_tpu.io.dataset import ImageBatch as JImageBatch
from imagestitch_tpu.ops.pallas import doh as jdoh
from imagestitch_tpu_torch import Stitcher
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.io.dataset import ImageBatch


def route_pools_as_on_tpu(monkeypatch):
    monkeypatch.setattr(jdoh, "doh_score_map",
                        functools.partial(jdoh.doh_score_map, interpret=True))

    def pools(images, max_pool, dparams, sparams, use_pallas_doh=False,
              fused_select=False):
        def per_image(img):
            if fused_select and jfr._fused_select_ok(dparams, sparams):
                return jfr._detect_describe_image_pallas_v2(
                    img, dparams, sparams, interpret=True)
            if dparams.family == "hessian" and not dparams.box_filter:
                return jfr._detect_describe_image_pallas(img, max_pool,
                                                         dparams, sparams)
            return jfr.detect.detect_describe_image(img, max_pool, dparams,
                                                    sparams)
        return jax.lax.map(per_image, images)

    monkeypatch.setattr(jfr, "_pool_features_jit", pools)


def count_score_map_frames(monkeypatch, tfr):
    """Count the frames the port's score-map pool describes."""
    calls = []
    orig = tfr.score_map_pool

    def counted(img, *args, **kw):
        calls.append(tuple(img.shape))
        return orig(img, *args, **kw)

    monkeypatch.setattr(tfr, "score_map_pool", counted)
    return calls


def assert_records_equal(got, ref, subpix_atol=1e-4):
    """Integer fields bit-equal; the sub-pixel mean to ``subpix_atol`` px (a
    float32 mean over up to k_sel matches, summed in another order)."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.ok, g.offset, g.direction, g.scale, g.confidence,
                g.attempts) == (r.ok, r.offset, r.direction, r.scale,
                                r.confidence, r.attempts), (g, r)
        np.testing.assert_allclose(g.offset_subpix, r.offset_subpix,
                                   rtol=0, atol=subpix_atol)


def stitch_both(frames, jcfg):
    """(port results, JAX results) of ``stitch_batch`` on gray frames."""
    files = [f"f{i}" for i in range(len(frames))]
    ref = JStitcher(jcfg).stitch_batch(
        JImageBatch(gray=frames, color=None, files=files))
    got = Stitcher(config_from_jax(jcfg), device="cpu").stitch_batch(
        ImageBatch(gray=frames, color=None, files=files))
    return got, ref


def assert_segments_equal(got, ref):
    """Same segments, offsets and bit-equal uint8 panoramas."""
    assert [r.file_range for r in got] == [r.file_range for r in ref]
    assert [r.offsets for r in got] == [r.offsets for r in ref]
    for g, r in zip(got, ref):
        assert g.image.dtype == np.uint8
        np.testing.assert_array_equal(g.image, np.asarray(r.image))


def two_threads():
    """Test workers share the machine's cores; PyTorch's default of one
    thread per core each makes them stall one another.  Use as the body of
    a module-scoped autouse fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
