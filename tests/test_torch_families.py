"""The other detector and descriptor families of the port against the JAX
package's, as its jitted CPU code runs them: box-filter SURF, FAST-9 and
Harris over the ORB pyramid, SIFT-128, ORB's BRIEF bits (``wta_k`` 2 and
3) and Hamming matching.

Tolerances, each held where it is stated:
  * the box-filter response, the FAST-9 mask and the Harris response:
    bit-equal (the integral image in XLA's blocks of 16, the fused
    multiply-adds of XLA's CPU code);
  * the linear resize of the ORB levels: weights and levels bit-equal
    (ops/fusion/pyramid.py rounds as jax's compiled resize), so the FAST
    gates equal too;
  * corner positions within 1e-4 px (two sub-pixel columns of 512 one
    ulp apart) and Harris scores within 1e-5 relative, the same keypoints
    in the same order;
  * box-filter positions, scores and upright descriptors bit-equal or
    within 1e-5; SIFT within 1e-5 upright (glibc's atan2f, which XLA's CPU
    code calls, so the same bins); oriented SIFT within 1e-5 on all but 2%
    of the descriptors (1 row of 300 at this seed): the port mirrors the
    orientation and the rotation bit for bit, but XLA recomputes the
    rotated grid in each of its fusions with FMAs placed per fusion, and a
    gradient that moves by an ulp can move its magnitude into the next bin
    (test_torch_oriented_sift.py);
  * ORB bits and Hamming matches bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from imagestitch_tpu.ops.features import describe as jdescribe
from imagestitch_tpu.ops.features import detect as jdetect
from imagestitch_tpu.ops.features import match as jmatch
from imagestitch_tpu_torch.ops.features import describe as tdescribe
from imagestitch_tpu_torch.ops.features import detect as tdetect
from imagestitch_tpu_torch.ops.features import match as tmatch
from imagestitch_tpu_torch.ops.fusion import pyramid as tpyr
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def image():
    return synthetic.sequence(5, (240, 320), [(0.3, 0.6)])[0][0].astype(
        np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_box_hessian_response_bit_equal(image):
    """Every filter size of three octave layers and the layer-max octave
    response; then the integral image of a 700 x 900 frame of about 200,
    whose sums pass 2^24 (1.3e8), where XLA's summation order decides the
    low bits."""
    for size in (9, 15, 21):
        ref = jax.jit(lambda v: jdetect.box_hessian_response(v, size))(image)
        got = tdetect.box_hessian_response(_t(image), size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    big = np.full((700, 900), 200.0, np.float32) + image[:1, :1]
    np.testing.assert_array_equal(
        tdetect._integral_pad(_t(big), 9).numpy(),
        np.asarray(jax.jit(lambda v: jdetect._integral_pad(v, 9))(big)))
    p = jdetect.DetectParams(box_filter=True)
    np.testing.assert_array_equal(
        tdetect.octave_response(_t(image), tdetect.DetectParams(
            box_filter=True)).numpy(),
        np.asarray(jax.jit(lambda v: jdetect.octave_response(v, p))(image)))


def test_fast9_mask_and_harris_response_bit_equal(image):
    for thr in (10.0, 20.0):
        np.testing.assert_array_equal(
            tdetect.fast9_mask(_t(image), thr).numpy(),
            np.asarray(jax.jit(lambda v: jdetect.fast9_mask(v, thr))(image)))
    np.testing.assert_array_equal(
        tdetect.harris_response(_t(image)).numpy(),
        np.asarray(jax.jit(jdetect.harris_response)(image)))
    np.testing.assert_array_equal(
        tdetect.fast_corner_response(_t(image)).numpy(),
        np.asarray(jax.jit(jdetect.harris_response)(image)))


def test_linear_resize_weights_and_levels(image):
    """The ORB pyramid's levels: jax.image.resize(..., "linear"), antialias
    on, at the default scale factor 1.2."""
    h, w = image.shape
    for lvl in range(1, 6):
        s = 1.2 ** lvl
        hs, ws = int(round(h / s)), int(round(w / s))
        for m, n in ((h, hs), (w, ws)):
            ref_w = jax.jit(lambda: jscale.compute_weight_mat(
                m, n, n / m, 0.0, jscale._fill_triangle_kernel, True))()
            np.testing.assert_array_equal(
                tpyr.resize_weights(m, n, "linear"), np.asarray(ref_w))
        ref = np.asarray(jax.jit(lambda v: jax.image.resize(
            v, (hs, ws), "linear"))(image))
        got = tpyr._resize_to(_t(image), (hs, ws), "linear").numpy()
        np.testing.assert_array_equal(got, ref)
        gate = lambda v: tdetect.fast9_mask(_t(v), 20.0).numpy()
        flips = (gate(got) != gate(ref)).sum()
        assert flips <= 1e-3 * hs * ws, (lvl, flips)


def test_detect_image_corner_matches_jax(image):
    """Eight levels spaced by 1.2 (the last ones stop at the 70-px floor),
    a budget below the candidates' count."""
    p = jdetect.DetectParams(family="corner")
    ref = jax.jit(lambda v: jdetect.detect_image_corner(v, 512, p))(image)
    got = tdetect.detect_batch(_t(image)[None], 512,
                               tdetect.DetectParams(family="corner"))
    (rr, rc, rs), (gr, gc, gs) = (np.asarray(a) for a in ref), \
        (a[0].numpy() for a in got)
    assert (rs > 0).sum() == (gs > 0).sum() == 512
    np.testing.assert_allclose(gr, rr, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gc, rc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gs, rs, rtol=1e-5, atol=0)


@pytest.mark.parametrize("family", ["corner", "box"])
def test_detect_describe_image_matches_jax(image, family):
    """The corner branch (ORB bits, oriented, a level's describe at a
    time) and the box branch (upright SURF-128 over the atlas)."""
    corner = family == "corner"
    kw = dict(family="corner") if corner else dict(box_filter=True)
    sp = dict(family="orb" if corner else "surf-extended", upright=not corner)
    ref = jax.jit(lambda v: jdetect.detect_describe_image(
        v, 512, jdetect.DetectParams(**kw),
        jdescribe.DescribeParams(**sp)))(image)
    got = tdetect.detect_describe_image(
        _t(image), 512, tdetect.DetectParams(**kw),
        tdescribe.DescribeParams(**sp))
    (rr, rc, rs, rd), (gr, gc, gs, gd) = (np.asarray(a) for a in ref), \
        (a.numpy() for a in got)
    assert gd.shape == rd.shape == (512, 256 if corner else 128)
    tol = 1e-4 if corner else 0.0
    np.testing.assert_allclose(gr, rr, rtol=0, atol=tol)
    np.testing.assert_allclose(gc, rc, rtol=0, atol=tol)
    np.testing.assert_allclose(gs, rs, rtol=1e-5 if corner else 0, atol=0)
    np.testing.assert_allclose(gd, rd, rtol=0, atol=0 if corner else 1e-5)


def test_sift_descriptors_match_jax(image):
    """Upright within 1e-5; oriented: a bin moved on at most 2% of the
    descriptors (0.33% at this seed), the others within 1e-5."""
    rng = np.random.default_rng(4)
    rows = rng.uniform(16, 224, (1, 300)).astype(np.float32)
    cols = rng.uniform(16, 304, (1, 300)).astype(np.float32)
    for upright in (True, False):
        ref = np.asarray(jdescribe.describe_batch(
            jnp.asarray(image)[None], jnp.asarray(rows), jnp.asarray(cols),
            jdescribe.DescribeParams(family="sift", upright=upright)))[0]
        got = tdescribe.describe_batch(
            _t(image)[None], _t(rows), _t(cols),
            tdescribe.DescribeParams(family="sift", upright=upright))[0]
        assert got.shape == (300, tdescribe.descriptor_dim(
            tdescribe.DescribeParams(family="sift"))) == ref.shape
        err = np.abs(got.numpy() - ref).max(axis=1)
        if upright:
            assert err.max() <= 1e-5
        else:
            assert (err > 1e-5).mean() <= 0.02, (err > 1e-5).mean()


@pytest.mark.parametrize("wta_k", [2, 3])
def test_orb_bits_and_hamming_matches_bit_equal(image, wta_k):
    """Oriented BRIEF bits of two shifted frames, then nearest-neighbour
    Hamming matches between them (orbMaxDistance 30, doubled for wta_k >
    2 as feature_registration scales it), with masked train rows; the
    distances are integers, so ties are common and the first index wins
    on both sides."""
    rng = np.random.default_rng(wta_k)
    other = np.roll(image, (3, -2), axis=(0, 1))
    rows = rng.uniform(30, 210, (2, 256)).astype(np.float32)
    cols = rng.uniform(30, 290, (2, 256)).astype(np.float32)
    rows[1], cols[1] = rows[0] + 3.0, cols[0] - 2.0
    rows[1, ::7] = rng.uniform(30, 210, rows[1, ::7].shape)
    imgs = np.stack([image, other])
    ref = np.asarray(jdescribe.describe_batch(
        jnp.asarray(imgs), jnp.asarray(rows), jnp.asarray(cols),
        jdescribe.DescribeParams(family="orb", wta_k=wta_k)))
    got = tdescribe.describe_batch(_t(imgs), _t(rows), _t(cols),
                                   tdescribe.DescribeParams(family="orb",
                                                            wta_k=wta_k))
    assert got.shape[-1] == 256 * (wta_k if wta_k > 2 else 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    valid = np.ones((1, 256), bool)
    valid_b = valid.copy()
    valid_b[0, ::5] = False
    max_d = 30.0 * (2 if wta_k > 2 else 1)
    ti_r, ok_r = jax.jit(lambda a, b, va, vb: jmatch.match_batch(
        a, b, va, vb, 0.7, max_d, "hamming"))(ref[:1], ref[1:], valid,
                                                valid_b)
    ti, ok = tmatch.match_batch(got[:1], got[1:], _t(valid), _t(valid_b),
                                0.7, max_d, "hamming")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ti_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert 0 < ok.numpy().sum() < 256
    rb = _t(rows[1:])
    ti_c, ok_c, rb_sel, _ = tmatch.match_batch_coords(
        got[:1], got[1:], _t(valid), _t(valid_b), rb, _t(cols[1:]), 0.7,
        max_d, "hamming")
    assert torch.equal(ti_c, ti) and torch.equal(ok_c, ok)
    assert torch.equal(rb_sel, rb.gather(-1, ti))


@pytest.mark.cuda
def test_cuda_sift_score_map_pool_kernels_equal_plain():
    """The SIFT score-map pool on the card: K4 against its plain version
    (records of the pool bit-equal), oriented and upright; and the card's
    pool against the CPU's (the same keypoints; descriptors within 1e-5,
    oriented ones on all but 2% of the rows: the card's integral image of
    a patch sums in another order where its values are not integers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    from imagestitch_tpu_torch.core import feature_registration as tfr
    frames = synthetic.sequence(6, (480, 640), [(0.5, 0.5), (60.37, 9.21)])[0]
    dp = tdetect.DetectParams()
    for upright in (True, False):
        sp = tdescribe.DescribeParams(family="sift", upright=upright)
        dev = torch.as_tensor(frames).cuda()
        kern = tfr.pool_features(dev, dp, sp, max_pool=2048,
                                 fused_select=True, use_kernels=True)
        plain = tfr.pool_features(dev, dp, sp, max_pool=2048,
                                  fused_select=True, use_kernels=False)
        for a, b in zip(kern, plain):
            assert torch.equal(a, b)
        cpu = tfr.pool_features(torch.as_tensor(frames), dp, sp,
                                max_pool=2048, fused_select=True)
        for a, b in zip(kern[:3], cpu[:3]):
            assert torch.equal(a.cpu(), b)
        bad = (kern[3].cpu() - cpu[3]).abs().amax(dim=-1) > 1e-5
        assert bad.float().mean() <= (0.0 if upright else 0.02)
