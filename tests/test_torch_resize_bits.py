"""The port's ``jax.image.resize`` (ops/fusion/pyramid.py:
``resize_weights``, ``_resize_to``) bit for bit against jax's compiled
resize on the CPU, and its users: the multiband and seam pyramids, the
ORB levels and ``utils/image.resize``.

The oracle for the weights is jax's own resize of an identity matrix,
``jax.image.resize(eye(m), (n, m), method)``: every output is one weight
times one, so it reads the weights XLA applies exactly.

The orders are those of XLA's CPU code with jaxlib 0.9 on x86-64
(AVX-512, 8 threads), where LLVM's unrolling and vectorisation and
Eigen's blocking decide the rounding (the module docstring says how).
Shapes still open (fault F8 in ROADMAP's Queue 3), each held by its
measured bound:
  * cubic weights from m = 4, 8, 19, 22, 28, 29 and 31 samples (to
    m - 1): at most 22% of the entries (m = 8), each within 4e-7;
  * linear weights from 257 to 214 samples: 2 entries, within 1.1e-5;
  * the columns of up to 50 rows from 318 or 400 columns (Eigen blocks
    that product at 128-256 columns, and past 256 not as plain sums of
    chains): at most 0.4% of the values, within 1e-4 on 0-255 data.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagestitch_tpu.ops.fusion import pyramid as jpyr
from imagestitch_tpu.utils import image as jimage
from imagestitch_tpu_torch.ops.features import detect as tdetect
from imagestitch_tpu_torch.ops.fusion import pyramid as tpyr
from imagestitch_tpu_torch.utils import image as timage
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import two_threads

#: (m, m - 1) cubic weights still open, and linear (m, n) ones
CUBIC_OPEN = {4, 8, 19, 22, 28, 29, 31}
#: the ORB levels of 1936 x 2584 and 480 x 640 at scale 1.2, and
#: ``utils/image.resize``'s factors
LINEAR_EXACT = [(1936, 1613), (1936, 1344), (1936, 1120), (1936, 934),
                (1936, 778), (1936, 648), (1936, 540), (2584, 2153),
                (2584, 1794), (2584, 1495), (2584, 1246), (2584, 1038),
                (2584, 865), (2584, 721), (480, 400), (640, 533),
                (448, 373), (320, 267), (100, 37), (80, 29), (257, 64),
                (257, 95), (481, 177), (641, 237), (1936, 968)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _jax_weights(m, n, method):
    eye = jnp.eye(m, dtype=jnp.float32)
    return np.asarray(jax.jit(
        lambda e: jax.image.resize(e, (n, m), method))(eye)).T


def _jax_resize(x, target, method):
    return np.asarray(jax.jit(
        lambda v: jax.image.resize(v, target, method))(x))


def _data(shape, seed=0):
    return (np.random.default_rng(seed).random(shape, dtype=np.float32)
            * 255).astype(np.float32)


def test_cubic_weights_match_jax():
    """The multiband path's m -> m - 1 downscales, m from 3 to 400."""
    for m in sorted(set(range(3, 66)) | set(range(66, 401, 11))
                    | {96, 97, 98}):
        got = tpyr.resize_weights(m, m - 1, "cubic")
        ref = _jax_weights(m, m - 1, "cubic")
        if m in CUBIC_OPEN:
            assert (got != ref).mean() <= 0.22, m
            np.testing.assert_allclose(got, ref, rtol=0, atol=4e-7)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=str(m))


def test_linear_weights_match_jax():
    for m, n in LINEAR_EXACT:
        np.testing.assert_array_equal(tpyr.resize_weights(m, n, "linear"),
                                      _jax_weights(m, n, "linear"),
                                      err_msg=str((m, n)))
    got = tpyr.resize_weights(257, 214, "linear")
    ref = _jax_weights(257, 214, "linear")
    assert (got != ref).sum() <= 2
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.1e-5)


@pytest.mark.parametrize("h,w", [(34, 80), (68, 134), (128, 160)])
def test_odd_level_targets_bit_equal(h, w):
    """The multiband path's odd-level targets (2h - 1, 2w), (2h, 2w - 1)
    and (2h - 1, 2w - 1) of a (2h, 2w) pyrUp, through jax's standalone
    resize and through jitted ``jpyr._resize_to``."""
    x = _data((2 * h, 2 * w), seed=h)
    for target in ((2 * h - 1, 2 * w), (2 * h, 2 * w - 1),
                   (2 * h - 1, 2 * w - 1)):
        got = tpyr._resize_to(torch.from_numpy(x), target).numpy()
        np.testing.assert_array_equal(got, _jax_resize(x, target, "cubic"))
        ref = np.asarray(jax.jit(lambda v: jpyr._resize_to(v, target))(x))
        np.testing.assert_array_equal(got, ref)


def test_contraction_orders_across_shapes():
    """The column contraction of data (rows, w) by its weights follows
    ``_data_lhs_order``: a chain up to 50 rows, else two lanes, four
    lanes or a chain by the output width mod 64, each region below with
    and without a tail of the lanes' blocks; Eigen's blocks of 512 in the
    chain beyond 512 columns, and of the rows' summed axis beyond 464
    rows (968 -> 967).  The open shapes (the module docstring) within
    their bound."""
    for rows in (40, 50, 51, 64, 968):
        for w in (26, 35, 50, 68, 99, 134, 318, 400, 600):
            x = _data((rows, w), seed=w)
            got = tpyr._resize_to(torch.from_numpy(x), (rows, w - 1)).numpy()
            ref = _jax_resize(x, (rows, w - 1), "cubic")
            if rows <= 50 and w in (318, 400):
                assert (got != ref).mean() <= 4e-3, (rows, w)
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
            else:
                np.testing.assert_array_equal(got, ref,
                                              err_msg=str((rows, w)))
    x = _data((968, 68), seed=968)
    np.testing.assert_array_equal(
        tpyr._resize_to(torch.from_numpy(x), (967, 68)).numpy(),
        _jax_resize(x, (967, 68), "cubic"))


def test_linear_resize_at_integer_ratios_bit_equal():
    """``utils/image.resize``'s halving and quartering, one axis and both."""
    x = _data((256, 320), seed=5)
    for target in ((128, 160), (64, 80), (256, 160), (128, 320)):
        got = tpyr._resize_to(torch.from_numpy(x), target, "linear").numpy()
        np.testing.assert_array_equal(got,
                                      _jax_resize(x, target, "linear"))


def test_utils_resize_bit_equal():
    """tests/test_torch_utils_image.py's frames and factors, gray and BGR:
    every uint8 value equal."""
    rng = np.random.default_rng(0)
    smooth = synthetic.sequence(3, (481, 641), [(0.3, 0.6)])[0][0]
    frames = [rng.integers(0, 256, (100, 80), np.uint8),
              rng.integers(0, 256, (257, 333), np.uint8), smooth]
    for img in frames + [np.stack([f, 255 - f, f[::-1]], -1)
                         for f in frames[:2]]:
        for t in (0.5, 0.25, 0.37):
            np.testing.assert_array_equal(timage.resize(img, t, device="cpu"),
                                          jimage.resize(img, t))


def test_orb_levels_bit_equal():
    """The ORB pyramid's levels (scale 1.2) of a 240 x 320 test frame and
    of a full 1936 x 2584 one (Eigen's blocks of the rows, the two- and
    four-lane blocks of the columns), and the vmapped resize of
    ``detect_batch``."""
    for img in (synthetic.sequence(5, (240, 320), [(0.3, 0.6)])[0][0],
                _data((1936, 2584), seed=1)):
        img = img.astype(np.float32)
        levels = tdetect._corner_levels(torch.from_numpy(img),
                                        tdetect.DetectParams(family="corner"))
        assert len(levels) > 3
        for lvl, xl, _ in levels[1:]:
            np.testing.assert_array_equal(
                xl.numpy(), _jax_resize(img, tuple(xl.shape), "linear"),
                err_msg=str(lvl))
    hs, ws = levels[1][1].shape
    ref = np.asarray(jax.jit(jax.vmap(lambda v: jax.image.resize(
        v, (hs, ws), "linear")))(img[None]))[0]
    np.testing.assert_array_equal(levels[1][1].numpy(), ref)


def test_multiband_jitted_bit_equal():
    """``blend_half`` and ``blend_masked`` on odd sizes against the JAX
    functions jitted whole, as the composer runs them."""
    a, b = _data((73, 133), 1), _data((73, 133), 2)
    region = (_data((73, 133), 3) > 128).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        tpyr.blend_half(ta, tb, 4).numpy(),
        np.asarray(jax.jit(lambda u, v: jpyr.blend_half(u, v, 4))(a, b)))
    np.testing.assert_array_equal(
        tpyr.blend_masked(ta, tb, torch.from_numpy(region), 4).numpy(),
        np.asarray(jax.jit(lambda u, v, r: jpyr.blend_masked(u, v, r, 4))(
            a, b, region)))
