"""Contrast enhancement (ops/enhance.py) against the JAX package's:
``equalize_hist``, ``clahe`` and ``enhance_batch``, bit-equal uint8 frames
on divisible and non-divisible shapes (the non-divisible branch pads both
dimensions), a constant frame, and a clip limit that leaves a residual to
walk."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagestitch_tpu.ops import enhance as jenhance
from imagestitch_tpu_torch.ops import enhance as tenhance
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _frame(h, w, seed=0):
    """A synthetic micrograph with one dim third, so tiles differ."""
    img = synthetic.sequence(seed, (h, w), [(0.5, 0.5)])[0][0]
    img[: h // 3] //= 3
    return img


SHAPES = [(100, 120), (97, 131), (193, 2584)]


@pytest.mark.parametrize("shape", SHAPES)
def test_equalize_hist_bit_equal(shape):
    img = _frame(*shape)
    ref = np.asarray(jenhance.equalize_hist(jnp.asarray(img)))
    np.testing.assert_array_equal(
        tenhance.equalize_hist(torch.from_numpy(img)).numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_clahe_bit_equal(shape):
    img = _frame(*shape, seed=1)
    for clip, tiles in ((20.0, 5), (2.0, 8)):
        ref = np.asarray(jenhance.clahe(jnp.asarray(img), clip, tiles))
        got = tenhance.clahe(torch.from_numpy(img), clip, tiles).numpy()
        np.testing.assert_array_equal(got, ref)


def test_constant_frame():
    img = np.full((60, 75), 77, np.uint8)
    for fn, jfn in ((tenhance.equalize_hist, jenhance.equalize_hist),
                    (lambda x: tenhance.clahe(x, 20.0, 5),
                     lambda x: jenhance.clahe(x, 20.0, 5))):
        np.testing.assert_array_equal(fn(torch.from_numpy(img)).numpy(),
                                      np.asarray(jfn(jnp.asarray(img))))


@pytest.mark.parametrize("use_clahe", [False, True])
def test_enhance_batch_bit_equal(use_clahe):
    """The strip batches the strict attempt enhances: 3 strips of 39 x 224."""
    imgs = np.stack([_frame(39, 224, seed=s) for s in range(3)])
    ref = np.asarray(jenhance.enhance_batch(jnp.asarray(imgs), use_clahe,
                                            20.0, 5))
    got = tenhance.enhance_batch(torch.from_numpy(imgs), use_clahe, 20.0, 5)
    np.testing.assert_array_equal(got.numpy(), ref)
