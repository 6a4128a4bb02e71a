"""The port's threefry2x32 bits (ops/features/prng.py) and RANSAC's sampled
indices against jax.random, bit for bit.

jax's defaults here: threefry2x32 keys, ``jax_threefry_partitionable=True``,
64-bit types off; the port reproduces ``PRNGKey``, ``split`` and
``uniform`` under those defaults."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagestitch_tpu.ops.features import ransac as jransac
from imagestitch_tpu_torch.ops.features import prng
from imagestitch_tpu_torch.ops.features import ransac as transac
from test_torch_jax_chain import two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def test_defaults_are_the_ones_reproduced():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", [0, 0x5713, 2 ** 31 - 1, -7])
def test_key_and_split_bit_equal(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    for num in (1, 2, 7, 16, 64):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(jk, num)).astype(np.int64),
            prng.split(tk, num).numpy())


@pytest.mark.parametrize("shape", [(1,), (7, 3), (128, 33), (3, 11, 5)])
def test_uniform_bit_equal(shape):
    for seed in (0x5713, 42):
        jkeys = jax.random.split(jax.random.PRNGKey(seed), 5)
        ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
            jkeys))
        tu = prng.uniform(prng.split(prng.prng_key(seed), 5), shape).numpy()
        assert ju.dtype == tu.dtype == np.float32
        np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))


def test_sample_indices_equal_jax_top_k(rng):
    """Each pair's (128, 4) sample equals what ``_ransac_one`` draws:
    ``lax.top_k`` of its keys, invalid slots -1 (so pairs with fewer than 4
    valid slots take the lowest invalid ones), ties to the lower index; the
    key of a pair is its slot of the JAX call, here P = 6 and K = 37."""
    p, k = 6, 37
    valid = rng.random((p, k)) < 0.5
    valid[1] = False
    valid[2, :] = False
    valid[2, [3, 30]] = True
    keys = jax.random.split(jax.random.PRNGKey(jransac._SEED), p)

    def one(key, v):
        u = jax.random.uniform(key, (jransac.N_ITERS, k))
        return jax.lax.top_k(jnp.where(v[None, :], u, -1.0), 4)[1]

    ref = np.asarray(jax.vmap(one)(keys, valid))
    got = transac.sample_indices(torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, ref)
    # a pair drawn as slot 2 of a 6-pair call, alone
    alone = transac.sample_indices(torch.from_numpy(valid[2:3]),
                                   draws=[(p, 2)]).numpy()
    np.testing.assert_array_equal(alone[0], ref[2])
