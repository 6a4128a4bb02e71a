"""K2 (describe_atlas) and the upright SURF helpers: the port's plain version
against the Pallas kernel in interpret mode and against the XLA
describe_batch / describe_from_pyramid; the CUDA kernel against the plain
version on a GPU.  Tolerance 1e-5 absolute on unit-norm descriptors: the
Pallas kernel pools with a matmul and sums in another order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagestitch_tpu.ops.features import describe as jdescribe
from imagestitch_tpu.ops.pallas import describe as jpdesc
from imagestitch_tpu_torch.ops.features import describe as tdescribe
from imagestitch_tpu_torch.ops.kernels import describe as tkdesc

ATOL = 1e-5


def _atlas_case(seed, n=96):
    rng = np.random.default_rng(seed)
    hp, wp = 2 * jpdesc.BAND + jpdesc.HALO, 512
    atlas = (rng.random((hp, wp)) * 255).astype(np.float32)
    rows = np.sort(rng.uniform(12, hp - 12, n)).astype(np.float32)
    cols = rng.uniform(0, wp - 1, n).astype(np.float32)
    # keypoints at the edges exercise the clamped (CLIP) window starts
    cols[:4] = [0.0, 3.4, wp - 1.0, wp - 5.6]
    return atlas, rows, cols


def _starts(rows, cols, hp, wp):
    r0 = np.clip(np.round(rows).astype(np.int32) - tkdesc.MARGIN, 0,
                 hp - tkdesc.WIN)
    c0 = np.clip(np.round(cols).astype(np.int32) - tkdesc.MARGIN, 0,
                 wp - tkdesc.WIN)
    return r0, c0


@pytest.mark.parametrize("extended", [True, False])
def test_plain_matches_pallas_interpret(extended):
    atlas, rows, cols = _atlas_case(0)
    hp, wp = atlas.shape
    r0, c0 = _starts(rows, cols, hp, wp)
    ca = np.clip((c0 // 128) * 128, 0, wp - jpdesc._READ_W)
    rm = np.round(rows).astype(np.int32)
    bs = np.searchsorted(rm, np.arange(3) * jpdesc.BAND + jpdesc._MARGIN + 1
                         ).astype(np.int32)
    ref = np.asarray(jpdesc.describe_atlas(
        jnp.asarray(atlas), jnp.asarray(r0), jnp.asarray(ca),
        jnp.asarray(c0 - ca), jnp.asarray(bs), extended=extended,
        interpret=True))
    got = tkdesc.describe_atlas(torch.as_tensor(atlas), torch.as_tensor(r0),
                                torch.as_tensor(c0), extended=extended)
    assert got.shape == (len(rows), 128 if extended else 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("extended", [True, False])
def test_describe_batch_matches_xla(extended):
    atlas, rows, cols = _atlas_case(1)
    sp_j = jdescribe.DescribeParams(
        family="surf-extended" if extended else "surf", upright=True)
    sp_t = tdescribe.DescribeParams(
        family="surf-extended" if extended else "surf", upright=True)
    ref = np.asarray(jdescribe.describe_batch(
        jnp.asarray(atlas)[None], jnp.asarray(rows)[None],
        jnp.asarray(cols)[None], sp_j)[0])
    got = tdescribe.describe_batch(torch.as_tensor(atlas)[None],
                                   torch.as_tensor(rows)[None],
                                   torch.as_tensor(cols)[None], sp_t)[0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    # the atlas kernel's plain version is the same function of the starts
    r0, c0 = _starts(rows, cols, *atlas.shape)
    k = tkdesc.describe_atlas(torch.as_tensor(atlas), torch.as_tensor(r0),
                              torch.as_tensor(c0), extended=extended)
    torch.testing.assert_close(k, got, rtol=0, atol=0)


def test_describe_from_pyramid_matches_xla():
    rng = np.random.default_rng(2)
    octs = [(rng.random((h, w)) * 255).astype(np.float32)
            for h, w in ((120, 160), (60, 80), (30, 40))]
    n = 60
    oid = rng.integers(0, 3, n)
    r_loc = np.asarray([rng.uniform(0, octs[o].shape[0] - 1) for o in oid],
                       np.float32)
    c_loc = np.asarray([rng.uniform(0, octs[o].shape[1] - 1) for o in oid],
                       np.float32)
    sp_j = jdescribe.DescribeParams(family="surf-extended", upright=True)
    sp_t = tdescribe.DescribeParams(family="surf-extended", upright=True)
    ref = np.asarray(jdescribe.describe_from_pyramid(
        [jnp.asarray(o) for o in octs], jnp.asarray(r_loc),
        jnp.asarray(c_loc), jnp.asarray(oid), sp_j))
    got = tdescribe.describe_from_pyramid(
        [torch.as_tensor(o) for o in octs], torch.as_tensor(r_loc),
        torch.as_tensor(c_loc), torch.as_tensor(oid), sp_t)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    # SIFT is not ported yet (oriented SURF is: tests/test_torch_oriented.py)
    with pytest.raises(NotImplementedError, match="item 17"):
        tdescribe.describe_batch(torch.as_tensor(octs[0])[None],
                                 torch.zeros(1, 1), torch.zeros(1, 1),
                                 tdescribe.DescribeParams(family="sift"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("extended", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, extended):
    atlas, rows, cols = _atlas_case(3, n=1000)
    r0, c0 = _starts(rows, cols, *atlas.shape)
    args = [torch.as_tensor(a, device=cuda_device) for a in (atlas, r0, c0)]
    before = tkdesc.LAUNCHES
    got = tkdesc.describe_atlas(*args, extended=extended)
    assert tkdesc.LAUNCHES == before + 1
    ref = tkdesc.describe_atlas(*args, extended=extended, use_kernel=False)
    torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)
