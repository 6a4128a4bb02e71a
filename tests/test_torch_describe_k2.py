"""K2 (describe_atlas) without a per-call copy, and its CUDA kernel at the
edges of its domain.  The Gaussian window table is built once per device;
the SURF of sample windows equals the JAX package's; on a GPU the kernel
agrees with its plain version within 1e-5 (another summation order) at the
fused pool's 11,616 keypoints, at counts that are not a multiple of the
keypoints per block, at none, and with window starts clamped at all four
atlas edges."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagestitch_tpu.ops.features import describe as jdescribe
from imagestitch_tpu_torch import FeatureConfig, StitchConfig
from imagestitch_tpu_torch.core import feature_registration as freg
from imagestitch_tpu_torch.ops.features import describe as tdescribe
from imagestitch_tpu_torch.ops.kernels import describe as tkdesc
from imagestitch_tpu_torch.utils import synthetic

ATOL = 1e-5


def test_weight_table_built_once_per_device(monkeypatch):
    calls = []
    weight = tdescribe.window_weight
    monkeypatch.setattr(tdescribe, "window_weight",
                        lambda: calls.append(1) or weight())
    monkeypatch.setattr(tdescribe, "_WEIGHT_TABLES", {})
    rng = np.random.default_rng(0)
    atlas = torch.as_tensor((rng.random((64, 80)) * 255).astype(np.float32))
    starts = torch.as_tensor(rng.integers(0, 40, 6).astype(np.int32))
    for _ in range(2):
        tkdesc.describe_atlas(atlas, starts, starts)
        tdescribe.describe_batch(atlas[None], starts[None].float() + 9,
                                 starts[None].float() + 9,
                                 tdescribe.DescribeParams(upright=True))
        tdescribe.describe_from_pyramid(
            [atlas, atlas[::2, ::2].contiguous()], starts.float() + 9,
            starts.float() + 9, torch.as_tensor([0, 1, 0, 1, 0, 1]),
            tdescribe.DescribeParams(upright=True))
    assert len(calls) == 1
    assert tdescribe.weight_table("cpu") is tdescribe.weight_table(
        torch.device("cpu"))


@pytest.mark.parametrize("extended", [True, False])
def test_describe_windows_matches_jax(extended):
    q = (np.random.default_rng(1).random((40, 18, 18)) * 255).astype(
        np.float32)
    gw = jdescribe._gauss_weight(16, 8.0) * 256
    gx, gy = jdescribe._grads_from_samples(jnp.asarray(q))
    ref = np.asarray(jdescribe._surf_from_grads(gx * gw, gy * gw, extended))
    got = tdescribe.describe_windows(torch.as_tensor(q), extended)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _against_plain(atlas, r0, c0):
    for extended in (True, False):
        before = tkdesc.LAUNCHES
        got = tkdesc.describe_atlas(atlas, r0, c0, extended=extended)
        assert tkdesc.LAUNCHES == before + 1
        ref = tkdesc.describe_atlas(atlas, r0, c0, extended=extended,
                                    use_kernel=False)
        assert got.shape == (r0.numel(), 128 if extended else 64)
        torch.testing.assert_close(got, ref, rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_cuda_fused_pool_keypoints(cuda_device):
    frame = synthetic.sequence(7, (1936, 2584), [(0.5, 0.5)])[0][0]
    dparams = freg._detect_params(StitchConfig(features=FeatureConfig(
        upright=True)))
    _, _, _, atlas, r0, c0 = freg.select_candidates(
        torch.as_tensor(frame, device=cuda_device), dparams)
    assert r0.numel() == 11616
    _against_plain(atlas, r0, c0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 9, 1001])
def test_cuda_ragged_counts(cuda_device, k):
    rng = np.random.default_rng(k)
    atlas = torch.as_tensor((rng.random((300, 500)) * 255).astype(
        np.float32), device=cuda_device)
    r0, c0 = (torch.as_tensor(rng.integers(0, n - 18, k).astype(np.int32),
                              device=cuda_device) for n in (300, 500))
    _against_plain(atlas, r0, c0)


@pytest.mark.cuda
def test_cuda_no_keypoints(cuda_device):
    atlas = torch.rand(64, 64, device=cuda_device)
    none = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    before = tkdesc.LAUNCHES
    assert tkdesc.describe_atlas(atlas, none, none).shape == (0, 128)
    assert tkdesc.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_starts_clamped_at_every_edge(cuda_device):
    rng = np.random.default_rng(2)
    ah, aw = 120, 200
    atlas = torch.as_tensor((rng.random((ah, aw)) * 255).astype(np.float32),
                            device=cuda_device)
    r0 = [-30, -1, ah - 18, ah + 5, 50, 50, 50, 50, -9, ah + 40]
    c0 = [60, 60, 60, 60, -25, -1, aw - 18, aw + 7, -9, aw + 40]
    _against_plain(atlas, *(torch.as_tensor(v, dtype=torch.int32,
                                            device=cuda_device)
                            for v in (r0, c0)))
