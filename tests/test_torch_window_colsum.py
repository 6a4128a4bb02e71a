"""K6 ``window_colsum`` (ops/kernels/window_sum.py) against the oracle of
its TPU prototype, ``scripts/profile_r4_micro2.py``: the script's own numpy
check (:172-173, ``atlas[r0:r0+GR, ca:ca+GC].sum(0)[:128]``), applied to
every keypoint.  The Pallas prototype itself does not run under this
repository's JAX on the CPU, not even in interpret mode (its row store
``out_ref[i, :] = ...[None, :128]`` has the wrong rank), so the numpy check
is the oracle.  Inputs follow the script's distributions (:115-125) at
small shapes."""
import numpy as np
import pytest
import torch

from imagestitch_tpu_torch.ops.kernels import window_sum


def _inputs(seed, ha, wa, k, gr=24, gc=256):
    """The script's atlas (ha rows + one band of slack), sorted window rows
    in [0, ha - gr) and 128-aligned window columns with room for gc."""
    rng = np.random.default_rng(seed)
    atlas = rng.random((ha + 256, wa), np.float32)
    r0 = np.sort(rng.integers(0, ha - gr, k)).astype(np.int32)
    ca = (rng.integers(0, (wa - gc) // 128, k) * 128).astype(np.int32)
    return atlas, r0, ca


def _oracle(atlas, r0, ca, gr=24, gc=256):
    return np.stack([atlas[r:r + gr, c:c + gc].sum(0)[:128]
                     for r, c in zip(r0, ca)])


@pytest.mark.parametrize("ha, wa, k", [(512, 640, 200), (768, 1152, 333)])
def test_plain_matches_the_scripts_check(ha, wa, k):
    atlas, r0, ca = _inputs(ha + k, ha, wa, k)
    before = window_sum.LAUNCHES
    got = window_sum.window_colsum(torch.as_tensor(atlas),
                                   torch.as_tensor(r0), torch.as_tensor(ca))
    assert window_sum.LAUNCHES == before          # the CPU takes the plain one
    assert got.shape == (k, 128) and got.dtype == torch.float32
    # numpy sums the 24 rows in its own order: 1e-5 absolute at sums < 24
    np.testing.assert_allclose(got.numpy(), _oracle(atlas, r0, ca), rtol=0,
                               atol=1e-5)


def test_plain_sums_rows_in_order():
    """The plain version adds the rows one at a time from 0: exactly a
    float32 running sum, the kernel's order."""
    atlas, r0, ca = _inputs(3, 256, 512, 50)
    got = window_sum.window_colsum(torch.as_tensor(atlas), torch.as_tensor(r0),
                                   torch.as_tensor(ca), rows=5, cols=64)
    want = np.zeros((50, 64), np.float32)
    for i in range(5):
        want = want + np.stack([atlas[r + i, c:c + 64]
                                for r, c in zip(r0, ca)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_windows_outside_the_atlas_raise():
    atlas = torch.zeros(64, 256)
    ok = torch.zeros(2, dtype=torch.int32)
    low = torch.tensor([0, 41], dtype=torch.int32)    # 41 + 24 > 64 rows
    with pytest.raises(ValueError, match="leave"):
        window_sum.window_colsum(atlas, low, ok)
    with pytest.raises(ValueError, match="leave"):
        window_sum.window_colsum(atlas, ok,
                                 torch.tensor([-128, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="window"):
        window_sum.window_colsum(atlas, ok, ok, rows=65)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    """The kernel adds the rows in the plain version's order with
    __fadd_rn: bit-equal, at the prototype's shapes."""
    atlas, r0, ca = _inputs(0, 3840, 2688, 6144)
    args = [torch.as_tensor(x, device=cuda_device) for x in (atlas, r0, ca)]
    before = window_sum.LAUNCHES
    got = window_sum.window_colsum(*args)
    assert window_sum.LAUNCHES == before + 1
    ref = window_sum.window_colsum(*args, use_kernel=False)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    np.testing.assert_allclose(got[:64].cpu().numpy(),
                               _oracle(atlas, r0[:64], ca[:64]), rtol=0,
                               atol=1e-5)
