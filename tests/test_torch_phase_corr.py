"""The port's phase correlation (ops/phase_corr.py, torch.fft) against the
JAX package's (XLA): the optimal DFT size, the shifts, responses and peaks
of phase_correlate_batch, odd padded sizes included, and the batch against
one pair at a time."""
import numpy as np
import pytest
import torch

from imagestitch_tpu.ops import phase_corr as jpc
from imagestitch_tpu_torch.ops import phase_corr as tpc
from test_torch_jax_chain import two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _texture(seed, shape):
    """Smooth random texture (a 3x3 box blur of uniform noise, twice)."""
    x = np.random.default_rng(seed).uniform(0, 255, shape)
    for _ in range(2):
        p = np.pad(x, 1, mode="edge")
        x = sum(p[i:i + shape[0], j:j + shape[1]]
                for i in range(3) for j in range(3)) / 9.0
    return x.astype(np.float32)


def test_optimal_dft_size_matches_jax():
    for n in [0, 1, 2, 3, 7, 16, 100, 127, 387, 401, 640, 1162, 1936, 2584,
              4099]:
        assert tpc.optimal_dft_size(n) == jpc.optimal_dft_size(n)


# (dr, dc) of B against A, and the strip size (h, w); the padded sizes of
# 401x300 and 213x397 are 405x300 and 216x400, odd rows in the first
@pytest.mark.parametrize("shift, hw", [
    ((0, 0), (180, 300)), ((7, -13), (401, 300)), ((-25, 31), (213, 397)),
    ((40, 2), (180, 300)), ((3, 100), (401, 300))])
def test_phase_correlate_batch_matches_jax(shift, hw):
    dr, dc = shift
    h, w = hw
    base = _texture(5, (700, 800))
    r0, c0 = 150, 250
    a = base[r0:r0 + h, c0:c0 + w]
    b = base[r0 + dr:r0 + dr + h, c0 + dc:c0 + dc + w]
    sx, sy, resp = tpc.phase_correlate_batch(a[None], b[None], device="cpu")
    jsx, jsy, jresp = jpc.phase_correlate_batch(a[None], b[None])
    assert sx.dtype == sy.dtype == resp.dtype == np.float32
    np.testing.assert_allclose(sx, jsx, rtol=0, atol=1e-3)
    np.testing.assert_allclose(sy, jsy, rtol=0, atol=1e-3)
    np.testing.assert_allclose(resp, jresp, rtol=0, atol=1e-4)
    # shifts within 1e-3 px mean the same peak; it is the true shift, up
    # to the half pixel by which cv2's centre (size / 2) sits off the
    # fftshift's (size // 2) at an odd padded size
    odd = 0.5 * np.asarray([tpc.optimal_dft_size(w) % 2,
                            tpc.optimal_dft_size(h) % 2])
    err = np.abs(np.asarray([sx[0] + dc, sy[0] + dr]))
    assert np.all(np.abs(err - odd) < 0.1), (sx, sy)
    assert resp[0] > 0.15


def test_batch_matches_per_pair():
    base = _texture(6, (400, 500))
    shifts = [(5, 0), (-11, 3), (0, 27), (9, -9)]
    a = np.stack([base[100:250, 100:300]] * len(shifts))
    b = np.stack([base[100 + dr:250 + dr, 100 + dc:300 + dc]
                  for dr, dc in shifts])
    sx, sy, resp = tpc.phase_correlate_batch(a, torch.as_tensor(b),
                                             device="cpu")
    for k in range(len(shifts)):
        one = tpc.phase_correlate_batch(a[k:k + 1], b[k:k + 1], device="cpu")
        np.testing.assert_allclose([sx[k], sy[k], resp[k]],
                                   [o[0] for o in one], rtol=0, atol=1e-4)
        assert (round(float(sx[k])), round(float(sy[k]))) == \
            (-shifts[k][1], -shifts[k][0])
