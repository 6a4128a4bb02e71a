"""Loop-closure edges whose phase response lies at the 0.05 cut of
``solver/loop_closure.verify_edges``: the port on the CPU against the JAX
package, and the card against the CPU.

An edge is kept when its renormalised 5x5 peak mass exceeds 0.05.  Two
128 x 128 tiles of one seeded texture, 17 rows and 23 columns apart, each
with its own Gaussian noise of scale sigma: a scan over sigma finds pairs
whose response brackets the cut on one branch of the peak, and bisection on
sigma brings each within 1e-4 of it.  At such a response the correlation
peak is weak (most of these edges measure a noise peak, as a real
low-texture overlap would), so the decision is left to the last bits of
the FFTs.

Tolerances, each held where it is stated:
  * the kept edges: equal (the decision itself);
  * responses within 1e-6 of jax's and measurements within 1e-3 px
    (measured on the 5 edges built here, each within 7.5e-5 of the cut:
    9.7e-8 and 3.1e-5 px): a response must lie nearer the cut than that
    for the two to disagree;
  * on the card, responses within 1e-5 of the CPU's, the kept edges
    equal, and the measurements within 1e-3 px (cuFFT sums in another
    order; the sub-pixel centroids moved by up to 4.9e-4 px in the phase
    paths).
"""
import numpy as np
import pytest
import torch

from imagestitch_tpu.solver import loop_closure as jlc
from imagestitch_tpu_torch.solver import loop_closure as tlc
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import two_threads

H = W = 128
SHIFT = (17.0, 23.0)
CUT = 0.05


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _pair(seed: int, sigma: float):
    rng = np.random.default_rng(seed)
    tex = synthetic.textured(rng, H + int(SHIFT[0]), W + int(SHIFT[1]))
    a, b = tex[:H, :W], tex[int(SHIFT[0]):, int(SHIFT[1]):]
    na, nb = rng.normal(0, 1, (2, H, W))
    q = lambda x: np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return q(a + sigma * na), q(b + sigma * nb)


def _problem(pairs):
    """(images, positions, edges) with one edge (2k, 2k + 1) a pair."""
    images = np.stack([t for p in pairs for t in p])
    positions = np.asarray([(0.0, 0.0), SHIFT] * len(pairs), np.float64)
    return images, positions, [(2 * k, 2 * k + 1) for k in range(len(pairs))]


def _responses(pairs, device="cpu"):
    images, positions, edges = _problem(pairs)
    return tlc.verify_edges(images, positions, edges,
                            response_threshold=-np.inf, device=device)[3]


def near_threshold_pairs():
    """(seed, sigma) of the pairs whose port-CPU response lies within 1e-4
    of the cut: sigma scanned over [80, 200] for 16 textures, each bracket
    of the cut on one branch (responses within 0.01 of each other)
    bisected."""
    sigmas = np.linspace(80.0, 200.0, 60)
    scan = [(s, g) for s in range(16) for g in sigmas]
    resp = _responses([_pair(s, g) for s, g in scan]).reshape(16, -1)
    out = []
    for s in range(16):
        for k in range(len(sigmas) - 1):
            r0, r1 = resp[s, k], resp[s, k + 1]
            if (r0 - CUT) * (r1 - CUT) > 0 or abs(r1 - r0) > 0.01:
                continue
            lo, hi = sigmas[k], sigmas[k + 1]
            for _ in range(20):
                mid = 0.5 * (lo + hi)
                rm = _responses([_pair(s, mid)])[0]
                if abs(rm - CUT) < 1e-4:
                    break
                if (rm - CUT) * (r0 - CUT) > 0:
                    lo, r0 = mid, rm
                else:
                    hi = mid
            if abs(rm - CUT) < 1e-4:
                out.append((s, mid))
    return out


@pytest.fixture(scope="module")
def near_pairs():
    return near_threshold_pairs()


def test_near_threshold_edges_are_found(near_pairs):
    resp = _responses([_pair(s, g) for s, g in near_pairs])
    assert len(near_pairs) >= 4
    assert np.abs(resp - CUT).max() < 1e-4
    assert (resp > CUT).any() and (resp <= CUT).any()


def test_near_threshold_edges_kept_like_jax(near_pairs):
    images, positions, edges = _problem([_pair(s, g) for s, g in near_pairs])
    got = tlc.verify_edges(images, positions, edges, device="cpu")
    ref = jlc.verify_edges(images, positions, edges)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-3)
    allr = tlc.verify_edges(images, positions, edges,
                            response_threshold=-np.inf, device="cpu")
    allj = jlc.verify_edges(images, positions, edges,
                            response_threshold=-np.inf)
    np.testing.assert_allclose(allr[3], allj[3], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_near_threshold_edges_kept_like_cpu(near_pairs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the card's FFTs are cuFFT")
    images, positions, edges = _problem([_pair(s, g) for s, g in near_pairs])
    cpu = tlc.verify_edges(images, positions, edges, device="cpu")
    card = tlc.verify_edges(images, positions, edges, device="cuda")
    np.testing.assert_array_equal(card[0], cpu[0])
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_allclose(card[2], cpu[2], rtol=0, atol=1e-3)
    allc = _responses([_pair(s, g) for s, g in near_pairs], device="cuda")
    allp = _responses([_pair(s, g) for s, g in near_pairs])
    margin = float(np.abs(allc - allp).max())
    print(f"F7 margin: card vs CPU response {margin:.3e} over "
          f"{len(near_pairs)} edges within 1e-4 of the cut")
    assert margin < 1e-5
