"""``utils/image.py`` and ``utils/profiling.py`` of the port against the JAX
package's, on the CPU.

Tolerances, each held where it is stated:
  * ``resize``: every uint8 value equal to
    ``jax.image.resize(..., "linear", antialias=True)``'s (the resize of
    ops/fusion/pyramid.py rounds as jax's compiled one);
  * ``_rotate`` and both rotating branches of ``rectify_final``:
    bit-equal (the JAX function's eager float32 operations, one by one);
    the pass-throughs return the input;
  * ``PhaseTimer``, ``frames_per_second`` and ``trace``: as the JAX
    package's tests hold them (tests/test_utils_ckpt.py:90-97), plus the
    trace file on disk.
"""
import json
import os

import numpy as np
import pytest
import torch

from imagestitch_tpu.utils import image as jimage
from imagestitch_tpu_torch.utils import image as timage
from imagestitch_tpu_torch.utils import synthetic
from imagestitch_tpu_torch.utils.profiling import (PhaseTimer,
                                                   frames_per_second, trace)
from test_torch_device import no_cuda  # noqa: F401 (a fixture)
from test_torch_jax_chain import two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _frames():
    rng = np.random.default_rng(0)
    smooth = synthetic.sequence(3, (481, 641), [(0.3, 0.6)])[0][0]
    return [rng.integers(0, 256, (100, 80), np.uint8),
            rng.integers(0, 256, (257, 333), np.uint8), smooth]


def _resize_gap(got, ref):
    """(differing values, values): every value within one level."""
    assert got.dtype == np.uint8 and got.shape == ref.shape
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1
    return int((d > 0).sum()), d.size


def test_resize_matches_jax():
    """By 0.5, 0.25 and 0.37 (odd output sizes), gray and BGR."""
    rng = np.random.default_rng(1)
    bad = total = 0
    for color in (False, True):
        for img in _frames():
            if color:
                img = np.stack([img, 255 - img, rng.permutation(img)], -1)
            for t in (0.5, 0.25, 0.37):
                b, n = _resize_gap(timage.resize(img, t, device="cpu"),
                                   jimage.resize(img, t))
                bad, total = bad + b, total + n
    assert total == 719068 and bad == 0, bad


def test_constant_resize_stays_constant():
    const = np.full((64, 64), 200, np.uint8)
    np.testing.assert_array_equal(timage.resize(const, 0.25, device="cpu"),
                                  np.full((16, 16), 200, np.uint8))


@pytest.mark.parametrize("angle", [30.0, -47.3, 89.0, 3.0])
def test_rotate_matches_jax(angle):
    for img in _frames()[:2]:
        np.testing.assert_array_equal(
            timage._rotate(img, angle, device="cpu"),
            np.asarray(jimage._rotate(img, angle)))


def test_rectify_final_branches_match_jax():
    """Both rotating branches (one diagonal pair of 10 x 10 corners
    empty), and the pass-throughs: no corner empty, and a first column
    under 30% nonzero."""
    rng = np.random.default_rng(2)
    base = rng.integers(1, 255, (60, 80), np.uint8)
    ul_br = base.copy()
    ul_br[:10, :10] = 0
    ul_br[-10:, -10:] = 0
    ur_bl = base.copy()
    ur_bl[:10, -10:] = 0
    ur_bl[-10:, :10] = 0
    dark = base.copy()
    dark[:50, 0] = 0
    for img in (ul_br, ur_bl, base, dark):
        got = timage.rectify_final(img, device="cpu")
        np.testing.assert_array_equal(got, np.asarray(
            jimage.rectify_final(img)))
    assert not np.array_equal(timage.rectify_final(ul_br, device="cpu"),
                              ul_br)
    assert timage.rectify_final(base, device="cpu") is base
    assert timage.rectify_final(dark, device="cpu") is dark


def test_phase_timer_frames_per_second_and_trace(tmp_path):
    t = PhaseTimer()
    out = []
    with t.phase("work", fence=out):
        out.append(torch.ones((64, 64)).sum())
    t.fence("fence", out[0])
    assert "work" in t.spans and "fence" in t.spans
    assert set(json.loads(t.report())) == {"work", "fence"}
    fps = frames_per_second(10, lambda: torch.ones((32, 32)) * 2, repeats=2)
    assert fps > 0
    with trace(str(tmp_path / "tr")) as d:
        torch.ones((16, 16)).matmul(torch.ones((16, 16)))
    assert d == str(tmp_path / "tr")
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_image_entry_points_need_cuda(no_cuda):  # noqa: F811
    img = np.ones((40, 40), np.uint8)
    for fn in (lambda: timage.resize(img, 0.5),
               lambda: timage._rotate(img, 10.0),
               lambda: timage.rectify_final(img)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


@pytest.mark.cuda
def test_cuda_resize_and_rectify_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(3)
    bad = total = 0
    for img in _frames():
        for t in (0.5, 0.37):
            b, n = _resize_gap(timage.resize(img, t),
                               timage.resize(img, t, device="cpu"))
            bad, total = bad + b, total + n
    assert bad <= 1e-5 * total, bad
    base = rng.integers(1, 255, (60, 80), np.uint8)
    base[:10, :10] = 0
    base[-10:, -10:] = 0
    np.testing.assert_array_equal(timage.rectify_final(base),
                                  timage.rectify_final(base, device="cpu"))
