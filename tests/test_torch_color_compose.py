"""Color fade composition — the default of StitchConfig — against the JAX
package: the port's compose on (N, H, W, 3) frames against the JAX compose
(bucketed lax.scan steps, padded dynamic-rect weights) on the layouts of
test_torch_compose.py, bit for bit, and the whole color stitch of the
default configuration against the JAX Stitcher, whose pools run as on a TPU
(test_torch_jax_chain.py)."""
import numpy as np
import pytest
import torch

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import Stitcher as JStitcher
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import compose as jcompose
from imagestitch_tpu.io.dataset import ImageBatch as JImageBatch
from imagestitch_tpu.ops.fusion import weights as jweights
from imagestitch_tpu_torch import StitchConfig, Stitcher
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.core import compose as tcompose
from imagestitch_tpu_torch.io.dataset import ImageBatch, bgr_to_gray
from imagestitch_tpu_torch.ops.fusion import weights as tweights
from imagestitch_tpu_torch.utils import synthetic
from test_torch_compose import CASES, H, W
from test_torch_jax_chain import (assert_segments_equal,
                                  route_pools_as_on_tpu, two_threads)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _frames(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_color_compose_matches_jax(name):
    offsets = CASES[name]
    frames = _frames(len(name), len(offsets) + 1)
    ref = np.asarray(jcompose.compose(frames, offsets, JStitchConfig()))
    got = tcompose.compose(frames, offsets, StitchConfig(),
                           device="cpu")
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert got.shape == tcompose.compute_placement(
        offsets, (H, W)).canvas_shape + (3,)
    np.testing.assert_array_equal(got, ref)


def test_lone_color_frame():
    frames = _frames(1, 1)
    ref = np.asarray(jcompose.compose(frames, [], JStitchConfig()))
    np.testing.assert_array_equal(tcompose.compose(frames, [], StitchConfig(),
                                                   device="cpu"), ref)
    np.testing.assert_array_equal(ref, frames[0])


def test_color_corner_weights_count_channels():
    """A region whose gray-style count (any channel positive) and
    per-channel count pick different quadrants: the port follows the
    reference's per-channel count, as the JAX weights do."""
    a = np.full((40, 60, 3), 5, np.int32)
    a[:20, :30] = [5, 5, 5]
    a[:2, :30] = 0
    a[20:, :30] = [5, 0, 0]
    a[:, 30:] = [5, 5, 0]
    a[30:, 50:] = -1
    # positive pixels per quadrant (ul, ll, lr, ur) 540, 600, 500, 600:
    # lower-right is the fewest; positive values 1620, 600, 1000, 1200:
    # lower-left is
    got = tweights.corner_fade_weights(torch.as_tensor(a), color=True)
    gray_style = tweights.corner_fade_weights(
        torch.as_tensor(np.where((a > 0).any(-1), 5, a[..., 0])))
    assert not torch.equal(got[1], gray_style[1])
    ref = jweights.corner_fade_weights(a, True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_default_config_color_stitch_matches_jax():
    """StitchConfig()'s color mode end to end on seeded color frames (a 2x2
    serpentine plus an unrelated frame): the fixed-point gray registers,
    the unrelated pair goes through the oriented fallback, and the color
    panoramas and the lone color frame equal the JAX Stitcher's."""
    hw = (320, 400)
    positions = synthetic.serpentine_positions(2, 2, (270.37, 330.21))
    color = np.concatenate([
        synthetic.color_sequence(0, hw, positions)[0],
        synthetic.color_sequence(99, hw, [(0.5, 0.5)])[0]])
    gray = np.stack([bgr_to_gray(f) for f in color])
    jcfg = JStitchConfig(roi_ratio=0.2,
                         features=JFeatureConfig(max_keypoints=256))
    assert jcfg.color_mode
    files = [f"f{i}" for i in range(len(color))]
    with pytest.MonkeyPatch.context() as mp:
        route_pools_as_on_tpu(mp)
        ref = JStitcher(jcfg).stitch_batch(JImageBatch(gray=gray, color=color,
                                                       files=files))
    got = Stitcher(config_from_jax(jcfg), device="cpu").stitch_batch(
        ImageBatch(gray=gray, color=color, files=files))
    assert [r.file_range for r in got] == [(0, 4), (4, 5)]
    assert_segments_equal(got, ref)
    assert got[0].image.ndim == 3 and got[1].image.shape == hw + (3,)
    pano = got[0].image.astype(np.int32)
    assert (pano[..., 0] != pano[..., 2]).mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("color", [True, False])
def test_cuda_compose_matches_cpu(color):
    """The composer on the card is bit-equal to the CPU one (and so to the
    JAX one): its ramps are divided on the host, not by CUDA's reciprocal
    multiply."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    for name, offsets in CASES.items():
        frames = _frames(len(name), len(offsets) + 1)
        if not color:
            frames = frames[..., 1]
        cpu = tcompose.compose(frames, offsets, StitchConfig(),
                               device="cpu")
        dev = tcompose.compose(torch.as_tensor(frames, device="cuda"),
                               offsets, StitchConfig(), return_device=True)
        assert dev.device.type == "cuda"
        np.testing.assert_array_equal(dev.cpu().numpy(), cpu)
