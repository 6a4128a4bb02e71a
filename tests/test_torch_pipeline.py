"""The sharded registration steps (imagestitch_tpu_torch/parallel/
pipeline.py) on 8 CPU shards against the JAX package's on its 8 forced
host devices (tests/test_eval_parallel.py's sequences): the strip and
whole-tile phase steps, the feature step with its one-frame halo, and both
``distributed_stitch_step``s.

Tolerances: phase shifts within 1e-3 px and responses within 1e-4 (float32
FFTs of another library); the feature step's integer offsets and votes
equal (the XLA detector's pool, bit-equal to jax's), its sub-pixel means
within 1e-4 px; solved poses within 1e-3 px.  Each step on the mesh equals
the same step on one device."""
import numpy as np
import pytest
import torch

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.parallel import pipeline as jp
from imagestitch_tpu.parallel.mesh import make_mesh as jmake_mesh
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.parallel import mesh as tmesh
from imagestitch_tpu_torch.parallel import pipeline as tp
from test_torch_jax_chain import two_threads

#: a small keypoint pool (scaling.py's synthetic sweep's), both packages
JCFG = JStitchConfig(features=JFeatureConfig(pool_keypoints=512,
                                             max_keypoints=256))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the shards lie on the card")
    return torch.device("cuda", 0)


def _mesh(d=8):
    return tmesh.make_mesh(devices=["cpu"] * d)


def _noise_strip(n=17):
    """tests/test_eval_parallel.py's noise sequence: true offset (60, 0)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (60 * n + 128, 256), np.uint8)
    return np.stack([base[60 * i:60 * i + 128] for i in range(n)])


def _blob_strip(seed, n, h=128, w=192, step=60):
    """tests/test_eval_parallel.py's blob sequence: true offset (step, 0)."""
    rng = np.random.default_rng(seed)
    base = np.zeros((step * n + h, w), np.float32)
    ys = rng.integers(3, base.shape[0] - 3, 3000)
    xs = rng.integers(3, w - 3, 3000)
    for y, x, a in zip(ys, xs, rng.uniform(60, 200, 3000)):
        base[y - 2:y + 3, x - 2:x + 3] += a
    base = np.clip(base, 0, 255).astype(np.uint8)
    return np.stack([base[step * i:step * i + h] for i in range(n)])


def _hold_phase(got, ref, n):
    for g, r, tol in zip(got, ref, (1e-3, 1e-3, 1e-4)):
        np.testing.assert_allclose(np.asarray(g)[:n], np.asarray(r)[:n],
                                   rtol=0, atol=tol)


def test_make_pair_tensors_pads_with_the_last_pair():
    images = _noise_strip(10)
    a, b, n = tp.make_pair_tensors(images, _mesh(4))
    assert n == 9 and [x.shape[0] for x in a] == [3] * 4
    fa, fb = torch.cat(a).numpy(), torch.cat(b).numpy()
    np.testing.assert_array_equal(fa[:9], images[:-1])
    np.testing.assert_array_equal(fb[:9], images[1:])
    np.testing.assert_array_equal(fa[9:], np.repeat(images[8:9], 3, 0))
    a1, b1, _ = tp.make_pair_tensors(images, device="cpu")
    assert torch.equal(a1, torch.as_tensor(images[:-1]))


def test_phase_steps_match_jax():
    images = _noise_strip()
    a, b, n = tp.make_pair_tensors(images, _mesh())
    ja, jb, _ = jp.make_pair_tensors(images, jmake_mesh(8, axis="pairs"))
    a1, b1, _ = tp.make_pair_tensors(images, device="cpu")
    strip = tp.register_pairs_sharded(a, b, 1, 0.6, _mesh())
    _hold_phase(strip, jp.register_pairs_sharded(ja, jb, 1, 0.6), n)
    single = tp.register_pairs_sharded(a1, b1, 1, 0.6)
    assert all(torch.equal(s[:n], g[:n]) for s, g in zip(single, strip))
    whole = tp.register_pairs_sharded_whole(a, b, _mesh())
    _hold_phase(whole, jp.register_pairs_sharded_whole(ja, jb), n)
    single = tp.register_pairs_sharded_whole(a1, b1)
    assert all(torch.equal(s[:n], g[:n]) for s, g in zip(single, whole))
    assert np.all(np.abs(-whole[1].numpy()[:n] - 60) < 0.5)


def test_feature_step_matches_jax_and_one_device():
    images = _blob_strip(5, 9)
    cfg = config_from_jax(JCFG)
    sh = tp.register_pairs_sharded_features(images, _mesh(), cfg,
                                            direction=1, ratio=0.6)
    un = tp.register_pairs_sharded_features(images, None, cfg, direction=1,
                                            ratio=0.6, device="cpu")
    ref = jp.register_pairs_sharded_features(
        images, jmake_mesh(8, axis="pairs"), JCFG, direction=1, ratio=0.6)
    for g, u, r in zip(sh, un, ref):
        np.testing.assert_array_equal(g, u)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(sh[:3], np.asarray(ref[:3]))
    dr, dc, nv = sh[0], sh[1], sh[2]
    assert np.all(nv >= 3) and np.all(np.abs(dr - 60) <= 1)
    assert np.all(np.abs(dc) <= 1)


def test_feature_step_collectives():
    """One ppermute (each shard's first frame's B selection: k_sel rows,
    cols, validity and 128-float descriptors) and one all-gather of the
    (5, n_local) outputs a step; none without a mesh."""
    images = _blob_strip(5, 9)
    cfg = config_from_jax(JCFG)
    c = tp.feature_step_collectives(images, _mesh(), cfg, direction=1,
                                    ratio=0.6)
    assert (c["ppermute"], c["all_gather"], c["psum"], c["total"]) == \
        (1, 1, 0, 2)
    assert c["ppermute_bytes"] == 8 * 256 * (4 + 4 + 1 + 128 * 4)
    assert c["all_gather_bytes"] == 5 * 16 * 4
    c1 = tp.feature_step_collectives(images, None, cfg, direction=1,
                                     ratio=0.6, device="cpu")
    assert c1["total"] == 0


def test_distributed_stitch_steps_match_jax():
    images = _noise_strip()
    poses = tp.distributed_stitch_step(images, _mesh(), direction=1,
                                       ratio=0.6, cg_iters=64)
    ref = jp.distributed_stitch_step(images, jmake_mesh(8, axis="pairs"),
                                     direction=1, ratio=0.6, cg_iters=64)
    assert poses.shape == (17, 2)
    np.testing.assert_allclose(poses, ref, rtol=0, atol=1e-3)
    assert np.abs(np.diff(poses[:, 0]) - 60).max() < 1.5
    images = _blob_strip(6, 11)
    poses = tp.distributed_stitch_step_features(
        images, _mesh(), config_from_jax(JCFG), direction=1, ratio=0.6)
    ref = jp.distributed_stitch_step_features(
        images, jmake_mesh(8, axis="pairs"), JCFG, direction=1, ratio=0.6)
    assert poses.shape == (11, 2)
    np.testing.assert_allclose(poses, ref, rtol=0, atol=1e-3)
    assert np.abs(np.diff(poses[:, 0]) - 60).max() < 1.5
    assert np.abs(poses[:, 1]).max() < 1.5


@pytest.mark.cuda
def test_cuda_four_shards_equal_the_cpu_run(cuda_device):
    """Four shards on one card against four CPU shards: phase shifts within
    1e-3 px; the feature step's integer offsets (the mode) equal."""
    images = _noise_strip()
    card, cpu = (tmesh.make_mesh(devices=[d] * 4) for d in ("cuda:0", "cpu"))
    got = tp.register_pairs_sharded_whole(
        *tp.make_pair_tensors(images, card)[:2], card)
    ref = tp.register_pairs_sharded_whole(
        *tp.make_pair_tensors(images, cpu)[:2], cpu)
    assert got[0].is_cuda
    _hold_phase([g.cpu() for g in got], ref, 16)
    images = _blob_strip(5, 9)
    cfg = config_from_jax(JCFG)
    sh = tp.register_pairs_sharded_features(images, card, cfg, ratio=0.6)
    ref = tp.register_pairs_sharded_features(images, cpu, cfg, ratio=0.6)
    np.testing.assert_array_equal(sh[:2], ref[:2])
