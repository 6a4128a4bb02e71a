"""Frame-sharded pooled registration over a mesh of 8 CPU shards
(imagestitch_tpu_torch/parallel/pooled_sharded.py) against the JAX
package's sharded functions on its 8 forced host devices, and against the
port's single-device run, on tests/test_pooled_sharded.py's serpentine
(down, right, up, right, down: every direction turn).

Held equal: ok flags, offsets, directions, scales, attempts and the vote
counts.  Against jax both sides take the XLA detector's pool
(``use_pallas=False``, bit-equal to jax's): the JAX package runs its
Pallas pool only on a TPU.  Against the port's single-device run the
default pool takes the port's own route (the fused pool, K1 and K2 in
their plain versions here), whose JAX parity tests/test_torch_jax_chain.py
holds.  The ``Stitcher(mesh)`` panorama is bit-equal to the single-device
Stitcher's."""
import os

import numpy as np
import pytest
import torch

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.parallel import pooled_sharded as jps
from imagestitch_tpu.parallel.mesh import make_mesh as jmake_mesh
from imagestitch_tpu_torch import Stitcher
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.core import feature_registration as tfr
from imagestitch_tpu_torch.io import codec
from imagestitch_tpu_torch.io.dataset import ImageBatch
from imagestitch_tpu_torch.parallel import pooled_sharded as tps
from imagestitch_tpu_torch.parallel.mesh import make_mesh
from test_torch_jax_chain import two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the shards lie on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def seq():
    """tests/test_pooled_sharded.py's serpentine (the same draws)."""
    rng = np.random.default_rng(7)
    h, w = 128, 192
    base = np.clip(rng.normal(128, 40, (3 * h + 200, 2 * w + 200)), 0,
                   255).astype(np.uint8)
    ys = rng.integers(5, base.shape[0] - 5, 6000)
    xs = rng.integers(5, base.shape[1] - 5, 6000)
    for y, x in zip(ys, xs):
        base[y - 1:y + 2, x - 1:x + 2] = rng.integers(0, 255)
    tl = [(0, 0), (90, 2), (180, 1), (181, 140), (91, 139), (1, 141),
          (0, 260), (95, 261), (185, 262)]
    return np.stack([base[r:r + h, c:c + w] for r, c in tl]), tl


def _jcfg(**kw):
    return JStitchConfig(
        registration="feature_incre", direction=1, direct_incre=1,
        roi_ratio=0.2, offset_evaluate=3, color_mode=False,
        features=JFeatureConfig(max_keypoints=256, pool_keypoints=512), **kw)


def _key(recs):
    return [(r.ok, r.offset, r.direction, r.scale, r.attempts, r.confidence)
            for r in recs]


def _mesh8():
    return make_mesh(8, axis="frames", devices=["cpu"] * 8)


def test_shard_frames_pads_with_the_last_frame(seq):
    images, _ = seq
    parts, n = tps.shard_frames(images, _mesh8())
    assert n == 9 and [p.shape[0] for p in parts] == [2] * 8
    flat = torch.cat(parts).numpy()
    np.testing.assert_array_equal(flat[:9], images)
    np.testing.assert_array_equal(flat[9:], np.repeat(images[-1:], 7, 0))
    parts_t, _ = tps.shard_frames(torch.as_tensor(images), _mesh8())
    assert all(torch.equal(a, b) for a, b in zip(parts, parts_t))


def test_sharded_incre_equals_jax_sharded(seq):
    images, tl = seq
    jcfg = _jcfg(use_pallas=False)
    got = tps.register_sequence_features_incre_sharded(
        images, config_from_jax(jcfg), _mesh8())
    ref = jps.register_sequence_features_incre_sharded(
        images, jcfg, jmake_mesh(8, axis="frames"))
    assert _key(got) == _key(ref)
    single = tfr.register_sequence_features_incre(
        images, config_from_jax(jcfg), device="cpu")
    assert _key(got) == _key(single)
    for k, r in enumerate(got):
        want = (tl[k + 1][0] - tl[k][0], tl[k + 1][1] - tl[k][1])
        assert r.ok and max(abs(r.offset[0] - want[0]),
                            abs(r.offset[1] - want[1])) <= 1, (k, r, want)


def test_sharded_incre_default_pool_equals_single_device(seq):
    """The port's default route (the fused pool) on 8 shards and on 3,
    whose blocks hold 3 frames and the halo crosses other boundaries."""
    images, _ = seq
    cfg = config_from_jax(_jcfg())
    single = tfr.register_sequence_features_incre(images, cfg, device="cpu")
    for mesh in (_mesh8(), make_mesh(devices=["cpu"] * 3)):
        got = tps.register_sequence_features_incre_sharded(images, cfg, mesh)
        assert _key(got) == _key(single)


def test_sharded_whole_image_equals_jax_and_single(seq):
    images, _ = seq
    images = images[:3]      # linear: the whole-image path has no search
    for jcfg in (_jcfg(use_pallas=False).replace(registration="feature"),
                 _jcfg().replace(registration="feature")):
        cfg = config_from_jax(jcfg)
        got = tps.register_sequence_features_sharded(images, cfg, _mesh8())
        single = tfr.register_sequence_features(images, cfg, device="cpu")
        assert [k[:5] for k in _key(got)] == [k[:5] for k in _key(single)]
        if not jcfg.use_pallas:
            ref = jps.register_sequence_features_sharded(
                images, jcfg, jmake_mesh(8, axis="frames"))
            assert _key(got) == _key(ref)
            np.testing.assert_allclose(
                [r.offset_subpix for r in got],
                [r.offset_subpix for r in ref], atol=1e-4)


def test_stitcher_mesh_panorama_equals_single_device(seq):
    images, _ = seq
    cfg = config_from_jax(_jcfg())
    batch = ImageBatch(gray=images, color=None,
                       files=[str(i) for i in range(len(images))])
    single = Stitcher(cfg, device="cpu").stitch_batch(batch)
    sharded = Stitcher(cfg, mesh=_mesh8()).stitch_batch(batch)
    assert [r.file_range for r in sharded] == [r.file_range for r in single]
    assert [r.offsets for r in sharded] == [r.offsets for r in single]
    for a, b in zip(single, sharded):
        np.testing.assert_array_equal(b.image, a.image)


def test_stitcher_mesh_files_equal_single_device(seq, tmp_path):
    """stitch_files: the mesh keeps the decoded frames on the host (no
    fused ingest) and gives the single-device panorama."""
    images, _ = seq
    os.makedirs(tmp_path / "1")
    files = []
    for i, im in enumerate(images[:5]):
        files.append(str(tmp_path / "1" / f"f{i}.png"))
        codec.imwrite(files[-1], im)
    cfg = config_from_jax(_jcfg())
    single = Stitcher(cfg, device="cpu").stitch_files(files)
    sharded = Stitcher(cfg, mesh=make_mesh(devices=["cpu"] * 2)
                       ).stitch_files(files)
    assert [r.offsets for r in sharded] == [r.offsets for r in single]
    np.testing.assert_array_equal(sharded[0].image, single[0].image)


@pytest.mark.cuda
def test_cuda_four_shards_equal_the_cards_single_run(seq, cuda_device):
    """Four shards on one card (K1, K2 and K3 on each) against the card's
    single-device run: the same records and bit-equal panoramas; against
    four CPU shards, the same ok flags and offsets within 1 px (the card's
    sub-pixel means lie up to 5e-4 px from the CPU's, ROADMAP F5, and these
    true offsets are integers, which the replay truncates)."""
    images, _ = seq
    batch = ImageBatch(gray=images, color=None,
                       files=[str(i) for i in range(len(images))])
    card_mesh = make_mesh(devices=["cuda:0"] * 4)
    for jcfg in (_jcfg(), _jcfg().replace(registration="feature")):
        cfg = config_from_jax(jcfg)
        card = Stitcher(cfg, mesh=card_mesh).stitch_batch(batch)
        single = Stitcher(cfg, device=cuda_device).stitch_batch(batch)
        cpu = Stitcher(cfg, mesh=make_mesh(devices=["cpu"] * 4)
                       ).stitch_batch(batch)
        assert [r.offsets for r in card] == [r.offsets for r in single]
        if cfg.registration == "feature_incre":
            # the whole-image step matches each frame's top max_keypoints
            # by score (JAX :306), the single-device path the whole pool
            assert card[0].report.confidences == \
                single[0].report.confidences
        for a, b in zip(card, single):
            np.testing.assert_array_equal(a.image, b.image)
        assert [r.file_range for r in card] == [r.file_range for r in cpu]
        for a, b in zip(card, cpu):
            assert np.abs(np.subtract(a.offsets, b.offsets)).max() <= 1
