"""The port's device mesh (imagestitch_tpu_torch/parallel/mesh.py): mesh
construction, which raises rather than give fewer cards than asked for,
explicit (repeatable) devices, and the collectives over per-shard tensors
with their counts.  ``psum`` sums in shard order; the float32 values below
give a different sum in any other order."""
import numpy as np
import pytest
import torch

from imagestitch_tpu.parallel import mesh as jmesh
from imagestitch_tpu_torch.parallel import mesh as tmesh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the shards lie on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def counted():
    tmesh.reset_collectives()
    yield tmesh.COLLECTIVES
    tmesh.reset_collectives()


def test_make_mesh_raises_beyond_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mesh = tmesh.make_mesh(axis="frames")
    assert mesh.devices == [torch.device("cuda", 0)] and mesh.size == 1
    assert mesh.axis_names == ("frames",)
    with pytest.raises(RuntimeError, match="1 CUDA device"):
        tmesh.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="0 CUDA"):
        tmesh.make_mesh()


def test_explicit_devices_may_repeat():
    mesh = tmesh.make_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8 and set(mesh.devices) == {torch.device("cpu")}
    assert tmesh.make_mesh(3, axis="blocks", devices=["cpu"] * 8).size == 3
    with pytest.raises(RuntimeError, match="8 device"):
        tmesh.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        tmesh.Mesh([])


def test_pad_to_multiple_and_shard_match_jax():
    for n, m in ((0, 4), (1, 4), (4, 4), (9, 8), (17, 8)):
        assert tmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    x = np.arange(24).reshape(8, 3)
    parts = tmesh.shard(x, mesh)
    assert [p.shape for p in parts] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    with pytest.raises(ValueError, match="equal blocks"):
        tmesh.shard(x[:7], mesh)


def test_psum_sums_in_shard_order(counted):
    mesh = tmesh.make_mesh(devices=["cpu"] * 3)
    xs = [torch.tensor([1e8, 1.0], dtype=torch.float32),
          torch.tensor([1.0, 1e8], dtype=torch.float32),
          torch.tensor([-1e8, -1e8], dtype=torch.float32)]
    out = tmesh.psum(xs, mesh)
    # ((1e8 + 1) - 1e8) = 0 and ((1 + 1e8) - 1e8) = 0 in float32; the
    # order (x2 + x0) + x1 would give 1
    assert len(out) == 3 and all(torch.equal(o, out[0]) for o in out)
    assert out[0].tolist() == [0.0, 0.0]
    assert counted["psum"] == 1 and counted["psum_bytes"] == 8


def test_ppermute_sends_to_the_predecessor(counted):
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    xs = [torch.full((2,), float(i)) for i in range(4)]
    out = tmesh.ppermute(xs, mesh)
    assert [o[0].item() for o in out] == [1.0, 2.0, 3.0, 0.0]
    # a tuple a shard travels in one collective
    pairs = tmesh.ppermute([(x, x.long()) for x in xs], mesh)
    assert [p[1][0].item() for p in pairs] == [1, 2, 3, 0]
    assert counted["ppermute"] == 2
    assert counted["ppermute_bytes"] == 4 * 8 + 4 * (8 + 16)
    # one shard keeps its own: nothing moves, nothing is counted
    one = tmesh.make_mesh(devices=["cpu"])
    assert tmesh.ppermute(xs[:1], one)[0] is xs[0]
    assert counted["ppermute"] == 2


def test_all_gather_and_replicate(counted):
    mesh = tmesh.make_mesh(devices=["cpu"] * 3)
    xs = [torch.arange(2) + 2 * i for i in range(3)]
    assert tmesh.all_gather(xs, mesh).tolist() == list(range(6))
    assert tmesh.all_gather([x[None] for x in xs], mesh, dim=1).shape == \
        (1, 6)
    assert counted["all_gather"] == 2 and counted["all_gather_bytes"] == 96
    assert all(r is xs[0] for r in tmesh.replicate(xs[0], mesh))


@pytest.mark.cuda
def test_cuda_collectives_equal_the_cpu(cuda_device):
    """Four shards on one card: each collective's result equals the CPU
    shards' bit for bit, and lies on the card."""
    rng = np.random.default_rng(0)
    host = [torch.as_tensor(rng.normal(0, 1e4, (5, 3)).astype(np.float32))
            for _ in range(4)]
    card = tmesh.make_mesh(devices=["cuda:0"] * 4)
    cpu = tmesh.make_mesh(devices=["cpu"] * 4)
    on_card = [x.to("cuda:0") for x in host]
    for fn in (tmesh.psum, tmesh.ppermute):
        got, ref = fn(on_card, card), fn(host, cpu)
        assert all(g.is_cuda and torch.equal(g.cpu(), r)
                   for g, r in zip(got, ref))
    assert torch.equal(tmesh.all_gather(on_card, card).cpu(),
                       tmesh.all_gather(host, cpu))
