"""The port's tensor-parallel FFT phase correlation
(imagestitch_tpu_torch/parallel/tp_fft.py) and ``mesh.all_to_all``
against the JAX package's, on CPU shards (``["cpu"] * d`` against the
JAX tests' forced host devices).

Tolerances, each held where it is stated:
  * ``all_to_all``: equal to a hand-built transpose of the chunks;
  * the sharded correlation against JAX's and against the port's one-device
    ``_phase_correlate_one``: shifts within 0.05 px and the response within
    1e-3, as tests/test_tp_fft.py holds JAX's own (torch's and XLA's FFTs
    round differently; measured here: shifts equal, responses 1.2e-7
    apart);
  * the whole-image registration over budget: JAX's integer offsets and
    ``ok`` equal, sub-pixel within 5e-3 px, confidence within 1e-3.
"""
import os

import numpy as np
import pytest
import torch

from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import registration as jreg
from imagestitch_tpu.parallel import tp_fft as jtp
from imagestitch_tpu.parallel.mesh import make_mesh as jmake_mesh
from imagestitch_tpu_torch import StitchConfig, Stitcher, cli
from imagestitch_tpu_torch.core import registration as treg
from imagestitch_tpu_torch.io import codec
from imagestitch_tpu_torch.ops import phase_corr as tpc
from imagestitch_tpu_torch.parallel import mesh as tmesh
from imagestitch_tpu_torch.parallel import tp_fft as ttp
from imagestitch_tpu_torch.utils import synthetic
from test_tp_fft import _pair
from test_torch_jax_chain import two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


def _cpu_mesh(d):
    return tmesh.make_mesh(devices=["cpu"] * d, axis="tp")


def _frames():
    """tests/test_tp_fft.py's two frames, offset (97, 2)."""
    rng = np.random.default_rng(3)
    base = np.clip(rng.normal(128, 40, (420, 300)), 0, 255).astype(np.uint8)
    ys = rng.integers(3, 417, 3000)
    xs = rng.integers(3, 297, 3000)
    base[ys, xs] = 255
    return np.stack([base[0:256, 0:256], base[97:353, 2:258]])


@pytest.mark.parametrize("split,concat", [(1, 0), (0, 1), (1, 1)])
def test_all_to_all_is_the_tiled_transpose(split, concat):
    """Shard i's j-th chunk along ``split`` lands on shard j, concatenated
    in shard order along ``concat``; one counted call."""
    d = 4
    mesh = _cpu_mesh(d)
    xs = [torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12) + 100 * i
          for i in range(d)]
    tmesh.reset_collectives()
    got = tmesh.all_to_all(xs, mesh, split, concat)
    for j in range(d):
        want = torch.cat([x.chunk(d, split)[j] for x in xs], dim=concat)
        assert torch.equal(got[j], want)
    assert tmesh.COLLECTIVES["all_to_all"] == 1
    assert tmesh.COLLECTIVES["all_to_all_bytes"] == d * 8 * 12 * 4
    with pytest.raises(ValueError, match="does not split"):
        tmesh.all_to_all([torch.zeros(6, 6)] * d, mesh, 0, 1)


@pytest.mark.parametrize("d", [4, 8])
def test_sharded_matches_jax_and_one_device(d):
    """tests/test_tp_fft.py's pair (shift (40, -17)) on d CPU shards."""
    a, b = _pair(np.random.default_rng(31))
    sx, sy, r = ttp.phase_correlate_sharded(a, b, _cpu_mesh(d))
    jsx, jsy, jr = jtp.phase_correlate_sharded(a, b, jmake_mesh(d, axis="tp"))
    assert abs(sx - jsx) < 0.05 and abs(sy - jsy) < 0.05
    assert abs(r - jr) < 1e-3
    hp = ttp._pad_to(tpc.optimal_dft_size(a.shape[0]), d)
    wp = ttp._pad_to(tpc.optimal_dft_size(a.shape[1]), d)
    ox, oy, orr = (float(v[0]) for v in tpc._phase_correlate_one(
        torch.as_tensor(a, dtype=torch.float32)[None],
        torch.as_tensor(b, dtype=torch.float32)[None], hp, wp))
    assert abs(sx - ox) < 0.05 and abs(sy - oy) < 0.05 and abs(r - orr) < 1e-3
    assert abs(-sy - 40) < 0.5 and abs(-sx + 17) < 0.5


def test_auto_routes_both_ways(monkeypatch):
    """A budget of 1 byte takes the sharded route, a huge one the mesh's
    first device; both find JAX's shift.  Without a mesh the route takes
    the card, which raises without CUDA."""
    a, b = _pair(np.random.default_rng(32), shift=(12, 5))
    mesh = _cpu_mesh(8)
    calls = []
    real = ttp.phase_correlate_sharded
    monkeypatch.setattr(ttp, "phase_correlate_sharded",
                        lambda *a_, **k: calls.append(1) or real(*a_, **k))
    s_shard = ttp.phase_correlate_auto(a, b, mesh, per_chip_budget_bytes=1)
    assert calls == [1]
    s_one = ttp.phase_correlate_auto(a, b, mesh,
                                     per_chip_budget_bytes=1 << 40)
    assert calls == [1]
    j_one = jtp.phase_correlate_auto(a, b, jmake_mesh(8, axis="tp"),
                                     per_chip_budget_bytes=1 << 40)
    for s in (s_shard, s_one):
        assert abs(s[0] - j_one[0]) < 0.05 and abs(s[1] - j_one[1]) < 0.05
    assert abs(-s_one[1] - 12) < 0.5 and abs(-s_one[0] - 5) < 0.5
    assert ttp.phase_correlate_auto(a, b, None, device="cpu") == s_one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttp.phase_correlate_auto(a, b, None)


def test_whole_phase_over_budget_gives_jax_records():
    """``phase_hbm_budget=1`` on 8 CPU shards: JAX's records on its own
    test's frames, and the collectives a pair takes."""
    images = _frames()
    jcfg = JStitchConfig(registration="phase", direction=1, direct_incre=0,
                         phase_hbm_budget=1)
    ref = jreg.register_sequence_phase_whole(
        images, jcfg, mesh=jmake_mesh(8, axis="pairs"))
    cfg = StitchConfig(registration="phase", direction=1, direct_incre=0,
                       phase_hbm_budget=1)
    tmesh.reset_collectives()
    got = treg.register_sequence_phase_whole(
        images, cfg, mesh=tmesh.make_mesh(devices=["cpu"] * 8))
    c = dict(tmesh.COLLECTIVES)
    assert (c["all_to_all"], c["all_gather"], c["psum"]) == (3, 2, 1)
    assert c["ppermute"] == 0
    assert len(got) == len(ref) == 1
    g, r = got[0], ref[0]
    assert g.ok == r.ok and g.ok and g.offset == r.offset == (97, 2)
    assert (g.direction, g.scale, g.attempts) == (r.direction, r.scale,
                                                  r.attempts)
    np.testing.assert_allclose(g.offset_subpix, r.offset_subpix, atol=5e-3)
    assert abs(g.confidence - r.confidence) < 1e-3


def test_no_shard_holds_the_padded_surface(monkeypatch):
    """Every tensor the FFTs see is a (hp / D, wp) or (hp, wp / D) block."""
    images = _frames()
    d = 8
    hp = tpc.optimal_dft_size(2 * 256)
    wp = tpc.optimal_dft_size(2 * 256)
    seen = []
    for name in ("fft", "ifft"):
        real = getattr(torch.fft, name)
        monkeypatch.setattr(torch.fft, name,
                            lambda x, *a, _r=real, **k: seen.append(
                                tuple(x.shape)) or _r(x, *a, **k))
    cfg = StitchConfig(registration="phase", phase_hbm_budget=1)
    treg.register_sequence_phase_whole(
        images, cfg, mesh=tmesh.make_mesh(devices=["cpu"] * d))
    assert seen and all(s in ((hp // d, wp), (hp, wp // d)) for s in seen)


def test_stitcher_phase_mesh_reaches_the_sharded_route():
    """``Stitcher(registration="phase", mesh=...)`` over budget registers
    through tp_fft with the records of the direct call."""
    images = _frames()
    cfg = StitchConfig(registration="phase", direction=1, direct_incre=0,
                       phase_hbm_budget=1)
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    tmesh.reset_collectives()
    recs = Stitcher(cfg, mesh=mesh).register(images)
    assert tmesh.COLLECTIVES["all_to_all"] == 3
    assert recs == treg.register_sequence_phase_whole(images, cfg, mesh=mesh)
    assert recs[0].offset == (97, 2)


def test_cli_mesh_reaches_the_sharded_route(tmp_path, monkeypatch):
    """``--registration phase --mesh 2 --device cpu`` with the budget below
    a pair's surfaces (the CLI's config with ``phase_hbm_budget=1``)
    writes the single-device panorama through tp_fft."""
    pos = synthetic.serpentine_positions(3, 1, (70.37, 0.21))
    frames, _ = synthetic.sequence(3, (128, 160), pos)
    os.makedirs(tmp_path / "proj" / "1")
    for i, f in enumerate(frames):
        codec.imwrite(str(tmp_path / "proj" / "1" / f"f{i}.png"), f)
    real = cli.config_from_args
    monkeypatch.setattr(cli, "config_from_args",
                        lambda args: real(args).replace(phase_hbm_budget=1))
    args = ["stitch", str(tmp_path / "proj"), "", "--file-extension", "png",
            "--output-extension", "png", "--gray", "--registration",
            "phase", "--quiet", "--device", "cpu"]
    outs = []
    for extra, out, calls in (([], "one", 0), (["--mesh", "2"], "two", 6)):
        args[2] = str(tmp_path / out)
        tmesh.reset_collectives()
        assert cli.main(args + extra) == 0
        assert tmesh.COLLECTIVES["all_to_all"] == calls
        outs.append(codec.imread(str(tmp_path / out /
                                     "stitching_result_1.png"), color=False))
    np.testing.assert_array_equal(outs[0], outs[1])
