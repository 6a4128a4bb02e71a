"""The edge-sharded solve, the parallel harnesses (eval/synthetic.py with
shards, eval/stretch.py, eval/compose_bench.py, eval/scaling.py), the
multi-process runtime (parallel/distributed.py and a real two-process gloo
run of parallel/multiproc_worker.py), the whole-image phase path's mesh
budget and the CLI's ``--mesh``, against the JAX package where it has the
same function.

Tolerances: the sharded solve within 1e-3 px of jax's sharded solve and
equal once rounded, on tests/test_torch_solver.py's graphs (the port sums
the Laplacian's terms in XLA's scatter order and the shards in mesh order,
its dot products in float64; an unconverged CG follows every rounding, so
it is held to jax's sharded solve, not to the single-device one); the
stretch report's RMSEs within 5e-3 px of jax's (its phase shifts come from
another FFT library)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from imagestitch_tpu.eval import compose_bench as jbench
from imagestitch_tpu.eval import stretch as jstretch
from imagestitch_tpu.eval import synthetic as jsyn
from imagestitch_tpu.parallel import distributed as jdist
from imagestitch_tpu.parallel.mesh import make_mesh as jmake_mesh
from imagestitch_tpu.solver import pose_graph as jpg
from imagestitch_tpu_torch import StitchConfig, cli
from imagestitch_tpu_torch.core import registration as treg
from imagestitch_tpu_torch.eval import compose_bench, scaling, stretch
from imagestitch_tpu_torch.eval import synthetic as tsyn
from imagestitch_tpu_torch.io import codec
from imagestitch_tpu_torch.parallel import distributed as tdist
from imagestitch_tpu_torch.parallel import multiproc_worker
from imagestitch_tpu_torch.parallel.mesh import make_mesh
from imagestitch_tpu_torch.solver import pose_graph as tpg
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import two_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the shards lie on the card")
    return torch.device("cuda", 0)


def _solver_graphs():
    """tests/test_torch_solver.py's graphs: a weighted chain, and a 4 x 4
    serpentine's noisy chain with 9 loop edges."""
    rng = np.random.default_rng(0)
    offs = rng.normal((100.0, 3.0), (4.0, 1.0), (12, 2)).tolist()
    chain = tpg.PoseGraph.from_chain(offs, rng.uniform(1, 20, 12))
    rng = np.random.default_rng(1)
    true = np.asarray(synthetic.serpentine_positions(4, 4, (100.5, 150.25)))
    offs = (np.diff(true, axis=0) + rng.normal(0, 2, (15, 2))).tolist()
    a, b = [0, 1, 2, 4, 5, 6, 8, 9, 10], [7, 6, 5, 11, 10, 9, 15, 14, 13]
    extra = (a, b, true[b] - true[a], rng.uniform(1, 5, 9))
    grid = tpg.PoseGraph.from_chain(offs, rng.uniform(5, 30, 15)
                                    ).with_extra_edges(*extra)
    return chain, grid


def _as_jax(g):
    return jpg.PoseGraph(g.edges_a, g.edges_b, g.measurements, g.weights,
                         g.n_nodes)


def test_sharded_solve_matches_jax_sharded_solve():
    for g in _solver_graphs():
        for d in (2, 4, 8):
            mesh = make_mesh(devices=["cpu"] * d)
            for iters in (None, 12):
                got = tpg.solve(g, iters=iters, mesh=mesh)
                ref = jpg.solve(_as_jax(g), iters=iters, mesh=jmake_mesh(d))
                assert got.dtype == np.float32 and np.all(got[0] == 0)
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
                np.testing.assert_array_equal(
                    np.round(got.astype(np.float64)),
                    np.round(ref.astype(np.float64)))


def test_synthetic_run_on_four_shards():
    got = tsyn.run(10, 10, n_devices=4, iters=300, seed=3, device="cpu")
    ref = jsyn.run(10, 10, n_devices=4, iters=300, seed=3)
    assert (got.n_tiles, got.n_edges, got.n_devices) == (100, 180, 4)
    assert got.chain_mean_abs_err_px == ref.chain_mean_abs_err_px
    assert abs(got.mean_abs_err_px - ref.mean_abs_err_px) <= 2e-3
    assert got.mean_abs_err_px < got.chain_mean_abs_err_px / 3


def test_stretch_small_grid_matches_jax():
    """A 6 x 6 grid of 96 x 128 tiles over 4 shards: pair-sharded
    registration, loop closure, the sharded solve and canvas; the solve
    beats the chain."""
    got = stretch.run(grid=6, devices=["cpu"] * 4)
    ref = jstretch.run(grid=6, n_devices=4)
    assert (got.backend, got.n_devices, got.n_tiles, got.tile_shape) == \
        ("cpu", 4, 36, [96, 128])
    assert (got.registered_ok, got.loop_edges, got.canvas_shape) == \
        (ref.registered_ok, ref.loop_edges, ref.canvas_shape)
    assert abs(got.chain_rmse_px - ref.chain_rmse_px) <= 5e-3
    assert abs(got.solved_rmse_px - ref.solved_rmse_px) <= 5e-3
    assert got.solved_rmse_px < got.chain_rmse_px


def test_compose_bench_and_scaling_run():
    got = compose_bench.run(devices=["cpu"] * 4, repeats=1)
    ref = jbench.run(n_devices=4, repeats=1)
    assert (got.n_frames, got.canvas_shape, got.sharded_fuse_psums) == \
        (ref.n_frames, ref.canvas_shape, ref.sharded_fuse_psums) == \
        (24, [793, 1805], 23)
    assert got.collectives["psum"] == 23 and got.sharded_dispatches == 24
    assert got.collectives["psum_bytes"] == got.psum_payload_bytes
    assert got.single_fps > 0 and got.sharded_fps > 0 and got.note
    rep = scaling.run(device_counts=[1, 2], devices=["cpu"] * 2, repeats=1)
    assert (rep.mode, rep.n_frames, rep.backend) == ("phase", 33, "cpu")
    assert [p.n_devices for p in rep.points] == [1, 2]
    assert all(p.frames_per_s > 0 for p in rep.points)
    assert [p.collectives["all_gather"] for p in rep.points] == [0, 1]


def test_host_shard_matches_jax():
    files = [f"f{i}" for i in range(10)]
    for count in (1, 2, 3, 4):
        for index in range(count):
            for overlap in (0, 1):
                t = tdist.RuntimeContext(make_mesh(devices=["cpu"]), index,
                                         count)
                j = jdist.RuntimeContext(jmake_mesh(1), index, count)
                assert tdist.host_shard(files, t, overlap) == \
                    jdist.host_shard(files, j, overlap)
    ctx = tdist.RuntimeContext(make_mesh(devices=["cpu"]), 1, 4)
    assert tdist.host_shard(files, ctx) == ["f3", "f4", "f5", "f6"]
    assert not ctx.is_coordinator


def test_two_process_gloo_runtime(tmp_path):
    """Two gloo processes of 2 CPU shards each (file:// rendezvous):
    disjoint pairs covering all 4, the same gathered records and mean
    response on both, equal to the one-process run over 4 shards."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "imagestitch_tpu_torch.parallel.multiproc_worker", init, "2",
         str(pid), str(tmp_path), "--device", "cpu", "--shards", "2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    recs = [json.loads((tmp_path / f"proc{pid}.json").read_text())
            for pid in (0, 1)]
    assert [r["process_count"] for r in recs] == [2, 2]
    assert sorted(recs[0]["my_pairs"] + recs[1]["my_pairs"]) == [0, 1, 2, 3]
    r0, r1 = (np.asarray(r["records"]) for r in recs)
    assert r0.shape == (4, 3)
    np.testing.assert_array_equal(r0, r1)
    assert recs[0]["mean_resp"] == recs[1]["mean_resp"]
    one = multiproc_worker.run(tdist.initialize(devices=["cpu"] * 4), 4)
    np.testing.assert_array_equal(np.asarray(one["records"]), r0)
    assert abs(one["mean_resp"] - recs[0]["mean_resp"]) <= 1e-6
    assert np.all(np.abs(np.abs(r0[:, 1]) - 40) < 1.5)


def test_phase_whole_over_budget_raises_naming_tp_fft():
    """Over ``phase_hbm_budget`` a mesh of two or more shards takes the
    tensor-parallel FFT (parallel/tp_fft.py; it once raised, naming it):
    the one-device records, sub-pixel within 5e-3 px and confidence within
    1e-3.  Within it, or on one shard, the whole-image path runs on the
    mesh's first device."""
    pos = synthetic.serpentine_positions(2, 1, (40.37, 0.21))
    frames, _ = synthetic.sequence(0, (96, 128), pos)
    cfg = StitchConfig(registration="phase", phase_hbm_budget=1)
    single = treg.register_sequence_phase_whole(frames, cfg, device="cpu")
    sharded = treg.register_sequence_phase_whole(
        frames, cfg, mesh=make_mesh(devices=["cpu"] * 2))
    for s, r in zip(sharded, single):
        assert (s.ok, s.offset, s.direction) == (r.ok, r.offset, r.direction)
        np.testing.assert_allclose(s.offset_subpix, r.offset_subpix,
                                   atol=5e-3)
        assert abs(s.confidence - r.confidence) < 1e-3
    one = treg.register_sequence_phase_whole(
        frames, cfg, mesh=make_mesh(devices=["cpu"]))
    assert one == single
    assert one[0].ok and abs(one[0].offset[0] - 40) <= 1


def test_cli_mesh(tmp_path, monkeypatch):
    """``--mesh 2 --device cpu`` writes the single-device panorama; on a
    machine with one card ``--mesh 2`` exits non-zero, naming it."""
    pos = synthetic.serpentine_positions(3, 1, (70.37, 0.21))
    frames, _ = synthetic.sequence(3, (128, 160), pos)
    os.makedirs(tmp_path / "proj" / "1")
    for i, f in enumerate(frames):
        codec.imwrite(str(tmp_path / "proj" / "1" / f"f{i}.png"), f)
    args = ["stitch", str(tmp_path / "proj"), "", "--file-extension", "png",
            "--output-extension", "png", "--gray", "--max-keypoints", "256",
            "--quiet", "--device", "cpu"]
    outs = []
    for extra, out in (([], "one"), (["--mesh", "2"], "two")):
        args[2] = str(tmp_path / out)
        assert cli.main(args + extra) == 0
        outs.append(codec.imread(str(tmp_path / out /
                                     "stitching_result_1.png"), color=False))
    np.testing.assert_array_equal(outs[0], outs[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--mesh 2: .*1 CUDA device"):
        cli.main(args[:-2] + ["--mesh", "2"])


@pytest.mark.cuda
def test_cuda_sharded_solve_equals_the_cpu(cuda_device):
    """Four shards on one card: the positions equal the CPU shards' bit
    for bit, on the solver graphs and on the 1,000-tile grid."""
    big, _ = tsyn.make_grid_graph(25, 40)
    card = make_mesh(devices=["cuda:0"] * 4)
    cpu = make_mesh(devices=["cpu"] * 4)
    for g, iters in [(g, None) for g in _solver_graphs()] + [(big, 400)]:
        got = tpg.solve(g, iters=iters, mesh=card)
        ref = tpg.solve(g, iters=iters, mesh=cpu)
        assert got.tobytes() == ref.tobytes()
