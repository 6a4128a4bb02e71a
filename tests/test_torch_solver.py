"""The global pose-graph solver with loop closure (solver/pose_graph.py,
solver/loop_closure.py) and the composers from absolute positions
(core/compose.compose_from_positions, core/stream_out.
compose_host_positions) against the JAX package's, on the CPU.

Tolerances, each held where it is stated:
  * ``solve``: positions within 1e-3 px of jax's (float32 CG; the port
    sums the Laplacian's terms in XLA's scatter order, but its dot
    products in another) and equal once rounded half to even, as
    ``plan_compose_positions`` rounds them;
  * ``propose_edges`` equal; ``verify_edges`` the same edges, the
    measurements within 2e-3 px and the responses within 2e-3 relative:
    the whitened correlation moves with the windows' last bits, and the
    JAX function's own result moves by 1e-3 px between its batched call
    and a single pair's on the same windows.  On these frames each
    response lies more than 0.1 from the 0.05 threshold, so no edge sits
    at it;
  * ``compose_from_positions`` and ``compose_host_positions`` bit-equal;
  * ``Stitcher(use_global_solver=True)``: records and panoramas equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagestitch_tpu import FeatureConfig as JFeatureConfig
from imagestitch_tpu import StitchConfig as JStitchConfig
from imagestitch_tpu.core import compose as jcompose
from imagestitch_tpu.core import stream_out as jstream
from imagestitch_tpu.solver import loop_closure as jlc
from imagestitch_tpu.solver import pose_graph as jpg
from imagestitch_tpu_torch import StitchConfig, compose_host_positions
from imagestitch_tpu_torch.core import compose as tcompose
from imagestitch_tpu_torch.parallel.mesh import make_mesh
from imagestitch_tpu_torch.solver import loop_closure as tlc
from imagestitch_tpu_torch.solver import pose_graph as tpg
from imagestitch_tpu_torch.utils import synthetic
from test_torch_jax_chain import (assert_segments_equal,
                                  route_pools_as_on_tpu, stitch_both,
                                  two_threads)

H, W = 160, 224


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def grid():
    """A 3-down, 2-column serpentine (6 frames) and its true pairwise
    offsets."""
    pos = synthetic.serpentine_positions(3, 2, (121.37, 170.21))
    return synthetic.sequence(13, (H, W), pos)


def _graphs(offsets, conf, extra=None):
    out = [pkg.PoseGraph.from_chain(offsets, conf) for pkg in (jpg, tpg)]
    if extra is not None:
        out = [g.with_extra_edges(*extra) for g in out]
    return out


def _hold_positions(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(np.round(got.astype(np.float64)),
                                  np.round(ref.astype(np.float64)))


def test_solve_chain_matches_jax():
    """A weighted chain: the prefix sum of its measurements."""
    rng = np.random.default_rng(0)
    offs = rng.normal((100.0, 3.0), (4.0, 1.0), (12, 2)).tolist()
    conf = rng.uniform(1, 20, 12)
    jg, tg = _graphs(offs, conf)
    got, ref = tpg.solve(tg, device="cpu"), jpg.solve(jg)
    assert got.shape == ref.shape == (13, 2) and got.dtype == np.float32
    _hold_positions(got, ref)
    assert np.all(got[0] == 0)
    np.testing.assert_allclose(got, tpg.chain_positions(offs), atol=2e-3)
    np.testing.assert_array_equal(tpg.chain_positions(offs),
                                  jpg.chain_positions(offs))


def test_solve_grid_with_loop_edges_matches_jax():
    """A 4 x 4 serpentine's chain with noisy offsets plus 9 loop edges at
    the true offsets: the loops pull the positions off the chain's, as in
    jax, at the default and at a small iteration count."""
    rng = np.random.default_rng(1)
    true = np.asarray(synthetic.serpentine_positions(4, 4, (100.5, 150.25)))
    offs = (np.diff(true, axis=0) + rng.normal(0, 2, (15, 2))).tolist()
    a, b = [0, 1, 2, 4, 5, 6, 8, 9, 10], [7, 6, 5, 11, 10, 9, 15, 14, 13]
    extra = (a, b, true[b] - true[a], rng.uniform(1, 5, 9))
    jg, tg = _graphs(offs, rng.uniform(5, 30, 15), extra)
    for iters in (None, 12):
        got = tpg.solve(tg, iters=iters, device="cpu")
        _hold_positions(got, jpg.solve(jg, iters=iters))
    assert np.abs(got - tpg.chain_positions(offs)).max() > 1.0


def test_node_table_sums_in_scatter_order():
    """The gather table adds each node's terms as the scatters add them:
    bit-equal to sequential ``index_add_`` on the CPU, on edges that
    share nodes both ways."""
    ea = np.asarray([0, 1, 2, 0, 3, 1], np.int32)
    eb = np.asarray([1, 2, 3, 3, 0, 3], np.int32)
    t = torch.as_tensor(np.random.default_rng(2).normal(0, 1e3, (6, 2)),
                        dtype=torch.float32)
    table = torch.as_tensor(tpg._node_table(ea, eb, 4))
    ref = torch.zeros(4, 2).index_add_(0, torch.as_tensor(ea).long(), t)
    ref = ref.index_add_(0, torch.as_tensor(eb).long(), -t)
    assert torch.equal(tpg._scatter(t, -t, table), ref)


def test_mesh_raises_naming_item_22():
    """A mesh no longer raises: one edge over two shards (the second shard
    holds a zero-weight padding edge) solves to the chain, and
    ``sharded_solve_fn`` runs on padded edge arrays."""
    g = tpg.PoseGraph.from_chain([(1.0, 2.0)])
    mesh = make_mesh(devices=["cpu"] * 2)
    np.testing.assert_allclose(tpg.solve(g, mesh=mesh),
                               [[0, 0], [1, 2]], atol=1e-4)
    x = tpg.sharded_solve_fn(mesh, 2, 4)(
        np.asarray([0, 0], np.int32), np.asarray([1, 0], np.int32),
        np.asarray([[1, 2], [0, 0]], np.float32),
        np.asarray([1, 0], np.float32))
    assert x.shape == (2, 2)
    np.testing.assert_allclose((x - x[:1]).numpy(), [[0, 0], [1, 2]],
                               atol=1e-4)


def test_verify_edges_and_close_loops_match_jax(grid):
    """The serpentine's non-adjacent candidates proposed from the chain
    positions and measured by windowed phase correlation; the two that
    overlap side by side (frames 1-4, 0-5) measure their true offsets
    within 0.5 px (the 5x5 centroid's sub-pixel bias, the same in jax)."""
    frames, truth = grid
    chain = jpg.chain_positions(np.round(truth))
    cands = tlc.propose_edges(chain, (H, W))
    assert cands == jlc.propose_edges(chain, (H, W)) and len(cands) == 6
    every = [f(frames, chain, cands, response_threshold=-1.0, **kw)[3]
             for f, kw in ((tlc.verify_edges, dict(device="cpu")),
                           (jlc.verify_edges, {}))]
    np.testing.assert_allclose(every[0], every[1], rtol=2e-3, atol=0)
    assert np.all(np.abs(every[0] - 0.05) > 0.1)
    got = tlc.verify_edges(frames, chain, cands, device="cpu")
    ref = jlc.verify_edges(frames, chain, cands)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[3], ref[3], rtol=2e-3, atol=0)
    pos = np.concatenate([np.zeros((1, 2)), np.cumsum(truth, axis=0)])
    kept = list(zip(got[0].tolist(), got[1].tolist()))
    for pair in ((1, 4), (0, 5)):
        k = kept.index(pair)
        np.testing.assert_allclose(got[2][k], pos[pair[1]] - pos[pair[0]],
                                   atol=0.5)
    offs, conf = truth.tolist(), np.arange(1.0, len(truth) + 1)
    jg, tg = _graphs(offs, conf)
    (tg2, n_t), (jg2, n_j) = (
        tlc.close_loops(frames, tg, chain, (H, W), device="cpu"),
        jlc.close_loops(frames, jg, chain, (H, W)))
    assert n_t == n_j == len(got[0])
    for f in ("edges_a", "edges_b"):
        np.testing.assert_array_equal(getattr(tg2, f), getattr(jg2, f))
    np.testing.assert_allclose(tg2.weights, jg2.weights, rtol=4e-3)
    assert tlc.verify_edges(frames, chain, [], device="cpu")[0].shape == (0,)


@pytest.mark.parametrize("color", [False, True])
def test_compose_from_positions_bit_equal(grid, color):
    """Fractional positions (some at .5, rounded half to even) with a
    negative one; fade, and notFuse on color."""
    frames, truth = grid
    if color:
        frames = np.stack([frames, frames // 2, 255 - frames], axis=-1)
    pos = np.concatenate([np.zeros((1, 2)), np.cumsum(truth, axis=0)])
    pos[2] += (0.5, -0.5)
    pos[3, 1] = -3.5
    for method in ("fadeInAndFadeOut", "notFuse") if color else \
            ("fadeInAndFadeOut", "trigonometric"):
        jcfg = JStitchConfig(fuse_method=method)
        ref = np.asarray(jcompose.compose_from_positions(frames, pos, jcfg))
        got = tcompose.compose_from_positions(
            frames, pos, StitchConfig(fuse_method=method), device="cpu")
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        assert tcompose.plan_compose_positions(pos, (H, W), jcfg) == \
            jcompose.plan_compose_positions(pos, (H, W), jcfg)


def test_compose_host_positions_matches_jax(grid):
    """The host float64 composer from positions, gray and color, against
    the JAX package's (both through the shared C++ runtime where it
    builds, else numpy)."""
    frames, truth = grid
    pos = np.concatenate([np.zeros((1, 2)), np.cumsum(truth, axis=0)])
    for f in (frames, np.stack([frames, frames // 3, frames], axis=-1)):
        ref = jstream.compose_host_positions(f, pos, JStitchConfig())
        got = compose_host_positions(f, pos, StitchConfig())
        np.testing.assert_array_equal(got, ref)


def test_stitcher_global_solver_matches_jax(grid, monkeypatch):
    """``Stitcher(use_global_solver=True)`` end to end on the 6-frame
    serpentine against the JAX Stitcher (pools routed as on a TPU): the
    pooled registration, loop closure, the solve and the composition from
    its positions."""
    route_pools_as_on_tpu(monkeypatch)
    frames, truth = grid
    jcfg = JStitchConfig(color_mode=False, roi_ratio=0.2,
                         use_global_solver=True,
                         features=JFeatureConfig(max_keypoints=256,
                                                 upright=True))
    got, ref = stitch_both(frames, jcfg)
    assert_segments_equal(got, ref)
    g, r = got[0].report, ref[0].report
    assert g.offsets == r.offsets and g.num_ok == len(truth)
    assert g.confidences == r.confidences
