"""The port's single-device evaluation (``eval/synthetic.py``,
``eval/accuracy.py``, ``eval/loop_closure_demo.py``) against the JAX
package's, on the CPU.

The demo images are not in the repository, so the demo-root harnesses run
on a synthetic root: a seeded 3-down, 2-column serpentine of 320 x 448
frames written as JPEG under ``<root>/dendriticCrystal/1/`` (the layout
both harnesses read).  The accuracy harness runs its dendritic
configuration (4096 keypoints an attempt) with ``use_pallas=False`` on
both sides, the XLA detector's pool, as the JAX package runs off a TPU:
at this frame size the TPU's fused pool holds fewer slots than the
attempt takes, which the JAX package's top-k refuses.  The drift harness
(1024 keypoints) runs with the pools routed as on a TPU.

Tolerances, each held where it is stated:
  * ``overlap_ncc``, ``ncc_argmax_sweep``, the goldens, ``dataset_configs``
    (through ``convert.config_from_jax``), ``MODES`` and
    ``make_grid_graph``: equal (host numpy, the same RNG stream);
  * ``synthetic.run``: the grid's counts and the chain error equal, the
    solve's mean error within 2e-3 px of jax's (measured 1.5e-3): the CG
    stops at its step count, not converged to float32's resolution, so
    its iterate follows the rounding of every dot product, which the port
    sums in float64 (the same on the card and the CPU) and XLA in float32;
    2e-3 px is the float32 spacing of these positions (up to 2^15 px);
  * ``evaluate_dataset``: integer offsets, ``num_ok``, ``within_1px``,
    the compared and disputed pair counts equal; the float errors and
    NCCs within 1e-3;
  * ``loop_closure_demo.run``: tiles and loop edges equal, residuals
    within 1e-3 px.
"""
import dataclasses

import cv2
import numpy as np
import pytest
import torch

from conftest import REFERENCE_DEMO, has_demo_images
from imagestitch_tpu.eval import accuracy as jacc
from imagestitch_tpu.eval import loop_closure_demo as jlcd
from imagestitch_tpu.eval import synthetic as jsyn
from imagestitch_tpu_torch.convert import config_from_jax
from imagestitch_tpu_torch.eval import accuracy as tacc
from imagestitch_tpu_torch.eval import loop_closure_demo as tlcd
from imagestitch_tpu_torch.eval import synthetic as tsyn
from imagestitch_tpu_torch.utils import synthetic
from test_eval_accuracy import _pair
from test_torch_device import no_cuda  # noqa: F401 (a fixture)
from test_torch_jax_chain import route_pools_as_on_tpu, two_threads


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    yield from two_threads()


@pytest.fixture(scope="module")
def demo_root(tmp_path_factory):
    """<root>/dendriticCrystal/1/ holding a serpentine's 6 gray JPEGs."""
    root = tmp_path_factory.mktemp("demo")
    d = root / "dendriticCrystal" / "1"
    d.mkdir(parents=True)
    pos = synthetic.serpentine_positions(3, 2, (290.37, 400.21))
    frames = synthetic.sequence(17, (320, 448), pos)[0]
    for k, f in enumerate(frames):
        assert cv2.imwrite(str(d / f"img_{k:03d}.jpg"), f)
    return str(root)


def test_overlap_ncc_and_argmax_sweep_equal():
    """The cases of tests/test_eval_accuracy.py, a no-overlap and a
    constant patch, and a sweep around a true and a wrong offset."""
    for (dr, dc), offs in (((40, 8), [(40, 8), (41, 8), (40, 9), (37, 8),
                                      (40, 0)]),
                           ((0, 0), [(96, 128), (-96, 0), (0, 0)]),
                           ((3, -5), [(3, -5), (0, 0), (-2, 7)])):
        a, b = _pair(dr, dc) if dc >= 0 else _pair(dr, 0)
        for off in offs:
            assert tacc.overlap_ncc(a, b, off) == jacc.overlap_ncc(a, b, off)
        cands = [offs[0], offs[-1]]
        assert tacc.ncc_argmax_sweep(a, b, cands) == \
            jacc.ncc_argmax_sweep(a, b, cands)
    const = np.zeros((64, 64), np.uint8)
    assert tacc.overlap_ncc(const, const, (0, 0)) is None


def test_goldens_configs_and_modes_equal():
    assert tacc.DENDRITIC_GOLDEN_90 == jacc.DENDRITIC_GOLDEN_90
    assert tacc.dendritic_golden_89() == jacc.dendritic_golden_89()
    assert tacc.MODES == jacc.MODES
    for method in ("surf", "sift", "orb"):
        got, ref = tacc.dataset_configs(method), jacc.dataset_configs(method)
        assert list(got) == list(ref)
        for name in ref:
            assert got[name] == config_from_jax(ref[name]), name
    assert [f.name for f in dataclasses.fields(tacc.DatasetAccuracy)] == \
        [f.name for f in dataclasses.fields(jacc.DatasetAccuracy)]


def test_make_grid_graph_equal():
    for gh, gw, seed in ((10, 10, 3), (25, 40, 0), (4, 7, 11)):
        (tg, tt), (jg, jt) = (tsyn.make_grid_graph(gh, gw, seed=seed),
                              jsyn.make_grid_graph(gh, gw, seed=seed))
        np.testing.assert_array_equal(tt, jt)
        for f in ("edges_a", "edges_b", "measurements", "weights"):
            got, ref = getattr(tg, f), getattr(jg, f)
            assert got.dtype == ref.dtype, f
            np.testing.assert_array_equal(got, ref)
        assert tg.n_nodes == jg.n_nodes


def test_synthetic_run_matches_jax():
    got = tsyn.run(10, 10, n_devices=1, iters=300, seed=3, device="cpu")
    ref = jsyn.run(10, 10, n_devices=1, iters=300, seed=3)
    assert (got.n_tiles, got.n_edges, got.n_devices) == \
        (ref.n_tiles, ref.n_edges, ref.n_devices) == (100, 180, 1)
    assert got.chain_mean_abs_err_px == ref.chain_mean_abs_err_px
    assert abs(got.mean_abs_err_px - ref.mean_abs_err_px) <= 2e-3
    assert got.mean_abs_err_px < 2.0
    assert got.mean_abs_err_px < got.chain_mean_abs_err_px / 3
    # two shards take the edge-sharded solve: jax's two-device run's
    # accuracy, within the sharded solves' float32 spread
    got2 = tsyn.run(10, 10, n_devices=2, iters=300, seed=3, device="cpu")
    ref2 = jsyn.run(10, 10, n_devices=2, iters=300, seed=3)
    assert (got2.n_tiles, got2.n_edges, got2.n_devices) == (100, 180, 2)
    assert got2.chain_mean_abs_err_px == ref2.chain_mean_abs_err_px
    assert abs(got2.mean_abs_err_px - ref2.mean_abs_err_px) <= 2e-3
    assert got2.mean_abs_err_px < got2.chain_mean_abs_err_px / 3


def _hold_accuracy(got, ref):
    g, r = dataclasses.asdict(got), dataclasses.asdict(ref)
    assert [tuple(o) for o in g.pop("offsets")] == \
        [tuple(o) for o in r.pop("offsets")]
    gd, rd = g.pop("pair_detail") or [], r.pop("pair_detail") or []
    assert [sorted(d) for d in gd] == [sorted(d) for d in rd]
    for a, b in zip(gd, rd):
        for k in a:
            if isinstance(a[k], float):
                assert abs(a[k] - b[k]) <= 1e-3, k
            else:
                assert list(np.atleast_1d(a[k])) == \
                    list(np.atleast_1d(b[k])), k
    for k in g:
        if isinstance(g[k], float) or isinstance(r[k], float):
            assert abs(g[k] - r[k]) <= 1e-3, k
        else:
            assert g[k] == r[k], k


def test_evaluate_dataset_matches_jax(demo_root, capsys):
    """The dendritic entry of ``dataset_configs()`` with ``use_pallas``
    off: 5 pairs, scored by the cv2.SIFT oracle.  ``run`` and ``main``
    skip the datasets the root does not hold."""
    name = "dendriticCrystal"
    got = tacc.evaluate_dataset(
        demo_root, name,
        tacc.dataset_configs()[name].replace(use_pallas=False), device="cpu")
    ref = jacc.evaluate_dataset(
        demo_root, name, jacc.dataset_configs()[name].replace(
            use_pallas=False))
    _hold_accuracy(got, ref)
    assert got.num_pairs == got.num_ok == 5
    assert got.compared_pairs == 5 and got.within_1px == 5
    assert tacc.run(demo_root, names=["iron"], device="cpu") == {}
    tacc.main(["--demo-root", demo_root, "--datasets", "iron",
               "--device", "cpu"])
    assert capsys.readouterr().out.strip() == "{}"


def test_loop_closure_demo_matches_jax(demo_root, monkeypatch):
    route_pools_as_on_tpu(monkeypatch)
    got = tlcd.run(demo_root, device="cpu")
    ref = jlcd.run(demo_root)
    assert (got.name, got.n_tiles, got.n_loop_edges) == \
        (ref.name, ref.n_tiles, ref.n_loop_edges)
    assert got.n_tiles == 6 and got.n_loop_edges >= 2
    for f in ("chain_mean_residual_px", "chain_max_residual_px",
              "solved_mean_residual_px", "solved_max_residual_px"):
        assert abs(getattr(got, f) - getattr(ref, f)) <= 1e-3, f
    assert got.solved_max_residual_px <= got.chain_max_residual_px


def test_eval_entry_points_need_cuda(no_cuda, demo_root):  # noqa: F811
    cfg = tacc.dataset_configs()["dendriticCrystal"]
    for fn in (lambda: tsyn.run(4, 4),
               lambda: tacc.evaluate_dataset(demo_root, "dendriticCrystal",
                                             cfg),
               lambda: tlcd.run(demo_root)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_real_dendritic_subset_matches_jax(monkeypatch):
    """On the real dendritic frames, where present: a 14-frame subset 2x
    downsampled (tests/test_loop_closure.py's), the port against jax."""
    if not has_demo_images():
        pytest.skip("reference demoImages not present")
    route_pools_as_on_tpu(monkeypatch)
    got = tlcd.run(REFERENCE_DEMO, subset=(8, 22), downsample=2,
                   device="cpu")
    ref = jlcd.run(REFERENCE_DEMO, subset=(8, 22), downsample=2)
    assert got.n_loop_edges == ref.n_loop_edges >= 3
    assert abs(got.solved_mean_residual_px
               - ref.solved_mean_residual_px) <= 1e-3


@pytest.mark.cuda
def test_cuda_eval_equal_cpu(demo_root):
    """The grid solve, the accuracy harness and the drift report on the
    card against the port's CPU run; the card's solve is equal from run to
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    card = [tsyn.run(10, 10, iters=300, seed=3) for _ in range(2)]
    cpu = tsyn.run(10, 10, iters=300, seed=3, device="cpu")
    assert card[0].mean_abs_err_px == card[1].mean_abs_err_px
    assert abs(card[0].mean_abs_err_px - cpu.mean_abs_err_px) <= 1e-2
    cfg = tacc.dataset_configs()["dendriticCrystal"]
    _hold_accuracy(tacc.evaluate_dataset(demo_root, "dendriticCrystal", cfg),
                   tacc.evaluate_dataset(demo_root, "dendriticCrystal", cfg,
                                         device="cpu"))
    got, ref = tlcd.run(demo_root), tlcd.run(demo_root, device="cpu")
    assert got.n_loop_edges == ref.n_loop_edges
    assert abs(got.solved_mean_residual_px
               - ref.solved_mean_residual_px) <= 1e-2
