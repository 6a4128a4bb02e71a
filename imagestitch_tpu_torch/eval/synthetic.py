"""Synthetic serpentine tile grid: the pose-graph solve at scale.

Port of ``imagestitch_tpu/eval/synthetic.py``: a large serpentine-scanned
tile grid whose pairwise offsets (Gaussian noise, and a few gross outliers
at low confidence) feed the weighted least-squares solve of
``solver/pose_graph.solve``, edge-sharded over a mesh of ``n_devices``
shards when there are two or more.  Reports the solve's accuracy against
the truth beside the reference's prefix-sum chain, and its time.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import make_mesh
from ..solver import pose_graph as pg


@dataclasses.dataclass
class GridResult:
    n_tiles: int
    n_edges: int
    mean_abs_err_px: float
    chain_mean_abs_err_px: float
    solve_seconds: float
    n_devices: int


def make_grid_graph(gh: int, gw: int, spacing=(1800.0, 2400.0),
                    noise_px: float = 1.0, outlier_frac: float = 0.02,
                    seed: int = 0) -> Tuple[pg.PoseGraph, np.ndarray]:
    """Grid with row and column edges, Gaussian noise, and a few gross
    outlier measurements at weight 0.01 (numpy's ``default_rng(seed)``
    draws them in the JAX package's order) -> (graph, (N, 2) truth)."""
    rng = np.random.default_rng(seed)
    truth = np.array([[i * spacing[0], j * spacing[1]]
                      for i in range(gh) for j in range(gw)], np.float64)
    node = lambda i, j: i * gw + j
    ea, eb, m, w = [], [], [], []
    for i in range(gh):
        for j in range(gw):
            if j + 1 < gw:
                ea.append(node(i, j))
                eb.append(node(i, j + 1))
                m.append([0.0, spacing[1]])
                w.append(1.0)
            if i + 1 < gh:
                ea.append(node(i, j))
                eb.append(node(i + 1, j))
                m.append([spacing[0], 0.0])
                w.append(1.0)
    m = np.asarray(m) + rng.normal(0, noise_px, (len(m), 2))
    w = np.asarray(w, np.float32)
    n_out = int(outlier_frac * len(m))
    out_idx = rng.choice(len(m), n_out, replace=False)
    m[out_idx] += rng.normal(0, 200.0, (n_out, 2))   # gross outliers
    w[out_idx] = 0.01                                 # low confidence
    g = pg.PoseGraph(edges_a=np.asarray(ea, np.int32),
                     edges_b=np.asarray(eb, np.int32),
                     measurements=m.astype(np.float32), weights=w,
                     n_nodes=gh * gw)
    return g, truth


def _chain(g: pg.PoseGraph, gh: int, gw: int, n: int) -> np.ndarray:
    """The reference's accumulation: each row from its left neighbour, each
    row's first tile from the one above."""
    chain = np.zeros((n, 2))
    meas = {(a, b): mm for a, b, mm in zip(g.edges_a, g.edges_b,
                                           g.measurements)}
    node = lambda i, j: i * gw + j
    for i in range(gh):
        for j in range(gw):
            if i == 0 and j == 0:
                continue
            if j > 0:
                chain[node(i, j)] = chain[node(i, j - 1)] + \
                    meas[(node(i, j - 1), node(i, j))]
            else:
                chain[node(i, 0)] = chain[node(i - 1, 0)] + \
                    meas[(node(i - 1, 0), node(i, 0))]
    return chain


def run(gh: int = 25, gw: int = 40, n_devices: Optional[int] = None,
        iters: int = 400, seed: int = 0, device="cuda") -> GridResult:
    """Solve the ``gh`` x ``gw`` grid, once to warm up and once timed (the
    solve returns host positions, so the time ends after the readback).
    ``n_devices`` (default: every card, as JAX :66-67): two or more take
    the edge-sharded solve over a mesh of that many shards, the first
    cards, or shards sharing ``device`` when it is the CPU; one solves on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device, "eval.synthetic.run")
    nd = n_devices or max(torch.cuda.device_count(), 1)
    mesh = None
    if nd > 1:
        mesh = make_mesh(nd, devices=[dev] * nd if dev.type == "cpu"
                         else None)
    g, truth = make_grid_graph(gh, gw, seed=seed)
    pg.solve(g, iters=iters, mesh=mesh, device=dev)
    t0 = time.perf_counter()
    x = pg.solve(g, iters=iters, mesh=mesh, device=dev)
    dt = time.perf_counter() - t0
    err = np.abs((x - x[0]) - (truth - truth[0])).mean()
    chain_err = np.abs(_chain(g, gh, gw, len(truth)) - truth).mean()
    return GridResult(n_tiles=gh * gw, n_edges=len(g.edges_a),
                      mean_abs_err_px=float(err),
                      chain_mean_abs_err_px=float(chain_err),
                      solve_seconds=dt, n_devices=nd)


def main():
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--grid", type=int, nargs=2, default=[25, 40])
    p.add_argument("--devices", type=int)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    res = run(args.grid[0], args.grid[1], args.devices, args.iters,
              device=args.device)
    print(json.dumps(dataclasses.asdict(res)))


if __name__ == "__main__":
    main()
