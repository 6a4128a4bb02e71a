"""The stretch configuration: a synthetic 1,024-tile grid, the whole
distributed flow.

Port of ``imagestitch_tpu/eval/stretch.py`` (:84-172).  A serpentine
G x G grid (default 32 x 32 tiles of 96 x 128) runs through the mesh:

  pair-sharded whole-tile phase registration  ->  spatial-hash loop-closure
  proposal and windowed phase verification    ->  the edge-sharded
  pose-graph solve                            ->  the sharded canvas.

Reports the chain's drift against the solved positions' (the reference's
prefix sum, Stitcher.py:404-405, drifts without bound) and the wall of
each stage.  The mesh is the first ``n_devices`` cards unless ``devices``
names its shards (``["cpu"] * 4``; ``["cuda:0"] * 4`` for four shards
sharing one card, whose walls say nothing of scaling).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def make_grid(grid: int = 32, tile: Tuple[int, int] = (96, 128),
              overlap: float = 0.25, noise_px: float = 1.5, seed: int = 0):
    """Serpentine tile sequence over one big textured sheet.

    Returns (tiles, true_positions): tiles in serpentine capture order and
    each tile's TRUE top-left on the sheet, with a jitter a step so that the
    chain accumulates drift.  numpy's ``default_rng(seed)`` draws them in
    the JAX package's order."""
    h, w = tile
    rng = np.random.default_rng(seed)
    step_r = int(h * (1 - overlap))
    step_c = int(w * (1 - overlap))
    sheet = np.clip(rng.normal(120, 46, (grid * step_r + h + 8,
                                         grid * step_c + w + 8)),
                    0, 255).astype(np.uint8)
    # salt with blobs so phase correlation locks decisively
    ys = rng.integers(2, sheet.shape[0] - 3, sheet.size // 400)
    xs = rng.integers(2, sheet.shape[1] - 3, sheet.size // 400)
    sheet[ys, xs] = 255
    sheet[ys + 1, xs] = 0
    pos = []
    for r in range(grid):
        cols = range(grid) if r % 2 == 0 else range(grid - 1, -1, -1)
        for c in cols:
            jr = int(rng.integers(-noise_px, noise_px + 1))
            jc = int(rng.integers(-noise_px, noise_px + 1))
            pr = min(max(r * step_r + jr, 0), sheet.shape[0] - h)
            pc = min(max(c * step_c + jc, 0), sheet.shape[1] - w)
            pos.append((pr, pc))
    tiles = np.stack([sheet[r:r + h, c:c + w] for r, c in pos])
    return tiles, np.asarray(pos, np.float64)


@dataclasses.dataclass
class StretchReport:
    backend: str
    n_devices: int
    n_tiles: int
    tile_shape: List[int]
    registered_ok: int
    loop_edges: int
    propose_s: float
    register_s: float
    verify_s: float
    solve_s: float
    compose_s: float
    chain_rmse_px: float
    solved_rmse_px: float
    canvas_shape: List[int]


def _rmse_vs_truth(est: np.ndarray, truth: np.ndarray) -> float:
    """RMSE after removing the global translation (gauge freedom)."""
    d = est - truth
    d = d - d.mean(axis=0, keepdims=True)
    return float(np.sqrt((d ** 2).sum(axis=1).mean()))


def run(grid: int = 32, tile: Tuple[int, int] = (96, 128),
        n_devices: Optional[int] = None, compose_panorama: bool = True,
        seed: int = 0, devices: Optional[Sequence] = None) -> StretchReport:
    from ..config import StitchConfig
    from ..parallel import compose_sharded as cs
    from ..parallel import pipeline
    from ..parallel.mesh import make_mesh
    from ..solver import loop_closure, pose_graph as pg
    from ..utils.profiling import block_until_ready

    mesh = make_mesh(n_devices, axis="pairs", devices=devices)
    dev0 = mesh.devices[0]
    tiles, truth = make_grid(grid, tile, seed=seed)
    n = tiles.shape[0]
    h, w = tile
    # one device: one upload, which registration, verification and the
    # canvas all read; a mesh places its own blocks
    tiles_io = torch.as_tensor(tiles).to(dev0) if mesh.size == 1 else tiles
    pair_mesh = mesh if mesh.size > 1 else None

    # 1. pair-sharded whole-tile 2x-padded phase registration: direction
    # -free, so the serpentine's sideways rows and downward row transitions
    # register in one step
    t0 = time.perf_counter()
    a, b, n_pairs = pipeline.make_pair_tensors(tiles_io, pair_mesh,
                                               device=dev0)
    sx, sy, resp = (x.cpu().numpy()[:n_pairs] for x in
                    pipeline.register_pairs_sharded_whole(a, b, pair_mesh))
    offsets = np.stack([-sy, -sx], axis=1)
    register_s = time.perf_counter() - t0
    ok = int((resp > 0.01).sum())
    chain = pg.chain_positions([tuple(o) for o in offsets])

    # 2. loop closure: spatial-hash proposal, windowed phase verification
    t0 = time.perf_counter()
    cands = loop_closure.propose_edges(chain, (h, w), min_overlap_frac=0.04,
                                       max_candidates=4096)
    propose_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = pg.PoseGraph.from_chain([tuple(o) for o in offsets],
                                    np.maximum(resp, 1e-3))
    ia, ib, meas, wgt = loop_closure.verify_edges(
        tiles_io, chain, cands, pad=24, response_threshold=0.05, device=dev0)
    if len(ia):
        chain_med = float(np.median(graph.weights))
        wgt = wgt / max(float(np.median(wgt)), 1e-6) * chain_med
        graph = graph.with_extra_edges(ia, ib, meas, wgt)
    verify_s = time.perf_counter() - t0

    # 3. the edge-sharded pose-graph solve (2 n CG steps)
    t0 = time.perf_counter()
    solved = pg.solve(graph, mesh=mesh)
    solve_s = time.perf_counter() - t0

    # 4. the sharded canvas from the solved positions
    compose_s = 0.0
    canvas_shape = [0, 0]
    if compose_panorama:
        cfg = StitchConfig(color_mode=False, fuse_method="fadeInAndFadeOut",
                           registration="phase_incre")
        pos = np.round(solved - solved.min(axis=0, keepdims=True)).astype(int)
        offs = [tuple((pos[i] - pos[i - 1]).tolist()) for i in range(1, n)]
        t0 = time.perf_counter()
        pano, _ = block_until_ready(cs.compose_sharded(
            tiles_io, offs, cfg, mesh, return_device=True))
        compose_s = time.perf_counter() - t0
        canvas_shape = list(pano.shape)

    return StretchReport(
        backend=dev0.type, n_devices=mesh.size, n_tiles=n,
        tile_shape=[h, w], registered_ok=ok, loop_edges=int(len(ia)),
        propose_s=round(propose_s, 3), register_s=round(register_s, 3),
        verify_s=round(verify_s, 3), solve_s=round(solve_s, 3),
        compose_s=round(compose_s, 3),
        chain_rmse_px=round(_rmse_vs_truth(chain, truth), 3),
        solved_rmse_px=round(_rmse_vs_truth(solved, truth), 3),
        canvas_shape=canvas_shape)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--grid", type=int, default=32)
    p.add_argument("--no-compose", action="store_true")
    p.add_argument("--devices", type=int,
                   help="mesh size (default: every card)")
    p.add_argument("--device", default="cuda",
                   help="cuda: the first --devices cards; cpu: --devices "
                        "CPU shards")
    p.add_argument("--out")
    args = p.parse_args(argv)
    shards = None if args.device == "cuda" else \
        [args.device] * (args.devices or 1)
    rep = run(grid=args.grid, n_devices=args.devices,
              compose_panorama=not args.no_compose, devices=shards)
    txt = json.dumps(dataclasses.asdict(rep), indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    print(txt)


if __name__ == "__main__":
    main()
