"""Serpentine-grid drift: the chain against the solver with loop closure.

Port of ``imagestitch_tpu/eval/loop_closure_demo.py``.  On a serpentine
grid (the dendritic demo), registration chains the pairwise offsets and the
row-to-row drift accumulates (the reference's prefix sum,
Stitcher.py:404-405).  Loop-closure edges measure the offsets between the
overlapping tiles of neighbouring columns; the residual of those
measurements under a set of positions is the drift metric:

    residual(e=(i,j)) = || (pos[j] - pos[i]) - measurement_e ||_inf

Chain positions ignore the loop measurements, so their residuals show the
accumulated drift; the solved positions (weighted least squares over the
chain and loop edges) should shrink them to registration noise.
Registration, the loop edges' phase correlation and the solve run on
``device`` (the card unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from ..config import FeatureConfig, StitchConfig
from ..core import feature_registration as freg
from ..device import resolve_device
from ..io import dataset
from ..solver import loop_closure, pose_graph as pg


@dataclasses.dataclass
class DriftReport:
    name: str
    n_tiles: int
    n_loop_edges: int
    chain_mean_residual_px: float
    chain_max_residual_px: float
    solved_mean_residual_px: float
    solved_max_residual_px: float


def _residuals(pos: np.ndarray, ia, ib, meas) -> np.ndarray:
    d = pos[ib] - pos[ia]
    return np.abs(d - meas).max(axis=1)


def run(demo_root: str, name: str = "dendriticCrystal",
        subset: Optional[Tuple[int, int]] = None, downsample: int = 1,
        device="cuda") -> DriftReport:
    """``<demo_root>/<name>/1/*.jpg`` registered as the reference's
    Main.py registers the dendritic set (``feature_incre``, serpentine),
    then the largest stitchable segment's loop edges and solve.
    ``subset``: an optional (start, end) frame range; ``downsample``: an
    integer block-mean factor."""
    dev = resolve_device(device, "loop_closure_demo.run")
    files = dataset.list_project_images(os.path.join(demo_root, name), 1)
    if subset is not None:
        files = files[subset[0]:subset[1]]
    gray_all = dataset.load_batch(files, color_mode=False).gray
    if downsample > 1:
        n0, h0, w0 = gray_all.shape
        h2 = (h0 // downsample) * downsample
        w2 = (w0 // downsample) * downsample
        gray_all = gray_all[:, :h2, :w2].reshape(
            n0, h2 // downsample, downsample, w2 // downsample, downsample
        ).mean(axis=(2, 4)).astype(np.uint8)
    cfg = StitchConfig(registration="feature_incre", direction=1,
                       direct_incre=1, roi_ratio=0.2,
                       features=FeatureConfig(method="surf"))
    recs = freg.register_sequence_features_incre(gray_all, cfg, device=dev)
    # largest stitchable segment (a failed pair breaks the chain)
    segs, start = [], 0
    for k, r in enumerate(recs):
        if not r.ok:
            segs.append((start, k + 1))
            start = k + 1
    segs.append((start, len(files)))
    s, e = max(segs, key=lambda t: t[1] - t[0])
    gray = np.asarray(gray_all[s:e])
    subpix = [recs[k].offset_subpix for k in range(s, e - 1)]
    conf = [max(recs[k].confidence, 1e-3) for k in range(s, e - 1)]

    chain_pos = pg.chain_positions(subpix)
    cands = loop_closure.propose_edges(chain_pos, gray.shape[1:])
    ia, ib, meas, wgt = loop_closure.verify_edges(gray, chain_pos, cands,
                                                  device=dev)

    graph = pg.PoseGraph.from_chain(subpix, conf)
    chain_med = float(np.median(graph.weights))
    wn = wgt / max(float(np.median(wgt)), 1e-6) * chain_med
    graph2 = graph.with_extra_edges(ia, ib, meas, wn)
    solved = pg.solve(graph2, iters=4 * graph2.n_nodes, device=dev)

    rc = _residuals(chain_pos, ia, ib, meas)
    rs = _residuals(solved, ia, ib, meas)
    return DriftReport(
        name=name, n_tiles=gray.shape[0], n_loop_edges=int(len(ia)),
        chain_mean_residual_px=float(rc.mean()),
        chain_max_residual_px=float(rc.max()),
        solved_mean_residual_px=float(rs.mean()),
        solved_max_residual_px=float(rs.max()))


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--demo-root", required=True,
                   help="directory of <dataset>/1/*.jpg sequences")
    p.add_argument("--name", default="dendriticCrystal")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    rep = run(args.demo_root, args.name, device=args.device)
    txt = json.dumps(dataclasses.asdict(rep), indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    print(txt)


if __name__ == "__main__":
    main()
