#!/usr/bin/env python3
"""How far the port's RANSAC is from the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_ransac_parity.py

Prints one JSON line:
  * ``solves``: 4,096 exact-DLT 8x8 systems of 4 translated matches
    (coordinates in [0, 1000), 0.3 px jitter), solved by the port's
    ``ransac._solve`` and by ``jnp.linalg.solve``: the share of systems
    whose 8 values are not all bit-equal, and the share of values that
    differ; plus 64 systems of collinear samples, the share whose
    finiteness differs (a zero pivot gives non-finite values in both);
  * ``hypotheses``: the same 4-match samples scored against 600 matches of
    a 2584 x 260 strip (40% outliers): the share of hypotheses whose
    inlier count (error <= 9 px^2) differs between the two solves;
  * ``batch``: ``ransac_homography_batch`` of both packages on 6 x 64
    pairs of tests/test_torch_ransac.py's outlier-laden sets (128 slots):
    the pairs whose inlier counts differ, and by consensus size the pairs
    whose integer offsets differ and the largest float-offset gap.
Imports both packages, as the tests do; the port itself never imports jax.
"""
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from imagestitch_tpu.ops.features import ransac as jransac  # noqa: E402
from imagestitch_tpu_torch.ops.features import ransac as transac  # noqa: E402
from test_torch_ransac import _sets  # noqa: E402


def dlt(p, q):
    """(N, 4, 2) point pairs (x, y) -> the (N, 8, 8) systems and (N, 8)
    right-hand sides of ``_dlt_exact``."""
    px, py, qx, qy = p[..., 0], p[..., 1], q[..., 0], q[..., 1]
    z, o = np.zeros_like(px), np.ones_like(px)
    ru = np.stack([px, py, o, z, z, z, -qx * px, -qx * py], -1)
    rv = np.stack([z, z, z, px, py, o, -qy * px, -qy * py], -1)
    return (np.concatenate([ru, rv], -2).astype(np.float32),
            np.concatenate([qx, qy], -1).astype(np.float32))


def solve_both(a, b):
    ref = np.asarray(jnp.linalg.solve(jnp.asarray(a),
                                      jnp.asarray(b)[..., None])[..., 0])
    got = transac._solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    return got, ref


def counts(h, px, py, qx, qy):
    hh = torch.from_numpy(np.concatenate(
        [h, np.ones_like(h[:, :1])], -1).reshape(-1, 3, 3))
    t = lambda v: torch.from_numpy(v)[None]
    return transac._inliers(hh, t(px), t(py), t(qx), t(qy),
                            torch.ones((1, len(px)), dtype=torch.bool),
                            9.0).sum(-1).numpy()


def main():
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    n = 4096
    p = rng.uniform(0, 1000, (n, 4, 2)).astype(np.float32)
    q = (p + rng.uniform(-300, 300, (n, 1, 2))
         + rng.normal(0, 0.3, (n, 4, 2))).astype(np.float32)
    got, ref = solve_both(*dlt(p, q))
    pc = np.stack([np.linspace(0, 900, 4, dtype=np.float32)[None]
                   + rng.uniform(0, 5, (64, 4)).astype(np.float32),
                   np.full((64, 4), 7, np.float32)], -1)
    qc = (pc + np.array([-1.25, 3.5], np.float32)).astype(np.float32)
    cg, cr = solve_both(*dlt(pc, qc))
    solves = {"systems": n,
              "systems_not_bit_equal": float((got != ref).any(-1).mean()),
              "values_differing": float((got != ref).mean()),
              "collinear_systems": 64,
              "collinear_finiteness_differing": float(
                  (np.isfinite(cg).all(-1) != np.isfinite(cr).all(-1))
                  .mean())}

    m = 600
    px = rng.uniform(0, 2584, m).astype(np.float32)
    py = rng.uniform(0, 260, m).astype(np.float32)
    qx = (px + 0.21 + rng.normal(0, 0.3, m)).astype(np.float32)
    qy = (py - 1590.37 + rng.normal(0, 0.3, m)).astype(np.float32)
    out = rng.random(m) < 0.4
    qx[out] = rng.uniform(0, 2584, out.sum())
    qy[out] = rng.uniform(-1600, -1300, out.sum())
    sel = np.stack([rng.choice(m, 4, replace=False) for _ in range(n)])
    hg, hr = solve_both(*dlt(np.stack([px[sel], py[sel]], -1),
                             np.stack([qx[sel], qy[sel]], -1)))
    cnt_g, cnt_r = counts(hg, px, py, qx, qy), counts(hr, px, py, qx, qy)
    hyps = {"hypotheses": n,
            "counts_differing": float((cnt_g != cnt_r).mean()),
            "largest_count_gap": int(np.abs(cnt_g - cnt_r).max())}

    rows = []
    for seed in range(6):
        arrs = _sets(seed, 64, 128)
        r = [np.asarray(x) for x in jransac.ransac_homography_batch(*arrs)]
        g = [x.numpy() for x in transac.ransac_homography_batch(
            *[torch.from_numpy(a) for a in arrs])]
        for j in range(64):
            rows.append((int(r[2][j]), int(g[2][j]),
                         bool(g[0][j] != r[0][j] or g[1][j] != r[1][j]),
                         float(max(abs(g[4][j] - r[4][j]),
                                   abs(g[5][j] - r[5][j])))))
    batch = {"pairs": len(rows),
             "counts_differing": sum(a != b for a, b, _, _ in rows)}
    for lo, hi in ((0, 4), (4, 8), (8, 32), (32, 10 ** 6)):
        sel = [x for x in rows if lo <= x[0] < hi]
        batch[f"consensus_{lo}_{hi}"] = {
            "pairs": len(sel),
            "integer_offsets_differing": sum(x[2] for x in sel),
            "largest_float_gap_px": max((x[3] for x in sel), default=0.0)}
    print(json.dumps({"solves": solves, "hypotheses": hyps,
                      "batch": batch}))


if __name__ == "__main__":
    main()
