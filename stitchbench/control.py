"""The readings that set each cell's limits: the program's, and the
control's.

    python3 -m stitchbench.control --workload <cell> --seeds 1,2,3 \
        [--projects 1] [--out FILE]

In one process, for each seed: the cell's set-up, its warm-up project, a
short window of ``--projects`` projects through the timed entry, and the
numbers the run would compare (the lower readings).  Then the control:
the plain reference put in the program's place and computed in bfloat16,
the precision below the float32 the configurations state (the true
offsets rounded to bfloat16 before they are truncated, the gray taken in
bfloat16, the configuration's fuse blended in bfloat16 on its color or gray
frames), judged by the same comparison (the upper readings).  One JSON
line a seed, then the largest program reading and the smallest control
reading of each number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from stitchbench import judge, manifest, reference
from stitchbench.run import Cell


def control_numbers(cell: Cell, decoded: np.ndarray) -> Dict[str, float]:
    """The comparison's numbers for the bfloat16 reference in the
    program's place; ``decoded``: ``cell.decoded()``."""
    p = cell.project
    color = cell.cfg.color_mode
    ok = reference.pair_overlaps(p.truth, p.frame_hw)
    offs = reference.expected_offsets(p.truth, "bfloat16")
    segs = reference.segments_from_decisions(ok, offs)
    seen = judge.configured_frames(decoded, color, cell.device, "bfloat16")
    images = [reference.compose(seen[s:e], o, dtype="bfloat16",
                                device=cell.device, fuse=cell.fuse)
              for (s, e), o in segs]
    frames = judge.configured_frames(decoded, color, cell.device)
    out = {"offset_err_px": judge.offset_error(segs, p.truth, p.frame_hw),
           "pano_diff_max": judge.pano_difference(segs, images, frames,
                                                  cell.device, cell.fuse)}
    if p.files is not None:
        gray = reference.gray(torch.from_numpy(decoded).to(cell.device),
                              "bfloat16")
        out["ingest_diff_max"] = judge.ingest_difference(
            decoded, decoded if color else None, gray, cell.device,
            color=color)
    return out


def readings(workload: str, seeds: List[int], projects: int = 1,
             device: str = "cuda", bench=None, traffic=None, limits=None,
             emit=print) -> Dict[str, Dict[str, float]]:
    """Per seed, the program's and the control's numbers; returns the
    largest program reading and the smallest control reading of each."""
    bench = bench or manifest.Manifest()
    lower: Dict[str, float] = {}
    upper: Dict[str, float] = {}
    for seed in seeds:
        t0 = time.perf_counter()
        cell = Cell(bench, workload, seed, device, traffic, limits)
        try:
            cell.entry()
            _, _, recs, sampled = cell.window(0.0, np.random.default_rng(0))
            for _ in range(projects - 1):
                more = cell.window(0.0, np.random.default_rng(0))
                recs += more[2]
            prog, _ = cell.judge(recs, sampled)
            del sampled
            cell.stitcher = cell.entry = cell.batch = None
            ctrl = control_numbers(cell, cell.decoded())
        finally:
            cell.close()
        for k, v in prog.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in ctrl.items():
            upper[k] = min(upper.get(k, v), v)
        emit(json.dumps({"workload": workload, "seed": seed,
                         "program": prog, "control": ctrl,
                         "seconds": time.perf_counter() - t0}))
    return {"lower": lower, "upper": upper}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--projects", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)

    seeds = [int(s) for s in args.seeds.split(",")]
    summary = readings(args.workload, seeds, args.projects, emit=emit)
    emit(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
