#!/usr/bin/env python3
"""Count the synchronizing CUDA calls of one project of benchmark cells.

    python3 tools/torch_sync_count.py <cell> [<cell> ...] [--seed N]

from the root of a checkout that holds ``imagestitch_tpu_torch``,
``stitchbench`` and ``BENCHMARK.json``; needs a CUDA card.  For each cell
it makes the project and the ``Stitcher`` as a benchmark run does,
stitches the project once to warm up, then once more under
``torch.cuda.set_sync_debug_mode("warn")``, and prints one JSON line: the
warnings raised (one a synchronizing call, on any thread) and how often
each distinct message came.  Compare two checkouts by running it from
each, in one call.
"""
import argparse
import collections
import json
import os
import sys
import warnings

# the checkout this script lies in, for ``stitchbench`` and the port
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def count(workload: str, seed: int) -> dict:
    import torch
    from stitchbench import manifest, run
    cell = run.Cell(manifest.Manifest(), workload, seed)
    try:
        cell.entry()                                   # warm-up project
        cell.sync()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                cell.entry()        # ends in the panoramas' readback
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        cell.close()
    msgs = [str(w.message).splitlines()[0] for w in caught
            if "synchroniz" in str(w.message)]
    return {"cell": workload, "seed": seed, "syncs": len(msgs),
            "by_message": collections.Counter(msgs).most_common()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, default=3_000_000_017)
    args = ap.parse_args(argv)
    for wl in args.cells:
        print(json.dumps(count(wl, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
