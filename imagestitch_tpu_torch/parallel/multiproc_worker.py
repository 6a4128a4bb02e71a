"""One process of an N-process bring-up of the multi-process runtime.

Port of ``scripts/multiproc_worker.py``: ``distributed.initialize`` across
processes, a host-sharded "decode" (each process makes only its pairs'
frames), ``make_global_batch`` onto the process's local mesh, one phase
registration step on every local shard, a reduction across processes, and
the record gather; the process writes its records to ``proc<id>.json``
for the caller to compare across processes and against a one-process run.

    python -m imagestitch_tpu_torch.parallel.multiproc_worker \\
        <init_method> <num_processes> <process_id> <out_dir> \\
        [--device cpu] [--shards S]

``init_method``: ``tcp://host:port`` or ``file://path``, shared by every
process.  ``--device cpu --shards S``: S CPU shards a process, over gloo;
the default is one card a process, over NCCL.  The run registers one pair
a shard across all processes.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch


def make_frames(lo: int, hi: int, n: int, h: int = 96, w: int = 128,
                step: int = 40, seed: int = 11) -> Dict[int, np.ndarray]:
    """Frames [lo, hi) of a seeded textured strip sequence (true offset
    between neighbours (step, 0)).  Each process makes only its own: the
    stand-in for a per-process decode."""
    rng = np.random.default_rng(seed)
    base = np.zeros((step * n + h, w), np.float32)
    ys = rng.integers(3, base.shape[0] - 3, 2500)
    xs = rng.integers(3, w - 3, 2500)
    for y, x, a in zip(ys, xs, rng.uniform(60, 200, 2500)):
        base[y - 2:y + 3, x - 2:x + 3] += a
    base = np.clip(base, 0, 255).astype(np.uint8)
    return {i: base[step * i:step * i + h] for i in range(lo, hi)}


def run(ctx, n_pairs: int) -> dict:
    """This process's part of an ``n_pairs`` registration over ``ctx``:
    its pairs, the gathered (n_pairs, 3) records (shift_x, shift_y,
    response) and the mean response reduced across processes."""
    from ..ops import phase_corr
    from . import distributed as dist_rt
    from .mesh import all_gather

    my_pairs = dist_rt.host_shard(list(range(n_pairs)), ctx, overlap=0)
    frames = make_frames(my_pairs[0], my_pairs[-1] + 2, n_pairs + 1)
    a_loc = np.stack([frames[k] for k in my_pairs]).astype(np.float32)
    b_loc = np.stack([frames[k + 1] for k in my_pairs]).astype(np.float32)
    ga = dist_rt.make_global_batch(a_loc, ctx)
    gb = dist_rt.make_global_batch(b_loc, ctx)
    h, w = a_loc.shape[1:]
    hp, wp = phase_corr.optimal_dft_size(h), phase_corr.optimal_dft_size(w)
    outs = [torch.stack(phase_corr._phase_correlate_one(x, y, hp, wp))
            for x, y in zip(ga, gb)]
    rec_local = all_gather(outs, ctx.mesh, dim=1).T     # (local pairs, 3)
    # a reduction spanning every process: the mean response
    tot = torch.stack([rec_local[:, 2].sum().double(),
                       torch.tensor(float(len(my_pairs)), dtype=torch.float64,
                                    device=rec_local.device)])
    if ctx.process_count > 1:
        import torch.distributed as dist
        dist.all_reduce(tot)
    records = dist_rt.all_gather_records(rec_local.cpu().numpy(), ctx)
    return {"pid": ctx.process_index, "process_count": ctx.process_count,
            "local_shards": ctx.mesh.size, "my_pairs": my_pairs,
            "mean_resp": float(tot[0] / tot[1]), "records": records.tolist()}


def main(argv=None) -> None:
    from . import distributed as dist_rt
    p = argparse.ArgumentParser()
    p.add_argument("init_method")
    p.add_argument("num_processes", type=int)
    p.add_argument("process_id", type=int)
    p.add_argument("out_dir")
    p.add_argument("--device", default="cuda")
    p.add_argument("--shards", type=int, default=1)
    args = p.parse_args(argv)
    devices = None if args.device == "cuda" else [args.device] * args.shards
    ctx = dist_rt.initialize(args.init_method, args.num_processes,
                             args.process_id, devices=devices)
    try:
        if ctx.process_count != args.num_processes:
            raise RuntimeError(f"{ctx.process_count} processes joined, "
                               f"want {args.num_processes}")
        out = run(ctx, args.num_processes * ctx.mesh.size)
    finally:
        dist_rt.shutdown()
    with open(os.path.join(args.out_dir, f"proc{args.process_id}.json"),
              "w") as f:
        json.dump(out, f)
    print(f"proc{args.process_id} ok: pairs={out['my_pairs']} "
          f"mean_resp={out['mean_resp']:.4f}", flush=True)


if __name__ == "__main__":
    main()
