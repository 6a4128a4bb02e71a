#!/usr/bin/env python3
"""Where the device time of the PyTorch port's score-map pool goes, on one
GPU.

    PYTHONPATH=<checkout> python3 tools/torch_pool_split.py <label>

Prints one JSON line for the ``imagestitch_tpu_torch`` found on
PYTHONPATH, on the smoke's 1936x2584 serpentine (utils/synthetic, seed 7;
frames made once and kept in result/ab_frames.npy, git-ignored):
  * ``k4_ms``: K4 on frame 0's four octaves, as the pool calls it (one call
    over the atlas's bands where the checkout has ``doh_score_map_octaves``,
    else one full map per octave), CUDA events with the host run ahead;
    ``k4_full_map_ms``: the full-map ``doh_score_map`` per octave;
  * ``ordering_ms``: the per-octave top-k at the pool's budgets after K4
    (the survivors' ordering, or the stable sort of each full score map);
  * ``pool``: ``pool_features`` of the 10 frames through the oriented
    score-map pool (path (b)'s pool, 6,144 slots): the host wall (median
    and min of 7, ending in a synchronize) and, from one torch.profiler
    run, the device ms, the card's busy share of the median wall and the
    device ms a frame split into K4, ordering (the per-octave top-k),
    refine, global top-k, describe and the rest;
  * ``pool_no_ahead``: the same without launching frame i + 1's K4 before
    frame i's survivor counts are read (the checkout's ``score_map_pool``
    frame by frame); its walls are taken in turns with ``pool``'s.
Compare two checkouts inside one call, in turns: parent, change, change,
parent.
"""
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

LABELS = ("k4", "ordering", "refine", "global_topk", "describe")


def cuda_ms(fn, iters=20):
    """Mean device ms of ``fn``: the stream sleeps while the host enqueues."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def walls_ms(fns, n):
    """{name: (median, min)} host ms of each ``fns[name]()`` ending in a
    synchronize: two warm-up calls each, then ``n`` rounds that call them
    in turn, so that drift of the host hits them alike."""
    for fn in fns.values():
        fn()
        fn()
    times = {k: [] for k in fns}
    for _ in range(n):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: (statistics.median(v), min(v)) for k, v in times.items()}


@contextlib.contextmanager
def stage_ranges(octave_sizes=()):
    """Wrap the score-map pool's stages in profiler ranges named "split:"
    + a label of LABELS, for the checkout on the path; restored on exit.
    ``octave_sizes``: the octaves' pixel counts, which tell a checkout
    without ``doh_score_map_octaves`` its per-octave sorts from the global
    one."""
    from imagestitch_tpu_torch.core import feature_registration as freg
    from imagestitch_tpu_torch.ops.features import describe, detect
    from imagestitch_tpu_torch.ops.kernels import doh as kdoh
    if hasattr(kdoh, "doh_score_map_octaves"):
        stages = [(kdoh, "top_k_from_survivors", lambda *a: "ordering"),
                  (kdoh, "_top_k_stable", lambda *a: "global_topk"),
                  (describe, "describe_from_atlas", lambda *a: "describe")]
    else:
        stages = [(freg, "_top_k_stable", lambda x, k: (
                      "ordering" if x.numel() in octave_sizes
                      else "global_topk")),
                  (describe, "describe_from_pyramid",
                   lambda *a: "describe")]
    stages.append((detect, "refine_subpixel", lambda *a: "refine"))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in stages]

    def ranged(fn, label_of):
        def wrapped(*args, **kw):
            with torch.profiler.record_function("split:" + label_of(*args)):
                return fn(*args, **kw)
        return wrapped
    try:
        for (mod, name, label_of), (_, _, fn) in zip(stages, saved):
            setattr(mod, name, ranged(fn, label_of))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def device_split(fn, n_frames, octave_sizes=()):
    """One profiled run of ``fn`` (the pool over ``n_frames`` frames):
    (device ms, device ms per frame by stage, "rest" what no stage range
    holds).  The profiler slows the host, so a busy share divides the
    device ms by an unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with stage_ranges(octave_sizes), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not e.name.startswith("split:")]
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    split = dict.fromkeys(LABELS, 0.0)
    for e in events:
        if e.name.startswith("split:") and e.device_type.name == "CPU":
            split[e.name[6:]] += e.device_time_total / 1e3
    # a kernel launched through ctypes sits in no range: K4 by its name
    split["k4"] += sum(e.time_range.elapsed_us() for e in kernels
                       if "doh_score_map_kernel" in e.name) / 1e3
    split["rest"] = device - sum(split.values())
    return device, {k: v / n_frames for k, v in split.items()}


def main():
    from imagestitch_tpu_torch import FeatureConfig, StitchConfig
    from imagestitch_tpu_torch.core import feature_registration as freg
    from imagestitch_tpu_torch.ops.features import detect
    from imagestitch_tpu_torch.ops.kernels import doh as kdoh
    from imagestitch_tpu_torch.utils import synthetic

    dev = torch.device("cuda", 0)
    path = os.path.join("result", "ab_frames.npy")
    if os.path.exists(path):
        frames = np.load(path)
    else:
        pos = synthetic.serpentine_positions(5, 2, (1790.37, 2450.21))
        seq, _ = synthetic.sequence(7, (1936, 2584), pos)
        other, _ = synthetic.sequence(99, (1936, 2584), [(0.5, 0.5)])
        frames = np.concatenate([seq, other])
        os.makedirs("result", exist_ok=True)
        np.save(path, frames)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"label": sys.argv[1], "card": smi}

    cfg = StitchConfig(features=FeatureConfig(auto_upright=False))
    dparams = freg._detect_params(cfg)
    sparams = freg._describe_params(cfg)
    max_kp = cfg.features.pool_keypoints
    spacing = 2.0 ** (1.0 / dparams.n_octave_layers)
    taps = dict(threshold=dparams.threshold,
                n_scales=dparams.n_octave_layers,
                base_sigma=dparams.base_sigma, spacing=spacing)
    gray = torch.as_tensor(frames[:10], device=dev)
    octs = freg.octaves(gray[0], dparams)
    kks = [min(detect.octave_budget(max_kp, o, dparams.octave_topk_decay),
               xo.numel()) for o, xo, _ in octs]
    full_maps = lambda: [kdoh.doh_score_map(xo, border=bo, **taps)
                         for _, xo, bo in octs]
    out["k4_full_map_ms"] = cuda_ms(full_maps)
    one_call = hasattr(kdoh, "doh_score_map_octaves")
    if one_call:
        _, atlas, bands = freg.octave_atlas(gray[0], dparams)
        launch = lambda: kdoh._launch_score_map(
            atlas, bands, full_map=False, **taps)
        out["k4_ms"] = cuda_ms(launch)
        _, _, keys, counts = launch()
        *ns, total = counts.tolist()
        out["survivors"] = ns
        out["ordering_ms"] = cuda_ms(lambda: kdoh.top_k_from_survivors(
            keys[:total], ns, [b[1] * b[2] for b in bands], kks))
    else:
        out["k4_ms"] = out["k4_full_map_ms"]
        maps = full_maps()
        out["survivors"] = [int((s > 0).sum()) for s, _ in maps]
        out["ordering_ms"] = cuda_ms(lambda: [
            freg._top_k_stable(s.reshape(-1), kk)
            for (s, _), kk in zip(maps, kks)])

    # the pool, its stages in named profiler ranges
    sizes = {xo.numel() for _, xo, _ in octs}
    pool = lambda: freg.pool_features(gray, dparams, sparams,
                                      max_pool=max_kp)
    frame_by_frame = lambda: [freg.score_map_pool(gray[i], max_kp, dparams,
                                                  sparams)
                              for i in range(gray.shape[0])]
    fns = {"pool": pool, "pool_no_ahead": frame_by_frame}
    for key, (med, low) in walls_ms(fns, 7).items():
        device, split = device_split(fns[key], gray.shape[0], sizes)
        out[key] = dict(wall_ms_median=med, wall_ms_min=low,
                        device_ms=device, busy_share=device / med,
                        device_ms_per_frame=split)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
