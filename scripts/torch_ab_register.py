#!/usr/bin/env python3
"""A/B of the PyTorch port's fused-pool registration on one GPU.

    PYTHONPATH=<checkout> python3 scripts/torch_ab_register.py <label>

Prints one JSON line for the ``imagestitch_tpu_torch`` found on
PYTHONPATH: the device times of K1 (the pool's calls for one 1936x2584
frame's four octaves), K4 (the four octaves) and K2 (the frame's 11,616
candidates), CUDA events with the host run ahead; then, on the smoke's
11-frame serpentine (utils/synthetic, seeds 7 and 99), the host wall of
``register_sequence_features_incre`` (median and min of 7) and the
device time of its kernels (torch.profiler, one run), and the warm wall
of ``Stitcher.stitch_batch`` for path (a) (median and min of 5).  Compare
two checkouts inside one call, in turns: parent, change, change, parent.
The frames are made once and kept in result/ab_frames.npy (git-ignored).
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


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


def wall_ms(fn, n):
    """(median, min) host ms of ``fn`` ending in a synchronize, after two
    warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times)


def main():
    from imagestitch_tpu_torch import FeatureConfig, StitchConfig, Stitcher
    from imagestitch_tpu_torch.core import feature_registration as freg
    from imagestitch_tpu_torch.io.dataset import ImageBatch
    from imagestitch_tpu_torch.ops.kernels import describe as kdesc
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

    cfg = StitchConfig(registration="feature_incre", direction=1,
                       direct_incre=1, roi_ratio=0.2, color_mode=False,
                       fuse_method="fadeInAndFadeOut",
                       features=FeatureConfig())
    dparams = freg._detect_params(cfg.replace(
        features=FeatureConfig(upright=True)))
    taps = dict(threshold=dparams.threshold,
                n_scales=dparams.n_octave_layers,
                base_sigma=dparams.base_sigma,
                spacing=2.0 ** (1.0 / dparams.n_octave_layers))
    gray = torch.as_tensor(frames, device=dev)
    octs = freg.octaves(gray[0], dparams)
    if hasattr(kdoh, "doh_select_octaves"):
        _, atlas, bands = freg.octave_atlas(gray[0], dparams)
        k1 = lambda: kdoh.doh_select_octaves(atlas, bands, **taps)
    else:                                       # one launch per octave
        k1 = lambda: [kdoh.doh_select(
            xo, r_cands=freg._ROW_CANDS[min(o, 3)], border=bo, **taps)
            for o, xo, bo in octs]
    out["k1_ms"] = cuda_ms(k1)
    out["k4_ms"] = cuda_ms(lambda: [kdoh.doh_score_map(xo, border=bo, **taps)
                                    for _, xo, bo in octs])
    _, _, _, atl, r0, c0 = freg.select_candidates(gray[0], dparams)
    out["k2_ms"] = cuda_ms(lambda: kdesc.describe_atlas(atl, r0, c0))

    register = lambda: freg.register_sequence_features_incre(gray, cfg,
                                                             device=dev)
    out["register_wall_ms"] = wall_ms(register, 7)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        register()
        torch.cuda.synchronize()
    out["register_device_ms"] = sum(
        getattr(e, "self_device_time_total", 0) or 0
        for e in prof.key_averages()) / 1e3
    batch = ImageBatch(gray=frames, color=None,
                       files=[f"frame-{i}" for i in range(len(frames))])
    out["stitch_batch_a_wall_ms"] = wall_ms(
        lambda: Stitcher(cfg, device=dev).stitch_batch(batch), 5)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
