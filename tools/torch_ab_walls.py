#!/usr/bin/env python3
"""Warm walls of the PyTorch port's smoke paths (b), (m) and (n) on one GPU,
for an A/B of two checkouts.

    PYTHONPATH=<checkout> python3 tools/torch_ab_walls.py <label>

Prints one JSON line for the ``imagestitch_tpu_torch`` found on
PYTHONPATH: ``Stitcher.stitch_batch`` on the smoke's 1936x2584 serpentine
(utils/synthetic, seeds 7 and 99; frames made once and kept in
result/ab_frames.npy, git-ignored), gray, one warm-up, then the host wall
of 5 runs (median, min and max, each ending after its readback) of
  * (b) ``feature_incre``, ``auto_upright=False`` (10 frames: the oriented
    score-map pool);
  * (m) ``feature_incre``, ``use_pallas=False`` (11 frames: the XLA
    detector's pool, oriented for pair 9);
  * (n) ``feature_incre``, ``strict_roi_detect``, CLAHE,
    ``ransac_translation`` (7 frames: each strip enhanced and detected by
    the XLA detector, oriented descriptors).
Compare two checkouts inside one call, in turns: parent, change, change,
parent.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def main():
    from imagestitch_tpu_torch import (EnhanceConfig, FeatureConfig,
                                       StitchConfig, Stitcher)
    from imagestitch_tpu_torch.io.dataset import ImageBatch
    from imagestitch_tpu_torch.utils import synthetic

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
    base = StitchConfig(registration="feature_incre", direction=1,
                        direct_incre=1, roi_ratio=0.2, color_mode=False)
    paths = {
        "b": (base.replace(features=FeatureConfig(auto_upright=False)), 10),
        "m": (base.replace(use_pallas=False, features=FeatureConfig()), 11),
        "n": (base.replace(offset_calculate="ransac_translation",
                           enhance=EnhanceConfig(enabled=True,
                                                 use_clahe=True),
                           features=FeatureConfig(strict_roi_detect=True)),
              7),
    }
    out = {"label": sys.argv[1], "card": smi}
    dev = torch.device("cuda", 0)
    for name, (cfg, n) in paths.items():
        batch = ImageBatch(gray=frames[:n], color=None,
                           files=[f"frame-{i}" for i in range(n)])
        Stitcher(cfg, device=dev).stitch_batch(batch)          # warm-up
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Stitcher(cfg, device=dev).stitch_batch(batch)
            walls.append(time.perf_counter() - t0)
        out[name] = {"median_s": statistics.median(walls),
                     "min_s": min(walls), "max_s": max(walls)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
