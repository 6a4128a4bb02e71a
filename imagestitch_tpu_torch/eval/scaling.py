"""Throughput of the data-parallel registration step against mesh size.

Port of ``imagestitch_tpu/eval/scaling.py`` (:52-165): frames per second
of one registration sweep at each mesh size, mode ``phase`` (pair-sharded
strip phase correlation) or ``feature`` (the frame-sharded feature step
with its one-frame halo), and the efficiency against one shard.  The
fields the JAX package takes from its ICI model and compiled HLO
(eval/ici_model.py, utils/hlo.py: ROADMAP's do-not-port list) are left
out; each point's ``collectives`` is the port's count of one step's
collectives (``parallel.mesh.COLLECTIVES``).  Meshes are the first cards
unless ``devices`` names the shards; shards that share one device check
the code path, and their efficiency is no scaling measurement.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh as mesh_mod
from ..parallel import pipeline
from ..utils.profiling import block_until_ready


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    frames_per_s: float
    efficiency_vs_1: float
    collectives: Optional[Dict[str, int]] = None   # one step's, counted
    dispatches_per_step: int = 1


@dataclasses.dataclass
class ScalingReport:
    backend: str
    mode: str
    n_frames: int
    image_shape: List[int]
    points: List[ScalingPoint]
    host_cores: Optional[int] = None
    note: str = ""


def run(images: Optional[np.ndarray] = None, device_counts=None,
        direction: int = 1, ratio: float = 0.25, repeats: int = 3,
        mode: str = "phase", devices: Optional[Sequence] = None
        ) -> ScalingReport:
    """Best of ``repeats`` warm walls of one sweep at each mesh size in
    ``device_counts`` (default 1, 2, 4, ... up to the cards, or to
    ``len(devices)``); each mesh is the first d cards, or of ``devices``."""
    cfg = None
    if images is None:
        rng = np.random.default_rng(0)
        if mode == "feature":
            base = rng.integers(0, 255, (48 * 17 + 256, 384), np.uint8)
            images = np.stack([base[48 * i:48 * i + 256] for i in range(17)])
            # the synthetic validation sweep's small keypoint pool (JAX
            # :77-83); frames passed in keep the production FeatureConfig
            from ..config import FeatureConfig, StitchConfig
            cfg = StitchConfig(features=FeatureConfig(
                pool_keypoints=512, max_keypoints=256))
        else:
            base = rng.integers(0, 255, (80 * 33 + 512, 768), np.uint8)
            images = np.stack([base[80 * i:80 * i + 512] for i in range(33)])
    n = images.shape[0]
    avail = len(devices) if devices is not None else \
        torch.cuda.device_count()
    device_counts = device_counts or [d for d in (1, 2, 4, 8, 16, 32)
                                      if d <= avail]
    points: List[ScalingPoint] = []
    fps1 = None
    meshes = [mesh_mod.make_mesh(d, axis="pairs", devices=devices)
              for d in device_counts]
    for mesh in meshes:
        if mode == "feature":
            def step():
                return pipeline.register_pairs_sharded_features(
                    images, mesh, cfg=cfg, direction=direction, ratio=ratio)
        else:
            a, b, _ = pipeline.make_pair_tensors(images, mesh)

            def step():
                return block_until_ready(pipeline.register_pairs_sharded(
                    a, b, direction, ratio, mesh))

        step()                                           # warm-up
        before = dict(mesh_mod.COLLECTIVES)
        step()
        colls = {k: mesh_mod.COLLECTIVES[k] - v for k, v in before.items()}
        colls["total"] = sum(colls[k] for k in
                             ("psum", "ppermute", "all_gather"))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            step()
            best = min(best, time.perf_counter() - t0)
        fps = n / best
        fps1 = fps1 or fps
        points.append(ScalingPoint(
            n_devices=mesh.size, frames_per_s=round(fps, 2),
            efficiency_vs_1=round(fps / (fps1 * mesh.size), 3),
            collectives=colls))
    dev0 = meshes[0].devices[0]
    shared = devices is not None and len(set(
        torch.device(d) for d in devices)) < max(device_counts)
    note = ("shards share a device: the walls check the code path, not "
            "scaling" if shared else "")
    return ScalingReport(backend=dev0.type, mode=mode, n_frames=n,
                         image_shape=list(images.shape[1:]), points=points,
                         host_cores=os.cpu_count(), note=note)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--mode", default="phase", choices=["phase", "feature"])
    p.add_argument("--devices", type=int, nargs="*",
                   help="mesh sizes (default 1, 2, 4, ... up to the cards)")
    p.add_argument("--device", default="cuda",
                   help="cuda: meshes of the first cards; cpu: of CPU "
                        "shards")
    p.add_argument("--out")
    args = p.parse_args(argv)
    shards = None if args.device == "cuda" else \
        [args.device] * max(args.devices or [1])
    rep = run(mode=args.mode, device_counts=args.devices, devices=shards)
    txt = json.dumps(dataclasses.asdict(rep))
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    print(txt)


if __name__ == "__main__":
    main()
