"""Composition throughput: one device against the sharded canvas.

Port of ``imagestitch_tpu/eval/compose_bench.py`` (:65-125): frames per
second of ``core/compose.compose`` on the mesh's first device and of
``parallel/compose_sharded.compose_sharded`` over the mesh, with the
sharded canvas's dispatches, fused-rect psums and their payload.  The
fields the JAX package takes from its ICI model (eval/ici_model.py, on
ROADMAP's do-not-port list) are left out; ``collectives`` holds the
port's count of one sharded panorama's collectives in their place.
Shards that share one device (``devices=["cuda:0"] * 4``) check the code
path; their walls are no scaling measurement.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import StitchConfig
from ..core.compose import compose, compute_placement
from ..parallel import compose_sharded as cs
from ..parallel import mesh as mesh_mod
from ..utils.profiling import block_until_ready


@dataclasses.dataclass
class ComposeBench:
    backend: str
    n_frames: int
    image_shape: List[int]
    canvas_shape: List[int]
    fuse_method: str
    single_fps: float
    sharded_fps: float
    n_devices: int
    sharded_dispatches: int = 0     # steps of one sharded panorama
    sharded_fuse_psums: int = 0     # one psum a fused image
    host_cores: int = 0
    note: str = ""
    psum_payload_bytes: int = 0
    modeled_ici_bytes_per_device: int = 0
    collectives: Optional[Dict[str, int]] = None


def _serpentine(rng, n_rows=4, n_cols=6, h=256, w=320):
    """Dendritic-shaped synthetic: serpentine grid with ~93% row overlap."""
    rstep, cstep = int(h * 0.7), int(w * 0.93)
    base = rng.integers(0, 255, (rstep * n_rows + h, cstep * n_cols + w),
                        np.uint8)
    pos = []
    for r in range(n_rows):
        cs_ = range(n_cols) if r % 2 == 0 else range(n_cols - 1, -1, -1)
        pos += [(r * rstep, c * cstep) for c in cs_]
    tiles = np.stack([base[r:r + h, c:c + w] for r, c in pos])
    offsets = [(pos[i + 1][0] - pos[i][0], pos[i + 1][1] - pos[i][1])
               for i in range(len(pos) - 1)]
    return tiles, offsets


def _time(f) -> float:
    t0 = time.perf_counter()
    f()
    return time.perf_counter() - t0


def run(images: Optional[np.ndarray] = None, offsets=None,
        n_devices: Optional[int] = None,
        fuse_method: str = "fadeInAndFadeOut", repeats: int = 3,
        devices: Optional[Sequence] = None) -> ComposeBench:
    """Best of ``repeats`` warm walls of each composer (each ends when its
    panorama is complete on the device).  The mesh: the first
    ``n_devices`` cards (default every card), or of ``devices``."""
    if images is None:
        images, offsets = _serpentine(np.random.default_rng(0))
    n = images.shape[0]
    cfg = StitchConfig(color_mode=False, fuse_method=fuse_method,
                       registration="phase_incre")
    mesh = mesh_mod.make_mesh(n_devices, axis="blocks", devices=devices)
    dev0 = mesh.devices[0]

    def t_single():
        block_until_ready(compose(images, offsets, cfg, return_device=True,
                                  device=dev0))

    def t_sharded():
        block_until_ready(cs.compose_sharded(images, offsets, cfg, mesh,
                                             return_device=True))

    t_single()
    before = dict(mesh_mod.COLLECTIVES)
    t_sharded()
    colls = {k: mesh_mod.COLLECTIVES[k] - v for k, v in before.items()}
    bs = min(_time(t_single) for _ in range(repeats))
    bh = min(_time(t_sharded) for _ in range(repeats))
    stats = cs.LAST_COMPOSE_STATS
    rows, cols = compute_placement(offsets, images.shape[1:3]).canvas_shape
    cores = os.cpu_count() or 0
    shared = len(set(mesh.devices)) < mesh.size
    note = (f"{mesh.size} shards on {len(set(mesh.devices))} device(s): "
            f"the sharded wall checks the code path, not scaling"
            if shared else "")
    return ComposeBench(
        backend=dev0.type, n_frames=n, image_shape=list(images.shape[1:]),
        canvas_shape=[rows, cols], fuse_method=fuse_method,
        single_fps=round(n / bs, 2), sharded_fps=round(n / bh, 2),
        n_devices=mesh.size,
        sharded_dispatches=int(stats.get("dispatches", 0)),
        sharded_fuse_psums=int(stats.get("fuse_psums", 0)),
        host_cores=cores, note=note,
        psum_payload_bytes=int(stats.get("psum_payload_bytes", 0)),
        modeled_ici_bytes_per_device=int(
            stats.get("modeled_ici_bytes_per_device", 0)),
        collectives=colls)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int,
                   help="mesh size (default: every card)")
    p.add_argument("--device", default="cuda",
                   help="cuda: the first --devices cards; cpu: --devices "
                        "CPU shards")
    p.add_argument("--out")
    args = p.parse_args(argv)
    shards = None if args.device == "cuda" else \
        [args.device] * (args.devices or 1)
    rep = run(n_devices=args.devices, devices=shards)
    txt = json.dumps(dataclasses.asdict(rep))
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    print(txt)


if __name__ == "__main__":
    main()
