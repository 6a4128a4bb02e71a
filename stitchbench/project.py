"""One traffic mix made into one project: positions, truth and frames.

A traffic file (``cells/<traffic>.json``) holds only parameters: the frame
size, the scan geometry, the texture, the color planes and how the frames
arrive (decoded arrays, or JPEG files written in set-up).  ``build`` is the
one generator that reads them.  Every seed gets the same set of steps; the
seed draws the texture, each step's sub-pixel fraction and, for a
``line``, the order of the steps.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from . import synth


@dataclasses.dataclass
class Project:
    """The inputs of one project and its ground truth.

    positions: (N, 2) float64 top-left (row, col) of each frame in the scene.
    truth: (N - 1, 2) float64 pairwise offsets, position[k + 1] - position[k].
    color: (N, H, W, 3) uint8 BGR host frames.
    files: the JPEG files, in order, when the traffic arrives as files.
    """
    positions: np.ndarray
    truth: np.ndarray
    color: np.ndarray
    files: Optional[List[str]] = None

    @property
    def num_frames(self) -> int:
        return self.color.shape[0]

    @property
    def frame_hw(self):
        return tuple(self.color.shape[1:3])


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def positions(traffic: Dict, seed: int) -> np.ndarray:
    """Frame positions of the traffic's geometry.

    ``chain``: ``steps`` are the integer pairwise offsets in capture order;
    each gets a fraction drawn from ``fraction`` on both axes, and the frames
    listed in ``drop`` are then left out (a missing file).  ``line``: the
    ``rows`` and ``cols`` step lists are each put in a seeded order and
    paired, each with a drawn fraction.  The scene's origin is shifted so
    that every position is at least ``margin``."""
    geo = traffic["geometry"]
    rng = host_rng(seed, 1)
    lo, hi = traffic["fraction"]
    if geo["kind"] == "chain":
        steps = np.asarray(geo["steps"], np.float64)
    elif geo["kind"] == "line":
        rows = np.asarray(geo["rows"], np.float64)[rng.permutation(
            len(geo["rows"]))]
        cols = np.asarray(geo["cols"], np.float64)[rng.permutation(
            len(geo["cols"]))]
        steps = np.stack([rows, cols], axis=1)
    else:
        raise ValueError(f"unknown geometry kind {geo['kind']!r}")
    frac = rng.uniform(lo, hi, steps.shape)
    pos = np.concatenate([np.zeros((1, 2)), np.cumsum(steps + frac, axis=0)])
    keep = [i for i in range(len(pos)) if i not in set(geo.get("drop", []))]
    pos = pos[keep]
    return pos - pos.min(axis=0) + float(traffic["margin"])


def build(traffic: Dict, seed: int, device: torch.device,
          file_dir: Optional[str] = None) -> Project:
    """Make the traffic's project on ``device`` from ``seed``; frames come
    back to the host.  With ``arrival == "jpeg"`` they are also written to
    ``file_dir`` (emptied first) at ``jpeg_quality``."""
    h, w = traffic["frame_hw"]
    pos = positions(traffic, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    sh = int(np.ceil(pos[:, 0].max())) + h + 2
    sw = int(np.ceil(pos[:, 1].max())) + w + 2
    tex = traffic["texture"]
    base = synth.make_texture(gen, sh, sw, tex)
    planes = synth.color_planes(gen, base, traffic["channels"],
                                tex["noise"])
    del base
    color = np.empty((len(pos), h, w, 3), np.uint8)
    for i, (r, c) in enumerate(pos):
        color[i] = torch.stack([synth.sample(p, r, c, h, w) for p in planes],
                               dim=-1).cpu().numpy()
    del planes
    proj = Project(positions=pos, truth=np.diff(pos, axis=0), color=color)
    if traffic["arrival"] == "jpeg":
        proj.files = write_jpegs(color, file_dir, traffic["jpeg_quality"])
    elif traffic["arrival"] != "arrays":
        raise ValueError(f"unknown arrival {traffic['arrival']!r}")
    return proj


def write_jpegs(color: np.ndarray, file_dir: str, quality: int) -> List[str]:
    """Encode each frame as ``<dir>/<k>.jpg`` (cv2, BGR) on a thread pool."""
    import cv2
    shutil.rmtree(file_dir, ignore_errors=True)
    os.makedirs(file_dir)
    files = [os.path.join(file_dir, f"{k + 1:03d}.jpg")
             for k in range(len(color))]

    def one(k):
        ok, buf = cv2.imencode(".jpg", color[k],
                               [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
        if not ok:
            raise IOError(f"JPEG encode failed for frame {k}")
        buf.tofile(files[k])

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(one, range(len(color))))
    return files
