"""Sequence stitching orchestration.

Port of the single-device path of ``imagestitch_tpu/core/stitcher.py``:
``register`` (pooled incremental or whole-image feature search),
``stitch_batch`` (flowStitchWithMutiple semantics, reference
Stitcher.py:96-127: register every pair up front, split into segments at
failed pairs, compose each segment) and ``stitch_files`` with serial
decode.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import StitchConfig
from ..io import dataset
from ..utils.records import SequenceReport, print_and_write
from . import compose as compose_mod
from . import registration


@dataclasses.dataclass
class StitchResult:
    """One stitched segment + its provenance."""
    image: np.ndarray                      # uint8 panorama (or single image)
    file_range: Tuple[int, int]            # [start, end) indices into the file list
    offsets: List[Tuple[int, int]]         # pairwise offsets inside the segment
    report: Optional[SequenceReport] = None


def check_supported(cfg: StitchConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item that will port it,
    for a configuration outside the ported slice."""
    from .feature_registration import check_supported as check_registration
    todo = []
    if cfg.color_mode:
        todo.append("color_mode (ROADMAP Queue 1 item 9)")
    if cfg.stream_output:
        todo.append("stream_output (ROADMAP Queue 1 items 10 and 19)")
    if cfg.use_global_solver:
        todo.append("use_global_solver (ROADMAP Queue 1 item 20)")
    if cfg.fuse_method != "fadeInAndFadeOut":
        todo.append(f"fuse_method={cfg.fuse_method!r} (ROADMAP Queue 1 "
                    f"item 18)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))
    check_registration(cfg)


class Stitcher:
    """The engine facade for one configuration on one device.

    ``device``: where registration and composition run (a ``torch.device``
    or its name); None takes the device of the input tensors (the CPU for
    numpy input).  The search direction persists across calls (reference
    parity: Stitcher.direction is a class attribute, Stitcher.py:361).
    """

    def __init__(self, cfg: StitchConfig, device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("a device mesh is not ported yet "
                                      "(ROADMAP Queue 1 item 22)")
        check_supported(cfg)
        self.cfg = cfg
        self.device = None if device is None else torch.device(device)
        self._direction = cfg.direction

    def register(self, gray) -> List[registration.PairRegistration]:
        """Register all adjacent pairs of an (N, H, W) grayscale batch."""
        cfg = self.cfg.replace(direction=self._direction)
        if cfg.registration == "feature_incre":
            recs = registration.register_sequence_features_incre(
                gray, cfg, device=self.device)
        elif cfg.registration == "feature":
            recs = registration.register_sequence_features(
                gray, cfg, device=self.device)
        else:
            raise ValueError(cfg.registration)
        # persist the last successful direction across sequences
        for r in reversed(recs):
            if r.ok and r.direction:
                self._direction = r.direction
                break
        if self.cfg.print_log or self.cfg.evaluate:
            for k, r in enumerate(recs):
                if r.ok:
                    print_and_write(
                        self.cfg,
                        f"  The offset of pair {k} is {list(r.offset)} "
                        f"(direction={r.direction}, scale={r.scale}, "
                        f"confidence={r.confidence:.3g})")
                else:
                    print_and_write(
                        self.cfg, f"  Pair {k} failed to register after "
                                  f"{r.attempts} attempts")
        return recs

    def stitch_batch(self, batch: dataset.ImageBatch) -> List[StitchResult]:
        """flowStitchWithMutiple semantics on a decoded batch: one
        StitchResult per stitchable segment; a lone image is returned as-is
        (reference Stitcher.py:119-125)."""
        t0 = time.time()
        gray = torch.as_tensor(batch.gray)
        if self.device is not None:
            gray = gray.to(self.device)
        recs = self.register(gray)
        t_reg = time.time() - t0
        n = batch.num_images
        results: List[StitchResult] = []
        t0 = time.time()
        start = 0
        while start < n:
            end = start
            seg_offsets: List[Tuple[int, int]] = []
            while end < n - 1 and recs[end].ok:
                seg_offsets.append(recs[end].offset)
                end += 1
            if end == start:
                img = gray[start].cpu().numpy()
            else:
                img = compose_mod.compose(gray[start:end + 1], seg_offsets,
                                          self.cfg)
            results.append(StitchResult(image=img,
                                        file_range=(start, end + 1),
                                        offsets=seg_offsets))
            start = end + 1
        t_fuse = time.time() - t0
        report = SequenceReport.from_records(recs, t_register=t_reg,
                                             t_compose=t_fuse)
        for r in results:
            r.report = report
        return results

    def stitch_files(self, files: Sequence[str]) -> List[StitchResult]:
        """Decode ``files`` serially, then ``stitch_batch``."""
        return self.stitch_batch(dataset.load_batch(files, self.cfg.color_mode))
