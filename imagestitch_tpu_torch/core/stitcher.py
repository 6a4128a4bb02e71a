"""Sequence / dataset stitching orchestration.

Port of the single-device path of ``imagestitch_tpu/core/stitcher.py``
(:54-334):
  * ``register``           — the five registration strategies: pooled
    incremental or whole-image feature search, incremental or whole-image
    phase correlation, and features with a phase fallback (hybrid);
  * ``stitch_batch``       — flowStitchWithMutiple (reference
    Stitcher.py:96-127): register every pair up front (or load the records
    from a checkpoint), split into segments at failed pairs, compose each
    segment in color or gray, from the pairwise offsets or, with
    ``use_global_solver``, from the pose-graph solver's positions;
  * ``stitch_files``       — pipelined ingest (io/prefetch.py), fused with
    the pool on the gray ``feature_incre`` path;
  * ``stitch_project_set`` — imageSetStitchWithMutiple (Stitcher.py:153-182).

With a ``mesh`` of two or more shards (JAX stitcher.py:64-85, :186-190,
:276-298) the same Stitcher runs frame-sharded registration
(parallel/pooled_sharded.py: ``feature_incre`` unless strict-ROI detection
or enhancement is on, ``feature`` unless enhancement is on), composes on
the sharded canvas (parallel/compose_sharded.py) unless the global solver
runs, and keeps decoded frames on the host for the sharded registrars to
place.  Records and panoramas are the single-device ones.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import StitchConfig
from ..device import resolve_device, to_device
from ..io import codec, dataset
from ..utils import profiling
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


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gray_host(batch: dataset.ImageBatch) -> Optional[np.ndarray]:
    """The gray frames the host holds, for the streamed-output composers:
    the batch's host copy, else its gray frames if they are numpy."""
    if batch.gray_host is not None:
        return batch.gray_host
    return batch.gray if isinstance(batch.gray, np.ndarray) else None


class Stitcher:
    """The engine facade for one configuration on one device or a mesh.

    ``checkpoint_dir``: registration records are saved there per file list
    and loaded instead of registering again.  ``device``: where
    registration and composition run (a ``torch.device`` or its name), the
    card unless the caller asks for the CPU (``device="cpu"``); a CUDA
    device without CUDA raises.  ``mesh``: a ``parallel.mesh.Mesh``; with
    one, ``device`` is the mesh's first device, and a mesh of two or more
    shards takes the sharded paths.  The search direction persists across
    calls (reference parity: Stitcher.direction is a class attribute,
    Stitcher.py:361).
    """

    def __init__(self, cfg: StitchConfig, checkpoint_dir: Optional[str] = None,
                 mesh=None, device="cuda"):
        if mesh is not None:
            device = mesh.devices[0]
        self.device = resolve_device(device, "Stitcher")
        self.cfg = cfg
        self.checkpoint_dir = checkpoint_dir
        self.mesh = mesh
        self._direction = cfg.direction

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    # -- registration ------------------------------------------------------

    def register(self, gray) -> List[registration.PairRegistration]:
        """Register all adjacent pairs of an (N, H, W) grayscale batch on
        the Stitcher's device (a tensor elsewhere is moved there)."""
        cfg = self.cfg.replace(direction=self._direction)
        registrar = {
            "phase_incre": registration.register_sequence_phase,
            "phase": registration.register_sequence_phase_whole,
            "feature_incre": registration.register_sequence_features_incre,
            "feature": registration.register_sequence_features,
            "hybrid": registration.register_sequence_hybrid,
        }.get(cfg.registration)
        if registrar is None:
            raise ValueError(cfg.registration)
        if cfg.registration == "phase" and self.mesh is not None:
            registrar = functools.partial(registrar, mesh=self.mesh)
        if self._sharded() and not cfg.enhance.enabled and (
                cfg.registration == "feature" or (
                    cfg.registration == "feature_incre"
                    and not cfg.features.strict_roi_detect)):
            from ..parallel import pooled_sharded
            sharded = (pooled_sharded.register_sequence_features_sharded
                       if cfg.registration == "feature" else
                       pooled_sharded.register_sequence_features_incre_sharded)
            recs = sharded(gray, cfg, self.mesh)
        else:
            recs = registrar(to_device(gray, self.device), cfg,
                             device=self.device)
        self._after_register(recs)
        return recs

    def _after_register(self, recs) -> None:
        """Persist the last successful direction across sequences and log
        every pair (reference Stitcher.py:303, :366 via printAndWrite)."""
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

    # -- sequence stitching ------------------------------------------------

    def stitch_batch(self, batch: dataset.ImageBatch,
                     recs: Optional[List[registration.PairRegistration]] = None
                     ) -> List[StitchResult]:
        """flowStitchWithMutiple semantics on a decoded batch: one
        StitchResult per stitchable segment; a lone image is returned as-is
        (reference Stitcher.py:119-125).  ``recs``: precomputed records (the
        pipelined ingest registers while it decodes)."""
        profiling.count("FRAMES", batch.num_images)
        with profiling.span("register") as t_reg:
            ckpt_path = None
            if self.checkpoint_dir is not None:
                from . import checkpoint
                key = hashlib.sha1(
                    "\n".join(batch.files).encode()).hexdigest()[:16]
                ckpt_path = os.path.join(self.checkpoint_dir,
                                         f"reg_{key}.json")
                if recs is None:
                    recs = checkpoint.load_registration(ckpt_path,
                                                        batch.files)
            # gray crosses to the device once, where it registers and, in
            # gray mode, composes; color mode composes batch.color
            with profiling.span("register.upload"):
                gray = batch.gray if self.cfg.color_mode else \
                    to_device(batch.gray, self.device)
                gray_dev = to_device(gray, self.device) if recs is None \
                    else None
            if recs is None:
                recs = self.register(gray_dev)
                # color mode's copy of the gray frames is not held through
                # composition
                del gray_dev
                if ckpt_path is not None:
                    checkpoint.save_registration(ckpt_path, batch.files,
                                                 recs)
        compose_src = batch.color if self.cfg.color_mode else gray
        n = batch.num_images
        results: List[StitchResult] = []
        with profiling.span("compose") as t_fuse:
            start = 0
            while start < n:
                end = start
                seg_offsets: List[Tuple[int, int]] = []
                while end < n - 1 and recs[end].ok:
                    seg_offsets.append(recs[end].offset)
                    end += 1
                if end == start:
                    img = _host(compose_src[start])
                elif self.cfg.use_global_solver:
                    img = self._solve_and_compose(batch, recs, gray,
                                                  compose_src[start:end + 1],
                                                  start, end)
                elif self._sharded():
                    from ..parallel import compose_sharded
                    img = compose_sharded.compose_sharded(
                        compose_src[start:end + 1], seg_offsets, self.cfg,
                        self.mesh)
                else:
                    img = self._compose_segment(
                        batch, compose_src[start:end + 1], seg_offsets,
                        start, end)
                results.append(StitchResult(image=img,
                                            file_range=(start, end + 1),
                                            offsets=seg_offsets))
                start = end + 1
        report = SequenceReport.from_records(recs,
                                             t_register=t_reg.seconds,
                                             t_compose=t_fuse.seconds)
        for r in results:
            r.report = report
        return results

    def _solve_and_compose(self, batch: dataset.ImageBatch, recs, gray,
                           seg_images, start: int, end: int) -> np.ndarray:
        """The global solver's segment (JAX stitcher.py:161-185): the chain
        of sub-pixel offsets weighted by confidence (at least 1e-3), with
        loop-closure edges measured on the gray frames when the segment has
        three or more, solved for absolute positions and composed from
        them."""
        from ..solver import loop_closure
        from ..solver import pose_graph as pg
        subpix = [recs[k].offset_subpix for k in range(start, end)]
        conf = [max(recs[k].confidence, 1e-3) for k in range(start, end)]
        graph = pg.PoseGraph.from_chain(subpix, conf)
        if end - start + 1 >= 3:
            gray_seg = to_device(gray[start:end + 1], self.device)
            graph, n_loop = loop_closure.close_loops(
                gray_seg, graph, pg.chain_positions(subpix),
                tuple(gray_seg.shape[1:]), device=self.device)
            if self.cfg.print_log or self.cfg.evaluate:
                print_and_write(self.cfg, f"  solver: {n_loop} loop-closure "
                                          f"edges added")
        positions = pg.solve(graph, iters=self.cfg.solver_iters or None,
                             device=self.device)
        return self._compose_positions(batch, seg_images, positions, start,
                                       end)

    def _compose_positions(self, batch: dataset.ImageBatch, seg_images,
                           positions, start: int, end: int) -> np.ndarray:
        """Compose a solved segment (JAX stitcher.py:242-263): on the
        device by default; with ``stream_output`` and a mode the host
        composers run, on the host in float64 (``compose_host_positions``)
        for color frames and for gray frames the host holds, the runtime
        present.  Color takes the host without the runtime too, as
        ``_compose_segment`` does (the JAX package composes it on the
        device then)."""
        cfg = self.cfg
        if cfg.stream_output and \
                cfg.fuse_method in compose_mod._PADDABLE_METHODS:
            from ..io import native_loader
            from . import stream_out
            if cfg.color_mode:
                if isinstance(batch.color, np.ndarray):
                    return stream_out.compose_host_positions(
                        seg_images, positions, cfg)
            else:
                host = _gray_host(batch)
                if host is not None and native_loader.get_lib() is not None:
                    return stream_out.compose_host_positions(
                        host[start:end + 1], positions, cfg)
        return compose_mod.compose_from_positions(seg_images, positions, cfg,
                                                  device=self.device)

    def _compose_segment(self, batch: dataset.ImageBatch, seg_images,
                         seg_offsets, start: int, end: int) -> np.ndarray:
        """Compose one segment (JAX stitcher.py:206-240): on the device with
        a full readback by default.  With ``stream_output`` and a mode the
        host composers run (``compose._PADDABLE_METHODS``), color on the
        host in float64 and gray on the host in float64 (runtime present)
        or on the device with a rect-only readback (runtime absent); gray
        multiband and seam take the rect-only readback, and color multiband
        and seam go to ``compose``, which raises."""
        cfg = self.cfg
        if cfg.stream_output:
            from ..io import native_loader
            from . import stream_out
            paddable = cfg.fuse_method in compose_mod._PADDABLE_METHODS
            if cfg.color_mode:
                if isinstance(batch.color, np.ndarray) and paddable:
                    return stream_out.compose_color_host(
                        seg_images, seg_offsets, cfg)
            else:
                host = _gray_host(batch)
                if host is not None and paddable and \
                        native_loader.get_lib() is not None:
                    return stream_out.compose_host(host[start:end + 1],
                                                   seg_offsets, cfg)
                if host is not None:
                    return stream_out.compose_streamed(
                        host[start:end + 1], seg_offsets, cfg,
                        frames_dev=seg_images, device=self.device)
        return compose_mod.compose(seg_images, seg_offsets, cfg,
                                   device=self.device)

    def stitch_files(self, files: Sequence[str]) -> List[StitchResult]:
        """Stitch a file sequence with pipelined ingest: decode of chunk
        k+1 overlaps the copy to the device and the device work of chunk k.
        On the gray pooled ``feature_incre`` path (no strict-ROI detection,
        no enhancement) without checkpoints the decode overlaps the pool
        itself (io/prefetch.register_sequence_pipelined);
        the other strategies register the loaded batch.  Color frames
        reach the device once, at ingest, with their gray made there; with
        ``stream_output`` the host keeps them too, for the host composers.
        A mesh of two or more shards keeps the frames on the host, for the
        sharded paths to place."""
        from ..io import prefetch
        cfg = self.cfg
        if (cfg.registration == "feature_incre" and not self._sharded()
                and self.checkpoint_dir is None
                and not cfg.features.strict_roi_detect
                and not cfg.enhance.enabled and not cfg.color_mode):
            recs, gray_dev, gray_host = prefetch.register_sequence_pipelined(
                files, cfg.replace(direction=self._direction),
                keep_host=cfg.stream_output, device=self.device)
            self._after_register(recs)
            batch = dataset.ImageBatch(gray=gray_dev, color=None,
                                       files=list(files), gray_host=gray_host)
            return self.stitch_batch(batch, recs=recs)
        return self.stitch_batch(prefetch.load_batch_pipelined(
            files, cfg.color_mode, to_device=not self._sharded(),
            host_color=cfg.stream_output, device=self.device))

    # -- dataset orchestration (L4) ----------------------------------------

    def stitch_project_set(self, project_address: str, output_address: str,
                           file_num: int, start_num: int = 1,
                           file_extension: str = "jpg",
                           output_extension: str = "jpg") -> List[str]:
        """imageSetStitchWithMutiple semantics (Stitcher.py:153-182) with
        portable paths: ``stitching_result_<i>.<ext>`` for a sub-project
        that stitches whole, else ``stitching_result_<i>_<j>.<ext>`` per
        segment.  Returns the written files."""
        written: List[str] = []
        for i in range(start_num, file_num + 1):
            t0 = time.perf_counter()
            files = dataset.list_project_images(project_address, i,
                                                file_extension)
            if not files:
                print(f"warning: no *.{file_extension} files under "
                      f"{os.path.join(project_address, str(i))}; skipping")
                continue
            results = self.stitch_files(files)
            os.makedirs(output_address, exist_ok=True)
            if len(results) == 1:
                names = [f"stitching_result_{i}.{output_extension}"]
            else:
                names = [f"stitching_result_{i}_{j + 1}.{output_extension}"
                         for j in range(len(results))]
            for name, res in zip(names, results):
                out = os.path.join(output_address, name)
                codec.imwrite(out, res.image)
                written.append(out)
            print_and_write(self.cfg,
                            f"Time consuming for {project_address}/{i}: "
                            f"{time.perf_counter() - t0:.3f}s")
        return written
