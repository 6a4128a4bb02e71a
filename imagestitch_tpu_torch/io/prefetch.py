"""Pipelined ingest: decode ∥ host-to-device copy ∥ device compute.

Port of ``imagestitch_tpu/io/prefetch.py`` (:22-95, :188-243).  A worker
thread decodes chunk k+1 while chunk k is copied to the device and pooled.
On a CUDA device each chunk's copy is issued from pinned host memory on a
side stream; the main stream waits on that copy's event before the pool
reads the chunk.  The pool is per frame, so chunking changes no record.

The JAX package's XLA warm-ups (``_warm_pool_programs_async``,
``_warm_replay``) have no counterpart: PyTorch runs eagerly and the CUDA
kernels are built once per machine (ROADMAP's do-not-port list).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils import profiling
from . import dataset


class ChunkPrefetcher:
    """One-chunk-lookahead decoded-batch iterator (double buffering).

    Yields ``ImageBatch`` chunks of ``chunk_frames`` files; while the caller
    processes chunk k, the worker thread decodes chunk k+1.
    """

    def __init__(self, files: Sequence[str], color_mode: bool = False,
                 chunk_frames: int = 16):
        self._files = list(files)
        self._color = color_mode
        self._chunk = max(chunk_frames, 2)

    def __iter__(self) -> Iterator[dataset.ImageBatch]:
        spans = [(s, min(s + self._chunk, len(self._files)))
                 for s in range(0, len(self._files), self._chunk)]
        load = lambda s, e: dataset.load_batch(self._files[s:e], self._color)
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(load, *spans[0])
            for k in range(len(spans)):
                with profiling.span("ingest.wait"):
                    batch = fut.result()
                if k + 1 < len(spans):
                    fut = pool.submit(load, *spans[k + 1])
                yield batch


class Uploader:
    """Host uint8 chunks -> tensors on ``device``.

    On a CUDA device: pinned copy of the chunk, H2D on a side stream, the
    current stream waits on the copy's event, and the device tensor is
    recorded on the current stream (it was allocated on the side stream).
    The pinned buffers live as long as the uploader.  On the CPU the chunk
    is wrapped without a copy."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._pinned: List[torch.Tensor] = []
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)

    def __call__(self, host: np.ndarray) -> torch.Tensor:
        with profiling.span("ingest.upload"):
            t = torch.from_numpy(np.ascontiguousarray(host))
            if not self._cuda:
                return t.to(self.device)
            pinned = t.pin_memory()
            self._pinned.append(pinned)
            main = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._stream):
                dev = pinned.to(self.device, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._stream)
            main.wait_event(copied)
            dev.record_stream(main)
            return dev


def _cat(chunks):
    return chunks[0] if len(chunks) == 1 else (
        torch.cat(chunks) if isinstance(chunks[0], torch.Tensor)
        else np.concatenate(chunks))


def pooled_features_pipelined(files: Sequence[str], cfg,
                              chunk_frames: int = 16, keep_host: bool = False,
                              *, device="cuda"
                              ) -> Tuple[tuple, torch.Tensor,
                                         Optional[np.ndarray]]:
    """Decode-overlapped pooled feature extraction of a whole sequence.

    Returns ``(pool, gray_dev, gray_host)``: the (rows, cols, scores, descs)
    keypoint pool of every frame, the gray batch on ``device`` (the card
    unless the caller passes ``device="cpu"``; kept for composition) and,
    with ``keep_host``, the decoded host batch (input of the
    streamed-output composers), else None.  Equal to ``load_batch`` +
    ``_precompute_pool``.
    """
    from ..core import feature_registration as freg
    upload = Uploader(resolve_device(device, "pooled_features_pipelined"))
    dev_chunks, host_chunks, pools = [], [], []
    for batch in ChunkPrefetcher(files, color_mode=False,
                                 chunk_frames=chunk_frames):
        dev = upload(batch.gray)
        with profiling.span("register.pool"):
            pools.append(freg._precompute_pool(dev, cfg))
        dev_chunks.append(dev)
        if keep_host:
            host_chunks.append(batch.gray)
    with profiling.span("ingest.concat"):
        pool = tuple(_cat([p[i] for p in pools])
                     for i in range(len(pools[0])))
        return (pool, _cat(dev_chunks),
                _cat(host_chunks) if keep_host else None)


def load_batch_pipelined(files: Sequence[str], color_mode: bool,
                         to_device: bool = True, chunk_frames: int = 16,
                         *, device="cuda") -> dataset.ImageBatch:
    """``dataset.load_batch`` with decode(k+1) ∥ copy(k): with
    ``to_device`` the gray frames land on ``device`` (the card unless the
    caller passes ``device="cpu"``), else they stay on the host as numpy;
    color frames (composition input) stay on the host."""
    upload = (Uploader(resolve_device(device, "load_batch_pipelined"))
              if to_device else None)
    gray_chunks, color_chunks, all_files = [], [], []
    for batch in ChunkPrefetcher(files, color_mode=color_mode,
                                 chunk_frames=chunk_frames):
        gray_chunks.append(upload(batch.gray) if to_device else batch.gray)
        if color_mode:
            color_chunks.append(batch.color)
        all_files.extend(batch.files)
    with profiling.span("ingest.concat"):
        return dataset.ImageBatch(
            gray=_cat(gray_chunks),
            color=_cat(color_chunks) if color_mode else None,
            files=all_files)


def register_sequence_pipelined(files: Sequence[str], cfg,
                                chunk_frames: int = 16,
                                keep_host: bool = False, *, device="cuda"):
    """Decode-included ``feature_incre`` registration of a file sequence.

    Returns ``(records, gray_dev, gray_host)``: the records of
    ``register_sequence_features_incre`` on the decoded batch (the upright
    pool, the replay, then the oriented fallback for failed pairs), the
    gray batch on ``device`` (the card unless the caller passes
    ``device="cpu"``) and, with ``keep_host``, the host batch.
    """
    from ..core import feature_registration as freg
    fast = cfg.features.auto_upright and not cfg.features.upright
    cfg_pool = cfg.replace(features=dataclasses.replace(
        cfg.features, upright=True)) if fast else cfg
    pool, gray_dev, gray_host = pooled_features_pipelined(
        files, cfg_pool, chunk_frames, keep_host,
        device=resolve_device(device, "register_sequence_pipelined"))
    n, h, w = gray_dev.shape
    with profiling.span("register.match"):
        recs = freg.replay_from_pool(pool, n, (h, w), cfg_pool)
    if fast and any(not r.ok for r in recs):
        with profiling.span("register.fallback"):
            recs = freg._oriented_fallback_incre(gray_dev, recs, cfg, (h, w))
    return recs, gray_dev, gray_host
