"""Pipelined ingest: decode ∥ host-to-device copy ∥ device compute.

Port of ``imagestitch_tpu/io/prefetch.py`` (:22-95, :188-243).  A worker
thread decodes chunk k+1 while chunk k is copied to the device and pooled.
Each chunk goes to the device by ``device.to_device``: to a card through
its page-locked staging ring, whose copies the current stream waits on
before the pool reads the chunk.  The pool is per frame, so chunking
changes no record.  Color files bound for a device go up once as color,
and their gray is made there from it.

The JAX package's XLA warm-ups (``_warm_pool_programs_async``,
``_warm_replay``) have no counterpart: PyTorch runs eagerly and the CUDA
kernels are built once per machine (ROADMAP's do-not-port list).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..utils import profiling
from . import dataset


class ChunkPrefetcher:
    """One-chunk-lookahead decoded-batch iterator (double buffering).

    Yields ``ImageBatch`` chunks of ``chunk_frames`` files; while the caller
    processes chunk k, the worker thread decodes chunk k+1.  In color mode
    without ``host_gray`` the worker makes no gray (``dataset.load_color``):
    each chunk's ``gray`` is None.
    """

    def __init__(self, files: Sequence[str], color_mode: bool = False,
                 chunk_frames: int = 16, *, host_gray: bool = True):
        self._files = list(files)
        self._color = color_mode
        self._chunk = max(chunk_frames, 2)
        self._host_gray = host_gray

    def __iter__(self) -> Iterator[dataset.ImageBatch]:
        spans = [(s, min(s + self._chunk, len(self._files)))
                 for s in range(0, len(self._files), self._chunk)]
        if self._color and not self._host_gray:
            load = lambda s, e: dataset.load_color(self._files[s:e])
        else:
            load = lambda s, e: dataset.load_batch(self._files[s:e],
                                                   self._color)
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(load, *spans[0])
            for k in range(len(spans)):
                with profiling.span("ingest.wait"):
                    batch = fut.result()
                if k + 1 < len(spans):
                    fut = pool.submit(load, *spans[k + 1])
                yield batch


def _upload(host: np.ndarray, device) -> torch.Tensor:
    with profiling.span("ingest.upload"):
        return device_mod.to_device(host, device)


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
    device = device_mod.resolve_device(device, "pooled_features_pipelined")
    dev_chunks, host_chunks, pools = [], [], []
    for batch in ChunkPrefetcher(files, color_mode=False,
                                 chunk_frames=chunk_frames):
        dev = _upload(batch.gray, device)
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
                         *, host_color: bool = False,
                         device="cuda") -> dataset.ImageBatch:
    """``dataset.load_batch`` with decode(k+1) ∥ copy(k): with
    ``to_device`` the frames land on ``device`` (the card unless the
    caller passes ``device="cpu"``), else they stay on the host as numpy.

    In color mode with ``to_device`` the worker decodes color alone; each
    chunk's color goes to ``device`` once and its gray is made there
    (``dataset.bgr_to_gray_tensor``: the host rule's bits), so ``gray``
    and ``color`` are both device tensors.  With ``host_color`` the color
    chunks are also kept and joined on the host, and ``color`` is that
    numpy batch (the streamed-output composers' input).  Counts
    ``INGEST_GRAY_FRAMES`` and, of them, ``INGEST_GRAY_CARD``, the frames
    whose gray was made on the device."""
    if to_device:
        device = device_mod.resolve_device(device, "load_batch_pipelined")
    on_device = color_mode and to_device
    gray_chunks, color_chunks, all_files = [], [], []
    for batch in ChunkPrefetcher(files, color_mode=color_mode,
                                 chunk_frames=chunk_frames,
                                 host_gray=not on_device):
        n = len(batch.files)
        if on_device:
            color = _upload(batch.color, device)
            with profiling.span("ingest.gray"):
                gray_chunks.append(dataset.bgr_to_gray_tensor(color))
            profiling.count("INGEST_GRAY_CARD", n)
            color_chunks.append(batch.color if host_color else color)
        else:
            gray_chunks.append(_upload(batch.gray, device) if to_device
                               else batch.gray)
            if color_mode:
                color_chunks.append(batch.color)
        if color_mode:
            profiling.count("INGEST_GRAY_FRAMES", n)
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
    _, cfg_pool = freg._upright_first(cfg)
    pool, gray_dev, gray_host = pooled_features_pipelined(
        files, cfg_pool, chunk_frames, keep_host,
        device=device_mod.resolve_device(device,
                                         "register_sequence_pipelined"))
    return freg._replay_pool(gray_dev, pool, cfg), gray_dev, gray_host
