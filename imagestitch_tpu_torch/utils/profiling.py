"""Profiling and throughput measurement.

Port of ``imagestitch_tpu/utils/profiling.py``: fenced phase timers (a
fence waits until the card has finished the work behind a value, so
asynchronous launches cannot make a phase look short), a frames/s meter,
and a ``torch.profiler`` trace context that writes a Chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in ``value`` (a tensor, or a tuple,
    list or dict of them, nested)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def block_until_ready(value):
    """Wait until every CUDA device that holds a tensor of ``value`` has
    finished its queued work (``torch.cuda.synchronize``); CPU tensors and
    other values are ready already.  Returns ``value``."""
    for device in _cuda_devices(value, set()):
        torch.cuda.synchronize(device)
    return value


@dataclass
class PhaseTimer:
    """Named phase spans in seconds, host clock; device-fenced when given
    the tensors the phase produces."""
    spans: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        """Time the body, then wait for ``fence`` (read at exit, so a list
        the body fills is fenced whole) before stopping the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                block_until_ready(fence)
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def fence(self, name: str, value):
        """Time until ``value`` is device-complete, attributed to ``name``."""
        t0 = time.perf_counter()
        block_until_ready(value)
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0
        return value

    def report(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.spans.items()})


def frames_per_second(n_frames: int, fn, *args, repeats: int = 3,
                      **kwargs) -> float:
    """Best-of-N fenced throughput of ``fn(*args)`` processing n_frames."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        block_until_ready(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return n_frames / best


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the body (the CPU, and the card when
    CUDA is available), written as a Chrome trace to
    ``<log_dir>/trace.json``; ``log_dir`` defaults to ``torch-trace`` in
    the temporary directory.  Yields ``log_dir``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
