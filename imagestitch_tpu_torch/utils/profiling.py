"""Profiling and throughput measurement.

Port of ``imagestitch_tpu/utils/profiling.py``: fenced phase timers (a
fence waits until the card has finished the work behind a value, so
asynchronous launches cannot make a phase look short), a frames/s meter,
and a ``torch.profiler`` trace context that writes a Chrome trace.

Beside them, the program's own spans and counters: ``span(name)`` adds
the host time of its body to the module-level counter named after it
(``"ingest.decode"`` -> ``INGEST_DECODE_NS``) and, only while a
``torch.profiler`` session is on, marks the body as
``imagestitch.<name>`` on the trace's timeline.  A span never waits for
the card: device work it queues is waited on by whichever later span
reads a result back.  The counters only grow; read them before and after
a block and take the difference.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

#: prefix of the program's annotations in a torch.profiler trace
PREFIX = "imagestitch."

#: frames that entered ``Stitcher.stitch_batch``
FRAMES = 0
#: match-and-vote dispatches of the feature registrars, each ending in one
#: readback (``_PooledCache.get``, ``_match_vote_adjacent``'s chunks)
REGISTER_DISPATCHES = 0
#: panoramas read back from a card (``core/compose._readback``); of them,
#: those that landed in a page-locked block made for an earlier one, and
#: those that went to pageable memory because none could be locked
COMPOSE_READBACKS = 0
COMPOSE_READBACK_REUSED = 0
COMPOSE_READBACK_PAGEABLE = 0
#: chunks of host arrays sent to a card through a page-locked staging
#: block (``device.StagingRing``); of them, those through a block an
#: earlier chunk had used; and the arrays sent from pageable memory
#: because no block could be locked
UPLOAD_CHUNKS = 0
UPLOAD_CHUNKS_REUSED = 0
UPLOAD_PAGEABLE = 0
#: color frames whose gray the pipelined ingest made
#: (``io/prefetch.load_batch_pipelined``); of them, those made on a device
#: from the uploaded color (``io/dataset.bgr_to_gray_tensor``)
INGEST_GRAY_FRAMES = 0
INGEST_GRAY_CARD = 0
#: resizes of an expanded multiband level to an odd finer level
#: (``ops/fusion/pyramid._expand_to``)
COMPOSE_MULTIBAND_RESIZES = 0
# host nanoseconds of each span, named after it (see ``span``); the ingest
# decode runs on the decode worker thread, and the gray there where it is
# made on the host; the rest run on the caller's
INGEST_DECODE_NS = 0
INGEST_GRAY_NS = 0
INGEST_WAIT_NS = 0
INGEST_UPLOAD_NS = 0
INGEST_CONCAT_NS = 0
REGISTER_NS = 0
REGISTER_UPLOAD_NS = 0
REGISTER_POOL_NS = 0
REGISTER_MATCH_NS = 0
REGISTER_FALLBACK_NS = 0
COMPOSE_NS = 0
COMPOSE_UPLOAD_NS = 0
COMPOSE_FUSE_NS = 0
COMPOSE_READBACK_NS = 0
COMPOSE_MULTIBAND_NS = 0
COMPOSE_MULTIBAND_RESIZE_NS = 0

_LOCK = threading.Lock()
_GLOBALS = globals()
_COUNTER_OF: Dict[str, str] = {}          # span name -> its counter's name
_profiler_enabled = torch._C._autograd._profiler_enabled


def count(counter: str, n: int = 1) -> None:
    """Add ``n`` to the module-level counter ``counter`` (any thread)."""
    with _LOCK:
        _GLOBALS[counter] += n


def _counter_of(name: str) -> str:
    counter = _COUNTER_OF.get(name)
    if counter is None:
        counter = name.upper().replace(".", "_") + "_NS"
        if not isinstance(_GLOBALS.get(counter), int):
            raise ValueError(f"span {name!r}: no counter {counter}")
        _COUNTER_OF[name] = counter
    return counter


class span:
    """Host time of the body, added to the counter named after ``name``
    (``"register.pool"`` -> ``REGISTER_POOL_NS``); ``ns`` holds the body's
    time once it has ended.  While a profiler session is on and
    ``annotate`` holds, the body is also a ``record_function`` named
    ``imagestitch.<name>``.  Pass ``annotate=False`` on a worker thread:
    the profiler keeps no annotation entered there."""

    __slots__ = ("_name", "_counter", "_annotate", "_rf", "_t0", "ns")

    def __init__(self, name: str, annotate: bool = True):
        self._name, self._counter = name, _counter_of(name)
        self._annotate = annotate
        self._rf = None
        self.ns = 0

    def __enter__(self) -> "span":
        if self._annotate and _profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self._name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.ns = time.perf_counter_ns() - self._t0
        with _LOCK:
            _GLOBALS[self._counter] += self.ns
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False

    @property
    def seconds(self) -> float:
        return self.ns * 1e-9


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
