"""Records taken from the benchmark's side of the program's calls.

In a traced run only, ``Recorder`` replaces functions of the program,
named ``"module:attribute"`` by the per-layer readers that need them, with
wrappers that keep a summary of each call's arguments (shapes, dtypes,
devices and plain values; no tensor is kept) and mark the call with a
``stitchbench.<attribute>`` annotation in the trace; and it reads launch
counters (``"module:attribute"`` integers) before and after.  ``Spans``
marks the calls into each layer the window drives.  Both put every
attribute back on exit.
"""
from __future__ import annotations

import functools
import importlib
import inspect
from collections import defaultdict
from typing import Dict, Iterable, List

import torch

from .trace import PREFIX


def _resolve(target: str):
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


def summarize(v):
    """A call argument as plain data."""
    if isinstance(v, torch.Tensor):
        return {"shape": list(v.shape), "dtype": str(v.dtype),
                "device": v.device.type}
    if isinstance(v, (list, tuple)):
        return [summarize(x) for x in v]
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    return type(v).__name__


class Recorder:
    """Wraps ``wrap`` targets and reads ``counters`` around a block."""

    def __init__(self, wrap: Iterable[str], counters: Iterable[str]):
        self.wrap = sorted(set(wrap))
        self.counter_names = sorted(set(counters))
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.counters: Dict[str, int] = {}
        self._saved = []
        self._start: Dict[str, int] = {}

    def _counter(self, name: str) -> int:
        mod, attr = _resolve(name)
        return int(getattr(mod, attr))

    def __enter__(self):
        for target in self.wrap:
            mod, attr = _resolve(target)
            fn = getattr(mod, attr)
            sig = inspect.signature(fn)
            calls = self.calls[target]

            @functools.wraps(fn)
            def wrapper(*args, _fn=fn, _sig=sig, _calls=calls, _attr=attr,
                        **kwargs):
                bound = _sig.bind(*args, **kwargs)
                bound.apply_defaults()
                _calls.append({k: summarize(v)
                               for k, v in bound.arguments.items()})
                with torch.profiler.record_function(PREFIX + _attr):
                    return _fn(*args, **kwargs)

            self._saved.append((mod, attr, fn))
            setattr(mod, attr, wrapper)
        self._start = {c: self._counter(c) for c in self.counter_names}
        return self

    def __exit__(self, *exc):
        self.counters = {c: self._counter(c) - self._start[c]
                         for c in self.counter_names}
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
        return False


class Spans:
    """Annotates the calls into each layer: ``register`` and ``compose``
    on the Stitcher, ``ingest`` on the pipelined loader."""

    def __init__(self, stitcher):
        self.stitcher = stitcher
        self._saved = []

    @staticmethod
    def _span(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with torch.profiler.record_function(PREFIX + name):
                return fn(*a, **k)
        return wrapper

    def __enter__(self):
        from imagestitch_tpu_torch.io import prefetch
        for obj, attr, name in ((self.stitcher, "register", "register"),
                                (self.stitcher, "_compose_segment",
                                 "compose"),
                                (prefetch, "load_batch_pipelined", "ingest")):
            fn = getattr(obj, attr)
            self._saved.append((obj, attr, obj.__dict__.get(attr)))
            setattr(obj, attr, self._span(name, fn))
        return self

    def __exit__(self, *exc):
        for obj, attr, old in reversed(self._saved):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
        self._saved.clear()
        return False
