"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

``Tracer`` wraps the measured window in one profiler session (CPU and CUDA
activities).  ``TraceData`` keeps what the readers need, in the profiler's
own clock (ns): the window (the ``stitchbench.window`` annotation), every
device interval (kernels, copies, sets) inside it, the benchmark's
annotations on the host and on the device, and the host's operators, which
name what the host was doing while the device was idle.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "stitchbench."
WINDOW = PREFIX + "window"

Interval = Tuple[int, int]


def _ns(ev, what: str) -> int:
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _is_cuda(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _is_annotation(ev) -> bool:
    if hasattr(ev, "is_user_annotation") and ev.is_user_annotation():
        return True
    return ev.name().startswith(PREFIX)


@dataclasses.dataclass
class TraceData:
    window: Interval
    device: List[Tuple[int, int, str]]
    host_annotations: Dict[str, List[Interval]]
    device_annotations: Dict[str, List[Interval]]
    host_ops: List[Tuple[int, int, str]]

    @classmethod
    def from_events(cls, events) -> "TraceData":
        device, host_ops = [], []
        host_ann: Dict[str, List[Interval]] = defaultdict(list)
        dev_ann: Dict[str, List[Interval]] = defaultdict(list)
        for ev in events:
            s = _ns(ev, "start")
            e = s + max(int(_ns(ev, "duration")), 0) \
                if not hasattr(ev, "end_ns") else int(ev.end_ns())
            name = ev.name()
            if _is_annotation(ev):
                (dev_ann if _is_cuda(ev) else host_ann)[name].append((s, e))
            elif _is_cuda(ev):
                device.append((s, e, name))
            else:
                host_ops.append((s, e, name))
        if not host_ann.get(WINDOW):
            raise RuntimeError("trace: no stitchbench.window annotation")
        win = host_ann[WINDOW][0]
        device = [(max(s, win[0]), min(e, win[1]), n) for s, e, n in device
                  if e > win[0] and s < win[1]]
        return cls(win, sorted(device), dict(host_ann), dict(dev_ann),
                   sorted(host_ops))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> List[Interval]:
        """The union of the device intervals, merged and ordered."""
        merged: List[List[int]] = []
        for s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_events(self, names) -> List[Tuple[int, int, str]]:
        """Device events whose name contains one of ``names``."""
        return [d for d in self.device if any(n in d[2] for n in names)]

    def gaps(self) -> List[Interval]:
        """The idle intervals of the window, longest first."""
        out, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_doing(self, gap: Interval) -> str:
        """What the host was doing in ``gap``: the benchmark's innermost
        span around its middle, and the host operator that covers most of
        it, where one covers at least half of it (else ``python``: host
        code between operators, or a wait)."""
        mid = (gap[0] + gap[1]) // 2
        phase, width = "window", None
        for name, spans in self.host_annotations.items():
            if name == WINDOW:
                continue
            for s, e in spans:
                if s <= mid < e and (width is None or e - s < width):
                    phase, width = name[len(PREFIX):], e - s
        best, cover = "python", (gap[1] - gap[0]) // 2
        for s, e, name in self.host_ops:
            if s >= gap[1]:
                break
            c = min(e, gap[1]) - max(s, gap[0])
            if c > cover:
                best, cover = name, c
        return f"{phase}: {best}"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, int] = defaultdict(int)
        for s, e, n in self.device:
            by_name[n[:120]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = [[self.host_doing(g), (g[1] - g[0]) * 1e-9]
                for g in self.gaps()[:top]]
        return {"device_ops": [[n, t * 1e-9] for n, t in ops],
                "idle_gaps": gaps}


class Tracer:
    """One profiler session around the window."""

    def __init__(self):
        import torch
        self._torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._window = None
        self.data: Optional[TraceData] = None

    def __enter__(self):
        self._prof.__enter__()
        self._window = self._torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.data = TraceData.from_events(
                self._prof.profiler.kineto_results.events())
        return False
