"""The program's own spans and counters, read per frame.

The port keeps module-level counters in ``imagestitch_tpu_torch.utils.
profiling``: the host nanoseconds of each of its spans (``span(name)``
adds to ``<NAME>_NS``), ``REGISTER_DISPATCHES`` and ``FRAMES``, the frames
that entered ``Stitcher.stitch_batch``.  A reader lists the counter and
``FRAMES`` in its ``COUNTERS``; the ``Recorder`` reads both before and
after the traced projects, and the reader divides the one difference by
the other.  A program that lacks either counter gets an empty list, so
its traced run goes on and the metric reads as no value.
"""
from __future__ import annotations

import importlib
from typing import List, Optional

PROGRAM = "imagestitch_tpu_torch.utils.profiling"
FRAMES = PROGRAM + ":FRAMES"


def counters(attr: str) -> List[str]:
    """The ``COUNTERS`` of a reader of ``attr``: it and ``FRAMES`` where
    the program has both, else none."""
    mod = importlib.import_module(PROGRAM)
    if not all(isinstance(getattr(mod, a, None), int)
               for a in (attr, "FRAMES")):
        return []
    return [f"{PROGRAM}:{attr}", FRAMES]


def per_frame(run, attr: str, scale: float = 1e-9) -> Optional[float]:
    """``attr``'s difference over the traced projects times ``scale``
    (nanoseconds to seconds by default), a frame; None where no frame was
    stitched or the program has no such counter."""
    frames = run.counters.get(FRAMES)
    value = run.counters.get(f"{PROGRAM}:{attr}")
    if not frames or value is None:
        return None
    return value * scale / frames
