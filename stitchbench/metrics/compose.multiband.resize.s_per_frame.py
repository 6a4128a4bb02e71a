"""compose.multiband.resize.s_per_frame: host seconds a frame spent in the
multiband pyramid's resizes of an expanded level to an odd finer level
(``ops/fusion/pyramid._expand_to``: the band gathers of ``_resize_to``),
inside ``compose.multiband``: the program's
``COMPOSE_MULTIBAND_RESIZE_NS``, the ``compose.multiband.resize`` span's
nanoseconds, over the traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "COMPOSE_MULTIBAND_RESIZE_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
