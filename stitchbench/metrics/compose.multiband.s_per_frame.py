"""compose.multiband.s_per_frame: host seconds a frame spent in the gray
multiband blend of the fuse rects (``ops/fusion/pyramid.fuse_multiband``:
pre-fill, both Laplacian pyramids, the half/half blend and its
reconstruction, all enqueued inside ``compose.fuse``): the program's
``COMPOSE_MULTIBAND_NS``, the ``compose.multiband`` span's nanoseconds,
over the traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "COMPOSE_MULTIBAND_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
