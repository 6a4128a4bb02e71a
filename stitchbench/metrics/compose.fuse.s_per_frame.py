"""compose.fuse.s_per_frame: host seconds a frame spent making the canvas,
issuing the paste and fuse steps and the clamp: the program's
``COMPOSE_FUSE_NS``, the ``compose.fuse`` span's nanoseconds, over the
traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "COMPOSE_FUSE_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
