"""compose.readback.s_per_frame: host seconds a frame spent reading the
panoramas back to the host, which waits for the fuse work still queued on
the card: the program's ``COMPOSE_READBACK_NS``, the ``compose.readback``
span's nanoseconds, over the traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "COMPOSE_READBACK_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
