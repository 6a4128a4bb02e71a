"""compose.upload.s_per_frame: host seconds a frame spent sending the
segments' frames to the card: the program's ``COMPOSE_UPLOAD_NS``, the
``compose.upload`` span's nanoseconds, over the traced projects'
``FRAMES``."""
from stitchbench import program_counters

COUNTER = "COMPOSE_UPLOAD_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
