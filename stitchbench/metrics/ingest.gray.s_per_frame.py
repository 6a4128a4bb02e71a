"""ingest.gray.s_per_frame: host seconds a frame that the decode worker
spent making the gray frames from the color ones (the fixed-point rule of
``io/dataset.bgr_to_gray``): the program's ``INGEST_GRAY_NS``, the
``ingest.gray`` span's nanoseconds, over the traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "INGEST_GRAY_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
