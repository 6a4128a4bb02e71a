"""compose.multiband.resizes_per_frame: resizes of an expanded level to an
odd finer level that the multiband pyramid performed, a frame (the
program's ``COMPOSE_MULTIBAND_RESIZES``, over the traced projects'
``FRAMES``): the count behind ``compose.multiband.resize.s_per_frame``."""
from stitchbench import program_counters

COUNTER = "COMPOSE_MULTIBAND_RESIZES"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER, scale=1)
