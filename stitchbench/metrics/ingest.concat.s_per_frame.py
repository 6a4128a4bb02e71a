"""ingest.concat.s_per_frame: host seconds a frame spent joining the chunks'
gray and color frames into one batch (``io/prefetch.load_batch_pipelined``):
the program's ``INGEST_CONCAT_NS``, the ``ingest.concat`` span's
nanoseconds, over the traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "INGEST_CONCAT_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
