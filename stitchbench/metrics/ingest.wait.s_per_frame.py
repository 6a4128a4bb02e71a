"""ingest.wait.s_per_frame: host seconds a frame that the main thread waited
for the decode worker's next chunk (``io/prefetch.ChunkPrefetcher``): the
program's ``INGEST_WAIT_NS``, the ``ingest.wait`` span's nanoseconds, over
the traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "INGEST_WAIT_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
