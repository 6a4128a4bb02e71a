"""ingest.decode.s_per_frame: host seconds a frame that the decode worker
spent reading and decoding the files and stacking each chunk
(``io/dataset.load_batch``'s time less the gray): the program's
``INGEST_DECODE_NS``, the ``ingest.decode`` span's nanoseconds, over the
traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "INGEST_DECODE_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
