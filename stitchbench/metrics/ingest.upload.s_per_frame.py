"""ingest.upload.s_per_frame: host seconds a frame spent pinning each
chunk's gray frames and issuing their copy to the card
(``io/prefetch.Uploader``): the program's ``INGEST_UPLOAD_NS``, the
``ingest.upload`` span's nanoseconds, over the traced projects'
``FRAMES``."""
from stitchbench import program_counters

COUNTER = "INGEST_UPLOAD_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
