"""register.upload.s_per_frame: host seconds a frame spent sending the gray
frames to the card in ``Stitcher.stitch_batch`` (none where ingest already
put them there): the program's ``REGISTER_UPLOAD_NS``, the
``register.upload`` span's nanoseconds, over the traced projects'
``FRAMES``."""
from stitchbench import program_counters

COUNTER = "REGISTER_UPLOAD_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
