"""upload.stage_reuse_share: 100 x the chunks of host frames sent to a
card through a page-locked staging block an earlier chunk had used (the
program's ``UPLOAD_CHUNKS_REUSED``) / the chunks sent through a staging
block (``UPLOAD_CHUNKS``), over the traced projects.  No value where no
chunk was sent, or on a program without the counters (then the Recorder
is asked for none)."""
import importlib

from stitchbench import program_counters

CHUNKS = f"{program_counters.PROGRAM}:UPLOAD_CHUNKS"
REUSED = f"{program_counters.PROGRAM}:UPLOAD_CHUNKS_REUSED"
_program = importlib.import_module(program_counters.PROGRAM)
COUNTERS = [CHUNKS, REUSED] if all(
    isinstance(getattr(_program, c.split(":")[1], None), int)
    for c in (CHUNKS, REUSED)) else []


def read(run):
    chunks, reused = run.counters.get(CHUNKS), run.counters.get(REUSED)
    if not chunks or reused is None:
        return None
    return 100.0 * reused / chunks
