"""ingest.gray.card_share: 100 x the color frames whose gray the
pipelined ingest made on a device from the uploaded color (the program's
``INGEST_GRAY_CARD``) / the color frames whose gray it made
(``INGEST_GRAY_FRAMES``), over the traced projects.  No value where no
gray was made, or on a program without the counters (then the Recorder
is asked for none)."""
import importlib

from stitchbench import program_counters

FRAMES = f"{program_counters.PROGRAM}:INGEST_GRAY_FRAMES"
CARD = f"{program_counters.PROGRAM}:INGEST_GRAY_CARD"
_program = importlib.import_module(program_counters.PROGRAM)
COUNTERS = [FRAMES, CARD] if all(
    isinstance(getattr(_program, c.split(":")[1], None), int)
    for c in (FRAMES, CARD)) else []


def read(run):
    frames, card = run.counters.get(FRAMES), run.counters.get(CARD)
    if not frames or card is None:
        return None
    return 100.0 * card / frames
