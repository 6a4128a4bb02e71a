"""compose.readback.reuse_share: 100 x the panoramas read back from a card
into a page-locked block made for an earlier one (the program's
``COMPOSE_READBACK_REUSED``) / the panoramas read back from a card
(``COMPOSE_READBACKS``), over the traced projects.  No value where no
panorama was read back from a card, or on a program without the counters
(then the Recorder is asked for none)."""
import importlib

from stitchbench import program_counters

READBACKS = f"{program_counters.PROGRAM}:COMPOSE_READBACKS"
REUSED = f"{program_counters.PROGRAM}:COMPOSE_READBACK_REUSED"
_program = importlib.import_module(program_counters.PROGRAM)
COUNTERS = [READBACKS, REUSED] if all(
    isinstance(getattr(_program, c.split(":")[1], None), int)
    for c in (READBACKS, REUSED)) else []


def read(run):
    readbacks, reused = run.counters.get(READBACKS), run.counters.get(REUSED)
    if not readbacks or reused is None:
        return None
    return 100.0 * reused / readbacks
