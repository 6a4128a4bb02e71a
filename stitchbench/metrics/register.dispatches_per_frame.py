"""register.dispatches_per_frame: match-and-vote dispatches a frame, each
ending in one readback (``_PooledCache.get``, the chunks of
``_match_vote_adjacent``): the program's ``REGISTER_DISPATCHES``, over the
traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "REGISTER_DISPATCHES"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER, scale=1)
