"""register.match.s_per_frame: host seconds a frame spent in the replay over
the pool, or in the whole-image match and vote, each ending in its
readbacks: the program's ``REGISTER_MATCH_NS``, the ``register.match``
span's nanoseconds, over the traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "REGISTER_MATCH_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
