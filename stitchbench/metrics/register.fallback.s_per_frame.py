"""register.fallback.s_per_frame: host seconds a frame spent retrying the
failed pairs with oriented descriptors, their pool and replay included: the
program's ``REGISTER_FALLBACK_NS``, the ``register.fallback`` span's
nanoseconds, over the traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "REGISTER_FALLBACK_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
