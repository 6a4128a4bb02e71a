"""register.pool.s_per_frame: host seconds a frame spent detecting and
describing every frame once (the upright K1/K2 pool; the whole-image pool on
``feature``): the program's ``REGISTER_POOL_NS``, the ``register.pool``
span's nanoseconds, over the traced projects' ``FRAMES``."""
from stitchbench import program_counters

COUNTER = "REGISTER_POOL_NS"
COUNTERS = program_counters.counters(COUNTER)


def read(run):
    return program_counters.per_frame(run, COUNTER)
