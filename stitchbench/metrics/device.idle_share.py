"""device.idle_share: 100 x (1 - the union of the device's kernel, copy
and set intervals / the traced window), from the torch.profiler trace."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
