"""doh_select_roofline: K1's share of its roofline.  The least time of
every call the window made (``roofline.doh_select_bound_s`` of the call's
bands, from the wrapper's record of ``doh_select_octaves``), summed, over
the device time of K1's kernels (its tile and merge kernels) in the trace.
The calls that launched must equal K1's launch counter and its tile
kernels in the trace."""
from stitchbench import roofline

TARGET = "imagestitch_tpu_torch.ops.kernels.doh:doh_select_octaves"
COUNTER = "imagestitch_tpu_torch.ops.kernels.doh:LAUNCHES"
WRAP = [TARGET]
COUNTERS = [COUNTER]
KERNELS = ("doh_select_tiles", "doh_select_merge")


def read(run):
    calls = [c for c in run.calls.get(TARGET, [])
             if c["use_kernel"] and c["atlas"]["device"] == "cuda"]
    if run.trace is None or not calls:
        return None
    tiles = len(run.trace.kernel_events(KERNELS[:1]))
    if not len(calls) == run.counters[COUNTER] == tiles:
        raise RuntimeError(f"doh_select_roofline: {len(calls)} calls, "
                           f"{run.counters[COUNTER]} launches counted, "
                           f"{tiles} tile kernels traced")
    bound = sum(roofline.doh_select_bound_s(
        c["bands"], c["n_scales"], c["base_sigma"], c["spacing"])
        for c in calls)
    busy = sum(e - s for s, e, _ in run.trace.kernel_events(KERNELS)) * 1e-9
    return 100.0 * bound / busy
