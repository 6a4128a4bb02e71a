"""top2_l2_roofline: K5's share of its roofline.  The least time of every
call the window made (``roofline.top2_l2_bound_s`` of the call's shapes,
from the wrapper's record of ``top2_l2``), summed, over the device time of
the matcher's kernels that ran inside K5's calls (the calls' annotations
on the device; where the trace has none and K3 did not run, every matcher
kernel).  The calls that launched must equal K5's launch counter."""
from stitchbench import roofline
from stitchbench.trace import PREFIX

TARGET = "imagestitch_tpu_torch.ops.kernels.matcher:top2_l2"
COUNTER = "imagestitch_tpu_torch.ops.kernels.matcher:TOP2_LAUNCHES"
K3_COUNTER = "imagestitch_tpu_torch.ops.kernels.matcher:LAUNCHES"
WRAP = [TARGET]
COUNTERS = [COUNTER, K3_COUNTER]
KERNELS = ("matcher_tc_kernel", "matcher_merge_kernel")


def read(run):
    calls = [c for c in run.calls.get(TARGET, [])
             if c["use_kernel"] and c["da"]["device"] == "cuda"]
    if run.trace is None or not calls:
        return None
    if len(calls) != run.counters[COUNTER]:
        raise RuntimeError(f"top2_l2_roofline: {len(calls)} calls, "
                           f"{run.counters[COUNTER]} launches counted")
    events = run.trace.kernel_events(KERNELS)
    spans = run.trace.device_annotations.get(PREFIX + "top2_l2")
    if spans:
        events = [ev for ev in events
                  if any(s <= ev[0] and ev[1] <= e for s, e in spans)]
    elif run.counters[K3_COUNTER]:
        return None
    bound = sum(roofline.top2_l2_bound_s(
        c["da"]["shape"][0], c["da"]["shape"][1], c["db"]["shape"][1],
        c["da"]["shape"][2]) for c in calls)
    busy = sum(e - s for s, e, _ in events) * 1e-9
    return 100.0 * bound / busy if busy > 0 else None
