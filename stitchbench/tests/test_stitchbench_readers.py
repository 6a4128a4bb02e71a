"""Each metric reader on a made-up run and trace."""
import pytest

from stitchbench import manifest, roofline
from stitchbench.run import RunData
from stitchbench.trace import PREFIX, WINDOW, TraceData

from conftest import ROOT

DOH = "imagestitch_tpu_torch.ops.kernels.doh"
MATCH = "imagestitch_tpu_torch.ops.kernels.matcher"


class Ev:
    """A profiler event as the trace reader sees one."""

    def __init__(self, name, start, dur, cuda=False, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._cuda, self._a = cuda, annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def end_ns(self):
        return self._s + self._d

    def is_user_annotation(self):
        return self._a


def reader(name):
    return manifest.Manifest(ROOT).reader(name)


def trace():
    bands = [(0, 100, 120, 8, 4), (100, 50, 60, 4, 2)]
    events = [
        Ev(WINDOW, 0, 1_000_000, annotation=True),
        Ev(PREFIX + "register", 0, 400_000, annotation=True),
        Ev(PREFIX + "top2_l2", 500_000, 100_000, annotation=True),
        Ev(PREFIX + "top2_l2", 520_000, 50_000, cuda=True, annotation=True),
        Ev("aten::sort", 250_000, 200_000),
        Ev("aten::item", 760_000, 20_000),
        Ev("doh_select_tiles(float const*)", 100_000, 40_000, cuda=True),
        Ev("doh_select_merge(Octaves)", 140_000, 10_000, cuda=True),
        Ev("doh_select_tiles(float const*)", 200_000, 40_000, cuda=True),
        Ev("doh_select_merge(Octaves)", 240_000, 10_000, cuda=True),
        Ev("matcher_tc_kernel(float const*)", 520_000, 40_000, cuda=True),
        Ev("matcher_merge_kernel(float const*)", 560_000, 10_000, cuda=True),
        Ev("matcher_tc_kernel(float const*)", 700_000, 40_000, cuda=True),
        Ev("Memcpy HtoD (Pageable -> Device)", 900_000, 200_000, cuda=True),
    ]
    data = TraceData.from_events(events)
    calls = {f"{DOH}:doh_select_octaves": [
        {"atlas": {"shape": [150, 120], "dtype": "torch.float32",
                   "device": "cuda"}, "bands": bands, "threshold": 10.0,
         "n_scales": 3, "base_sigma": 1.2, "spacing": 2 ** (1 / 3),
         "use_kernel": True}] * 2,
        f"{MATCH}:top2_l2": [{"da": {"shape": [2, 64, 128], "device": "cuda"},
                              "db": {"shape": [2, 80, 128], "device": "cuda"},
                              "use_kernel": True}]}
    counters = {f"{DOH}:LAUNCHES": 2, f"{MATCH}:TOP2_LAUNCHES": 1,
                f"{MATCH}:LAUNCHES": 1}
    return data, calls, counters, bands


def run_data(with_trace=True):
    projects = [{"frames": 10, "wall": 0.5 + 0.01 * k, "t_register": 0.2,
                 "t_compose": 0.1} for k in range(20)]
    data, calls, counters, _ = trace()
    return RunData(12.5, 100.0, 110.0, projects,
                   data if with_trace else None, calls, counters)


def test_end_to_end_readers():
    run = run_data(False)
    assert reader("frames_per_s").read(run) == pytest.approx(200 / 10.0)
    assert reader("setup_s").read(run) == 12.5
    # nearest rank: the 18th of 20 walls
    assert reader("seq_p90_s").read(run) == pytest.approx(0.5 + 0.17)


def test_layer_readers():
    run = run_data()
    assert reader("register.s_per_frame").read(run) == pytest.approx(0.02)
    assert reader("compose.s_per_frame").read(run) == pytest.approx(0.01)
    assert reader("ingest.s_per_frame").read(run) == pytest.approx(
        sum(0.5 + 0.01 * k - 0.3 for k in range(20)) / 200)
    # busy: 4 K1 intervals 100 us, K5 50 us, the lone matcher 40 us, the
    # copy clipped to 100 us of the 1 ms window
    assert reader("device.idle_share").read(run) == pytest.approx(71.0)
    assert reader("device.idle_share").read(run_data(False)) is None


def test_roofline_readers():
    run = run_data()
    _, _, _, bands = trace()
    k1 = 2 * roofline.doh_select_bound_s(bands, 3, 1.2, 2 ** (1 / 3))
    assert reader("doh_select_roofline").read(run) == pytest.approx(
        100 * k1 / 100e-6)
    k5 = roofline.top2_l2_bound_s(2, 64, 80, 128)
    # only the matcher kernels inside K5's annotation on the device count
    assert reader("top2_l2_roofline").read(run) == pytest.approx(
        100 * k5 / 50e-6)
    run.counters[f"{DOH}:LAUNCHES"] = 3
    with pytest.raises(RuntimeError, match="launches"):
        reader("doh_select_roofline").read(run)
    assert reader("doh_select_roofline").read(run_data(False)) is None


def test_trace_gaps_and_breakdown():
    data, *_ = trace()
    assert data.window == (0, 1_000_000)
    assert data.device_annotations[PREFIX + "top2_l2"] == [(520_000,
                                                            570_000)]
    gaps = data.gaps()
    assert gaps[0] == (250_000, 520_000)
    assert data.host_doing(gaps[0]) == "register: aten::sort"
    # an operator covering under half of a gap does not name it
    assert data.host_doing((740_000, 900_000)) == "window: python"
    b = data.breakdown()
    assert b["device_ops"][0][0].startswith("Memcpy HtoD")
    assert b["device_ops"][0][1] == pytest.approx(100e-6)
    assert len(b["idle_gaps"]) <= 10
