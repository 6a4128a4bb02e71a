"""The reader of ``compose.readback.reuse_share``: the share of the
panoramas read back from a card that landed in a page-locked block made
for an earlier one, from the program's ``COMPOSE_READBACKS`` and
``COMPOSE_READBACK_REUSED``."""
import json

import pytest

from stitchbench import manifest, program_counters
from stitchbench.run import RunData

from conftest import ROOT

NAME = "compose.readback.reuse_share"
PROGRAM = program_counters.PROGRAM
READBACKS = f"{PROGRAM}:COMPOSE_READBACKS"
REUSED = f"{PROGRAM}:COMPOSE_READBACK_REUSED"


def _run(counters):
    return RunData(10.0, 0.0, 1.0, [], None, {}, counters)


@pytest.mark.parametrize("readbacks,reused", [(12, 11), (61, 59), (2, 1),
                                              (5, 0)])
def test_share_of_reused_readbacks(readbacks, reused):
    """100 x reused / readbacks; no value without a readback or without
    the counters in the run."""
    mod = manifest.Manifest(ROOT).reader(NAME)
    assert mod.COUNTERS == [READBACKS, REUSED]
    got = mod.read(_run({READBACKS: readbacks, REUSED: reused}))
    assert got == pytest.approx(100.0 * reused / readbacks)
    assert mod.read(_run({READBACKS: 0, REUSED: 0})) is None
    assert mod.read(_run({})) is None


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    """The parent of the counters has neither: the reader asks the
    Recorder for none, and reads as no value."""
    import imagestitch_tpu_torch.utils.profiling as prof
    monkeypatch.delattr(prof, "COMPOSE_READBACK_REUSED")
    mod = manifest.Manifest(ROOT).reader(NAME)
    assert mod.COUNTERS == []
    assert mod.read(_run({})) is None


def test_entry_in_the_manifest():
    """The entry keeps the benchmark's rules and lists every cell, each of
    which reports the metric it moves."""
    with open(ROOT / "BENCHMARK.json") as f:
        data = json.load(f)
    assert manifest.problems(data, ROOT) == []
    entry = data["per_layer"][-1]
    assert entry == {"name": NAME, "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "core/compose",
                     "moves": "frames_per_s",
                     "workloads": [w["name"] for w in data["workloads"]]}
    bench = manifest.Manifest(ROOT)
    for w in entry["workloads"]:
        assert "frames_per_s" in {m["name"] for m in bench.end_to_end(w)}
        assert NAME in {m["name"] for m in bench.per_layer(w)}
