"""The reader of ``ingest.gray.card_share``: the share of the color
frames whose gray the pipelined ingest made on a device, from the
program's ``INGEST_GRAY_FRAMES`` and ``INGEST_GRAY_CARD``."""
import json

import pytest

from stitchbench import manifest, program_counters
from stitchbench.run import RunData

from conftest import ROOT

NAME = "ingest.gray.card_share"
PROGRAM = program_counters.PROGRAM
FRAMES = f"{PROGRAM}:INGEST_GRAY_FRAMES"
CARD = f"{PROGRAM}:INGEST_GRAY_CARD"
CELLS = ["dendritic.files89", "zircon_rem.files11"]


def _run(counters):
    return RunData(10.0, 0.0, 1.0, [], None, {}, counters)


@pytest.mark.parametrize("frames,card", [(89, 89), (22, 22), (11, 0),
                                         (16, 4)])
def test_share_of_grays_made_on_the_card(frames, card):
    """100 x card / frames; no value without a gray made or without the
    counters in the run."""
    mod = manifest.Manifest(ROOT).reader(NAME)
    assert mod.COUNTERS == [FRAMES, CARD]
    got = mod.read(_run({FRAMES: frames, CARD: card}))
    assert got == pytest.approx(100.0 * card / frames)
    assert mod.read(_run({FRAMES: 0, CARD: 0})) is None
    assert mod.read(_run({})) is None


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    """The parent of the counters has neither: the reader asks the
    Recorder for none, and reads as no value."""
    import imagestitch_tpu_torch.utils.profiling as prof
    monkeypatch.delattr(prof, "INGEST_GRAY_CARD")
    mod = manifest.Manifest(ROOT).reader(NAME)
    assert mod.COUNTERS == []
    assert mod.read(_run({})) is None


def test_entry_in_the_manifest():
    """The entry keeps the benchmark's rules and lists the two files
    cells, each of which reports the metric it moves."""
    with open(ROOT / "BENCHMARK.json") as f:
        data = json.load(f)
    assert manifest.problems(data, ROOT) == []
    (entry,) = [m for m in data["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "io",
                     "moves": "frames_per_s", "workloads": CELLS}
    bench = manifest.Manifest(ROOT)
    for w in CELLS:
        assert "frames_per_s" in {m["name"] for m in bench.end_to_end(w)}
        assert NAME in {m["name"] for m in bench.per_layer(w)}
