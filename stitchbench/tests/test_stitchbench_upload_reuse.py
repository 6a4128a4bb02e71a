"""The reader of ``upload.stage_reuse_share``: the share of the chunks of
host frames sent to a card that went through a page-locked staging block
an earlier chunk had used, from the program's ``UPLOAD_CHUNKS`` and
``UPLOAD_CHUNKS_REUSED``."""
import json

import pytest

from stitchbench import manifest, program_counters
from stitchbench.run import RunData

from conftest import ROOT

NAME = "upload.stage_reuse_share"
PROGRAM = program_counters.PROGRAM
CHUNKS = f"{PROGRAM}:UPLOAD_CHUNKS"
REUSED = f"{PROGRAM}:UPLOAD_CHUNKS_REUSED"
CELLS = ["dendritic.frames89", "zircon_rem.frames11",
         "dendritic_multiband.frames89", "dendritic.files89",
         "zircon_rem.files11"]


def _run(counters):
    return RunData(10.0, 0.0, 1.0, [], None, {}, counters)


@pytest.mark.parametrize("chunks,reused", [(1140, 1140), (1140, 1136),
                                           (3, 1), (4, 0)])
def test_share_of_reused_chunks(chunks, reused):
    """100 x reused / chunks; no value without a chunk or without the
    counters in the run."""
    mod = manifest.Manifest(ROOT).reader(NAME)
    assert mod.COUNTERS == [CHUNKS, REUSED]
    got = mod.read(_run({CHUNKS: chunks, REUSED: reused}))
    assert got == pytest.approx(100.0 * reused / chunks)
    assert mod.read(_run({CHUNKS: 0, REUSED: 0})) is None
    assert mod.read(_run({})) is None


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    """The parent of the counters has neither: the reader asks the
    Recorder for none, and reads as no value."""
    import imagestitch_tpu_torch.utils.profiling as prof
    monkeypatch.delattr(prof, "UPLOAD_CHUNKS_REUSED")
    mod = manifest.Manifest(ROOT).reader(NAME)
    assert mod.COUNTERS == []
    assert mod.read(_run({})) is None


def test_entry_in_the_manifest():
    """The entry keeps the benchmark's rules and lists the cells whose
    projects send host frames to the card, each of which reports the
    metric it moves."""
    with open(ROOT / "BENCHMARK.json") as f:
        data = json.load(f)
    assert manifest.problems(data, ROOT) == []
    (entry,) = [m for m in data["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "core/stitcher",
                     "moves": "frames_per_s", "workloads": CELLS}
    bench = manifest.Manifest(ROOT)
    for w in CELLS:
        assert "frames_per_s" in {m["name"] for m in bench.end_to_end(w)}
        assert NAME in {m["name"] for m in bench.per_layer(w)}
