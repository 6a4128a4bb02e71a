"""The readers of the program's own spans and counters
(``stitchbench/program_counters.py``): each on a made-up run, and on a
traced CPU run of the tiny grid."""
import json

import pytest

from stitchbench import manifest, program_counters, run
from stitchbench.run import RunData

from conftest import ROOT

PROGRAM = program_counters.PROGRAM
#: each reader of a span or counter, the counter it reads
READERS = {
    "ingest.decode.s_per_frame": "INGEST_DECODE_NS",
    "ingest.gray.s_per_frame": "INGEST_GRAY_NS",
    "ingest.wait.s_per_frame": "INGEST_WAIT_NS",
    "ingest.upload.s_per_frame": "INGEST_UPLOAD_NS",
    "ingest.concat.s_per_frame": "INGEST_CONCAT_NS",
    "register.upload.s_per_frame": "REGISTER_UPLOAD_NS",
    "register.pool.s_per_frame": "REGISTER_POOL_NS",
    "register.match.s_per_frame": "REGISTER_MATCH_NS",
    "register.fallback.s_per_frame": "REGISTER_FALLBACK_NS",
    "register.dispatches_per_frame": "REGISTER_DISPATCHES",
    "compose.upload.s_per_frame": "COMPOSE_UPLOAD_NS",
    "compose.fuse.s_per_frame": "COMPOSE_FUSE_NS",
    "compose.readback.s_per_frame": "COMPOSE_READBACK_NS",
}
#: a seed whose tiny grid the port registers soundly on the CPU
SEED = 32


def reader(name):
    return manifest.Manifest(ROOT).reader(name)


def _run(counters):
    return RunData(10.0, 0.0, 1.0, [], None, {}, counters)


def test_each_reader_on_made_up_counters():
    """A counter's difference over FRAMES's, in seconds (or a count) a
    frame; None with no frame stitched or no such counter."""
    with open(ROOT / "BENCHMARK.json") as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    for k, (name, counter) in enumerate(sorted(READERS.items())):
        mod = reader(name)
        assert mod.COUNTERS == [f"{PROGRAM}:{counter}",
                                program_counters.FRAMES]
        value = 3_000_000 * (k + 1)
        got = mod.read(_run({f"{PROGRAM}:{counter}": value,
                             program_counters.FRAMES: 89 * 6}))
        scale = 1 if counter == "REGISTER_DISPATCHES" else 1e-9
        assert got == pytest.approx(value * scale / (89 * 6))
        assert mod.read(_run({f"{PROGRAM}:{counter}": value,
                              program_counters.FRAMES: 0})) is None
        assert mod.read(_run({})) is None
        e = entries[name]
        assert e["moves"] == "frames_per_s" and e["better"] == "lower"
        assert e["source"] == ("program_counter"
                               if counter == "REGISTER_DISPATCHES"
                               else "program_span")


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    """The parent of the spans has neither counter: the reader asks the
    Recorder for none, and reads as no value."""
    assert program_counters.counters("NO_SUCH_NS") == []
    import imagestitch_tpu_torch.utils.profiling as prof
    monkeypatch.delattr(prof, "FRAMES")
    assert program_counters.counters("COMPOSE_FUSE_NS") == []
    assert program_counters.per_frame(_run({}), "COMPOSE_FUSE_NS") is None


@pytest.mark.parametrize("workload", ["dendritic.frames89",
                                      "dendritic.files89"])
def test_traced_cpu_run_prints_the_cells_metrics(tiny, workload, tmp_path,
                                                 monkeypatch):
    """A traced run of the tiny grid on the CPU reports every new metric
    its cell lists, none negative, every time a frame's ingest, pool,
    match and composition took above zero."""
    if workload.endswith("files89"):
        tiny.update(arrival="jpeg", jpeg_quality=95)
        monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    out = run.run_cell(workload, SEED, 0.0, True, device="cpu",
                       traffic=tiny)
    listed = {m["name"] for m in manifest.Manifest(ROOT).per_layer(workload)}
    got = {k: v["value"] for k, v in out["metrics"].items() if k in READERS}
    print(workload, json.dumps(got, indent=1))
    assert set(got) == listed & set(READERS)
    assert all(v >= 0 for v in got.values())
    assert all(got[k] > 0 for k in got if k.split(".")[1] in (
        "decode", "gray", "wait", "upload", "concat", "pool", "match",
        "fuse", "readback"))
    assert got["register.dispatches_per_frame"] > 0
