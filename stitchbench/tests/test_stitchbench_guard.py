"""The JAX guard, and a new cell, traffic mix and metric found by name
without editing any file of the benchmark."""
import json
import shutil
import subprocess
import sys

import pytest

from stitchbench import manifest, run

from conftest import ROOT


def test_guard_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "imagestitch_tpu", "imagestitch_tpu.core.stitcher",
             "imagestitch_tpu_torch", "imagestitch_tpu_torch.core",
             "jaxtyping", "flaxen", "numpy"]
    assert run.forbidden_modules(names) == [
        "flax.linen", "imagestitch_tpu", "imagestitch_tpu.core.stitcher",
        "jax", "jax.numpy", "jaxlib.xla_client"]
    assert run.forbidden_modules(["imagestitch_tpu_torch", "torch"]) == []


def test_the_benchmark_loads_no_jax():
    """Importing the harness and the port, as a run does, loads neither
    JAX nor the JAX package."""
    code = ("import sys, stitchbench.run, stitchbench.control, "
            "stitchbench.trace, stitchbench.recorders; "
            "from stitchbench.run import stitch_config, forbidden_modules; "
            "import imagestitch_tpu_torch.core.stitcher; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    """Without a card a run exits nonzero and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run(
        [sys.executable, "-m", "stitchbench.run", "--workload",
         "zircon_rem.frames11", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_a_new_cell_is_found_by_adding_files(tmp_path):
    shutil.copytree(ROOT / "stitchbench", tmp_path / "stitchbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "stitchbench").rglob("*")
              if p.is_file()}
    # new files only: a traffic mix, its cell's limits, a metric reader
    cells = tmp_path / "stitchbench" / "cells"
    mix = json.loads((cells / "frames11.json").read_text())
    mix.update(name="files11", arrival="jpeg", jpeg_quality=95)
    (cells / "files11.json").write_text(json.dumps(mix))
    (tmp_path / "stitchbench" / "checks" / "zircon_rem.files11.json"
     ).write_text(json.dumps({"limits": {"offset_err_px": 2.0,
                                         "pano_diff_max": 0,
                                         "ingest_diff_max": 0}}))
    (tmp_path / "stitchbench" / "metrics" / "projects.count.py").write_text(
        "def read(run):\n    return len(run.projects)\n")
    data["workloads"].append({"name": "zircon_rem.files11",
                              "config": "zircon_rem", "traffic": "files11",
                              "chips": 1, "why": "JPEG ingest of short lines"})
    data["per_layer"].append({"name": "projects.count", "unit": "projects",
                              "better": "higher", "source": "host_clock",
                              "layer": "core/stitcher",
                              "moves": "frames_per_s",
                              "workloads": ["zircon_rem.files11"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    assert manifest.problems(data, tmp_path) == []
    bench = manifest.Manifest(tmp_path)
    assert bench.traffic(bench.workload("zircon_rem.files11")["traffic"]
                         )["arrival"] == "jpeg"
    assert bench.limits("zircon_rem.files11")["ingest_diff_max"] == 0
    assert [m["name"] for m in bench.per_layer("zircon_rem.files11")][-1] \
        == "projects.count"
    assert bench.reader("projects.count").read(
        run.RunData(0, 0, 1, [{}, {}])) == 2
    for p, b in before.items():
        assert p.read_bytes() == b, p
