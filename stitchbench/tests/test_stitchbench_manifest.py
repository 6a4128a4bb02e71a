"""BENCHMARK.json against the benchmark's naming and layout rules, and the
files each entry names."""
import json

import pytest

from stitchbench import manifest

from conftest import ROOT


@pytest.fixture(scope="module")
def data():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_manifest_has_no_problems(data):
    assert manifest.problems(data, ROOT) == []


def test_limits_and_sizes(data):
    assert 1 <= data["run_seconds"] <= 51
    assert data["command"][:3] == ["python3", "-m", "stitchbench.run"]
    assert data["paths"] == ["stitchbench"]
    e2e = {m["name"]: m for m in data["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    assert len(json.dumps(data)) < 64 * 1024
    assert sum(w["chips"] == 4 for w in data["workloads"]) <= max(
        1, len(data["workloads"]) // 4)


def test_every_cell_reports_what_it_must(data):
    bench = manifest.Manifest(ROOT)
    for w in data["workloads"]:
        names = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert bench.per_layer(w["name"])
        limits = bench.limits(w["name"])
        assert set(limits) >= {"offset_err_px", "pano_diff_max"}
        cfg = bench.config(w["config"])
        assert cfg["reduced"] == [] and cfg["source"]


def test_bad_names_and_units_are_found(data):
    bad = json.loads(json.dumps(data))
    bad["per_layer"][0]["unit"] = "s per frame"
    bad["workloads"][0]["name"] = "has space"
    bad["end_to_end"][0]["why"] = "no such key"
    found = " ".join(manifest.problems(bad))
    assert "unit" in found and "has space" in found and "keys" in found
