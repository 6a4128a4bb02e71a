"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``configs/<config>.json`` (the ``file`` of its entry);
- a traffic mix: ``cells/<traffic>.json``;
- a cell's correctness limits: ``checks/<workload>.json``;
- a per-layer metric: ``metrics/<metric>.py``, defining ``read(run)`` and,
  optionally, ``WRAP`` (program functions whose calls it reads) and
  ``COUNTERS`` (program launch counters it reads);
- the reference's fusion of one overlap, for a configuration's
  ``stitch_config.fuse_method``: ``fusers/<fuse_method>.py``, defining
  ``fuse(before, after, drow, dcol, color, dtype)`` as ``reference.fade``.

A later cell, configuration, fuse method or metric is added by adding its
files and its entries in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "stitchbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load(self.bench_dir / "cells" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return _load(self.bench_dir / "checks" / f"{workload}.json")["limits"]

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics read in this cell: those listing it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]

    def reader(self, metric: str):
        return load_reader(self.bench_dir / "metrics" / f"{metric}.py")

    def fuser(self, method: str):
        """``fusers/<method>.py``'s ``fuse``; a KeyError naming the method
        where there is no such file."""
        path = fuser_file(self.bench_dir, method)
        if path is None:
            raise KeyError(f"no fuser for fuse_method {method!r}: "
                           f"stitchbench/fusers/{method}.py is missing")
        return load_reader(path, "stitchbench_fuser_").fuse


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def fuser_file(bench_dir: Path, method: str) -> Optional[Path]:
    """``fusers/<method>.py`` under ``bench_dir``; None where ``method`` is
    not a name or the file is not there."""
    path = bench_dir / "fusers" / f"{method}.py"
    return path if NAME.match(method) and path.is_file() else None


def load_reader(path: Path, prefix: str = "stitchbench_metric_"):
    """Import a metric's reader (or a fuser) module from its file."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(data: dict, root: Optional[Path] = None) -> List[str]:
    """What in a BENCHMARK.json breaks the benchmark's naming and layout
    rules (an empty list when nothing does)."""
    out = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(data) != keys:
        out.append(f"top-level keys {sorted(data)}")
    names: Dict[str, set] = {"configs": set(), "workloads": set(),
                             "metrics": set()}
    for c in data.get("configs", []):
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config keys {sorted(c)}")
        _name(out, c["name"], names["configs"])
        for k in c["reduced"]:
            if not NAME.match(k):
                out.append(f"reduced key {k!r}")
        _line(out, c["source"])
        _line(out, c["why"])
        if root is not None and not (root / c["file"]).is_file():
            out.append(f"missing {c['file']}")
        elif root is not None:
            method = _load(root / c["file"])["stitch_config"]["fuse_method"]
            if fuser_file(root / "stitchbench", method) is None:
                out.append(f"{c['name']}: no fuser for fuse_method "
                           f"{method!r}")
    pairs = set()
    for w in data.get("workloads", []):
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload keys {sorted(w)}")
        _name(out, w["name"], names["workloads"])
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                out.append(f"{k} {w[k]!r}")
        if w["config"] not in names["configs"]:
            out.append(f"{w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"{w['name']}: repeated config and traffic")
        pairs.add((w["config"], w["traffic"]))
        _line(out, w["why"])
        if root is not None:
            for p in (root / "stitchbench" / "cells" / f"{w['traffic']}.json",
                      root / "stitchbench" / "checks" / f"{w['name']}.json"):
                if not p.is_file():
                    out.append(f"missing {p.relative_to(root)}")
    used = {w["config"] for w in data.get("workloads", [])}
    if used != names["configs"]:
        out.append(f"configs used {sorted(used)}")
    for kind in ("end_to_end", "per_layer"):
        for m in data.get(kind, []):
            base = {"name", "unit", "better", "source"}
            base |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            if not base <= set(m) <= base | {"workloads"}:
                out.append(f"{m.get('name')}: keys {sorted(m)}")
            _name(out, m["name"], names["metrics"])
            if not UNIT.match(m["unit"]):
                out.append(f"{m['name']}: unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"{m['name']}: better {m['better']!r}")
            for wl in m.get("workloads", []):
                if wl not in names["workloads"]:
                    out.append(f"{m['name']}: unknown cell {wl}")
            if kind == "per_layer":
                _line(out, m["layer"])
                if root is not None and not (
                        root / "stitchbench" / "metrics"
                        / f"{m['name']}.py").is_file():
                    out.append(f"{m['name']}: no reader")
    return out


def _name(out: List[str], name: str, seen: set) -> None:
    if not NAME.match(name):
        out.append(f"name {name!r}")
    if name in seen:
        out.append(f"repeated name {name!r}")
    seen.add(name)


def _line(out: List[str], text: str) -> None:
    if not (1 <= len(text) <= 200) or "\n" in text or "\t" in text:
        out.append(f"text {text[:40]!r}...")
