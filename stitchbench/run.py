"""Run one cell of the benchmark and print its result line.

    python3 -m stitchbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``imagestitch_tpu_torch``.  Set-up
makes the cell's project from the seed on the card (and writes it as JPEG
files under ``$TMPDIR`` when the traffic arrives as files), builds one
``Stitcher`` and stitches the project once to warm up.  The window then
stitches the project again and again, closed loop, through the cell's
entry (``Stitcher.stitch_batch`` for decoded arrays, ``stitch_files`` for
files), each project starting from the direction the one before it left,
and ends with the first project that finishes after ``--seconds``.  Once
it has closed, every project's registration and the sampled projects'
panoramas (and, for files, the frames registration received) are compared
with the plain reference (``judge.py``), which composes by the
configuration's own fuse method (``fusers/<fuse_method>.py``; set-up stops
where there is none) on its color frames or, in gray, on their gray.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs the
window's first ``TRACE_SECONDS`` (whole projects) under ``torch.profiler``
with the per-layer readers' call records and launch counts, and prints the
per-layer metrics, the device's busy and traced seconds and a breakdown;
the readers of host spans read every project of the window.  The last
line of standard output is the result; the numbers compared, each with
its limit, are the last lines of standard error and the last key of the
result.  A run without a CUDA card, with fewer cards
than the cell asks for, or in which JAX or the JAX package was loaded,
exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from stitchbench import judge, manifest, project as projects

#: top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "imagestitch_tpu")
#: a traced run traces the window's projects up to the first that ends
#: after this many seconds (or the whole window, if shorter): its trace,
#: call records and launch counts cover those projects
TRACE_SECONDS = 8.0


def process_start_age() -> Optional[float]:
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None
    return age if 0 <= age < 3600 else None


_T_IMPORT = time.perf_counter()
_AGE_AT_IMPORT = process_start_age()


def seconds_since_start() -> float:
    return (time.perf_counter() - _T_IMPORT) + (_AGE_AT_IMPORT or 0.0)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def stitch_config(cfg: dict):
    """The configuration file's frozen ``StitchConfig`` fields."""
    from imagestitch_tpu_torch import (EnhanceConfig, FeatureConfig,
                                       StitchConfig)
    fields = dict(cfg["stitch_config"])
    fields["features"] = FeatureConfig(**fields["features"])
    fields["enhance"] = EnhanceConfig(**fields["enhance"])
    return StitchConfig(**fields)


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""
    setup_s: float
    window_start: float
    window_end: float
    projects: List[dict]
    trace: object = None
    calls: Dict[str, List[dict]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)


def device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(chips)))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


class Cell:
    """One cell's project, entry and window."""

    def __init__(self, bench: manifest.Manifest, workload: str, seed: int,
                 device: str = "cuda", traffic: Optional[dict] = None,
                 limits: Optional[dict] = None):
        import torch
        from imagestitch_tpu_torch import ImageBatch, Stitcher
        from imagestitch_tpu_torch.io.dataset import bgr_to_gray
        self.torch = torch
        wl = bench.workload(workload)
        self.traffic = traffic or bench.traffic(wl["traffic"])
        self.limits = limits or bench.limits(workload)
        self.device = torch.device(device)
        self.cfg = stitch_config(bench.config(wl["config"]))
        self.fuse = bench.fuser(self.cfg.fuse_method)
        self.file_dir = os.path.join(tempfile.gettempdir(), "stitchbench",
                                     workload)
        self.project = projects.build(self.traffic, seed, self.device,
                                      self.file_dir)
        self.stitcher = Stitcher(self.cfg, device=self.device)
        self._capture = False
        self.captured = None
        if self.project.files is None:
            color = self.project.color
            with ThreadPoolExecutor(8) as pool:
                gray = np.stack(list(pool.map(bgr_to_gray, color)))
            names = [f"frame_{k:03d}" for k in range(len(color))]
            self.batch = ImageBatch(gray=gray, color=color, files=names)
            self.entry = lambda: self.stitcher.stitch_batch(self.batch)
        else:
            inner = self.stitcher.stitch_batch

            def stitch_batch(batch, recs=None):
                if self._capture:
                    self.captured = batch
                return inner(batch, recs)

            self.stitcher.stitch_batch = stitch_batch
            self.entry = lambda: self.stitcher.stitch_files(
                self.project.files)
        self.sync()

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def window(self, seconds: float, sample_rng: np.random.Generator,
               after_project=None):
        """Stitch projects until the first that ends after ``seconds``;
        ``after_project(seconds so far)`` is called after each.  Returns
        (start, end, per-project records, sampled projects)."""
        k = int(self.traffic.get("sample_projects", 1))
        sampled: List[dict] = []
        recs: List[dict] = []
        t0 = time.perf_counter()
        while True:
            j = len(recs) + 1
            slot = len(sampled) if j <= k else int(sample_rng.integers(0, j))
            keep = slot < k
            self._capture = keep
            ts = time.perf_counter()
            results = self.entry()
            te = time.perf_counter()
            self._capture = False
            rep = results[0].report
            recs.append({"frames": self.project.num_frames, "start": ts,
                         "end": te, "wall": te - ts,
                         "t_register": rep.t_register,
                         "t_compose": rep.t_compose,
                         "segments": judge.segments_of(results)})
            if keep:
                entry = {"index": j - 1, "results": results,
                         "batch": self.captured}
                if slot < len(sampled):
                    sampled[slot] = entry
                else:
                    sampled.append(entry)
            self.captured = None
            del results
            if after_project is not None:
                after_project(te - t0)
            if te - t0 >= seconds:
                return t0, te, recs, sampled

    def decoded(self) -> np.ndarray:
        """The project's color frames, or the reference's decode of its
        files."""
        p = self.project
        return p.color if p.files is None else judge.decode_all(p.files)

    def judge(self, recs: List[dict], sampled: List[dict]):
        """The numbers compared, once the window has closed.  Files are
        judged against the reference's own decode of them; panoramas by
        the configuration's fuse, on its color or gray frames."""
        p = self.project
        numbers = {"offset_err_px": max(
            judge.offset_error(r["segments"], p.truth, p.frame_hw)
            for r in recs)}
        decoded = self.decoded()
        frames = judge.configured_frames(decoded, self.cfg.color_mode,
                                         self.device)
        numbers["pano_diff_max"] = max(
            judge.pano_difference(judge.segments_of(s["results"]),
                                  [r.image for r in s["results"]], frames,
                                  self.device, self.fuse)
            for s in sampled)
        if p.files is not None:
            worst = 0
            for s in sampled:
                b = s["batch"]
                worst = max(worst, judge.ingest_difference(
                    decoded, b.color, b.gray, self.device,
                    color=self.cfg.color_mode))
            numbers["ingest_diff_max"] = worst
        failed = sum(judge.offset_error(r["segments"], p.truth, p.frame_hw)
                     > self.limits["offset_err_px"] for r in recs)
        return numbers, int(failed)

    def close(self):
        if self.project.files is not None:
            import shutil
            shutil.rmtree(self.file_dir, ignore_errors=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: Optional[manifest.Manifest] = None,
             traffic: Optional[dict] = None, limits: Optional[dict] = None
             ) -> dict:
    """One run; returns the result line's object.  ``device="cpu"`` (tests)
    skips the look for a card."""
    import torch
    bench = bench or manifest.Manifest()
    wl = bench.workload(workload)
    if device != "cpu":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            raise SystemExit(
                f"stitchbench: {workload} needs {wl['chips']} CUDA card(s); "
                f"cuda available={torch.cuda.is_available()}")
    metric_defs = (bench.per_layer(workload) if trace
                   else bench.end_to_end(workload))
    readers = {m["name"]: bench.reader(m["name"]) for m in metric_defs}
    stamps = {"import": seconds_since_start()}
    cell = Cell(bench, workload, seed, device, traffic, limits)
    stamps["project"] = seconds_since_start()
    try:
        cell.entry()                                  # warm-up project
        cell.sync()
        stamps["warm_up"] = seconds_since_start()
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(cell.device)
        setup_s = seconds_since_start()
        sample_rng = projects.host_rng(seed, 2)
        run = None
        if trace:
            from stitchbench.recorders import Recorder, Spans
            from stitchbench.trace import Tracer
            wrap = [t for r in readers.values()
                    for t in getattr(r, "WRAP", [])]
            counters = [c for r in readers.values()
                        for c in getattr(r, "COUNTERS", [])]
            traced = contextlib.ExitStack()
            rec = traced.enter_context(Recorder(wrap, counters))
            tracer = traced.enter_context(Tracer())

            def after_project(elapsed):
                if elapsed >= min(seconds, TRACE_SECONDS):
                    traced.close()

            with Spans(cell.stitcher), traced:
                t0, t1, recs, sampled = cell.window(seconds, sample_rng,
                                                    after_project)
            run = RunData(setup_s, t0, t1, recs, tracer.data,
                          dict(rec.calls), rec.counters)
        else:
            t0, t1, recs, sampled = cell.window(seconds, sample_rng)
            run = RunData(setup_s, t0, t1, recs)
        dev = device_info(torch, cell.device, wl["chips"])
        cell.stitcher = cell.entry = cell.batch = None
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        stamps["window"] = seconds_since_start()
        numbers, failed = cell.judge(recs, sampled)
        del sampled
        stamps["judge"] = seconds_since_start()
    finally:
        cell.close()
    correct, checks = judge.verdict(numbers, cell.limits)
    metrics = {}
    for m in metric_defs:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(recs), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    print("stitchbench: seconds since start at the end of " + ", ".join(
        f"{k} {v:.2f}" for k, v in stamps.items()), file=sys.stderr)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"stitchbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
