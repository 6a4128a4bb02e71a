"""Gray multiband as the benchmark runs and judges it, on the CPU.

The port's ``compose`` with ``multiBandBlending`` against the benchmark's
plain reference (``stitchbench/fusers/multiBandBlending.py``) on seeded
random gray frames, within the limit that ``stitchbench/checks/
dendritic_multiband.frames89.json`` sets; the reference's bfloat16 route
above it.  The reference imports nothing of either package.  The
multiband spans and counter move on a multiband compose and only there,
and leave the panorama's bits alone; the resize's bands stay cached over a
project's shapes."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from imagestitch_tpu_torch import StitchConfig
from imagestitch_tpu_torch.core import compose as tcompose
from imagestitch_tpu_torch.ops.fusion import pyramid as tpyr
from imagestitch_tpu_torch.utils import profiling
from stitchbench import judge, manifest, reference

ROOT = Path(__file__).resolve().parents[1]
CELL = "dendritic_multiband.frames89"
MULTIBAND = StitchConfig(color_mode=False, fuse_method="multiBandBlending")
#: (frame shape, offsets): overlaps down a column, across a row, and of odd
#: sizes both ways; every layout has a rect whose pyramid has an odd level
LAYOUTS = {
    "vertical": ((150, 200), [(118, 2), (121, -3)]),
    "horizontal": ((150, 200), [(1, 162), (-2, 157)]),
    "odd": ((151, 203), [(113, 3), (2, 165), (-117, -1)]),
}
SPANS = ("COMPOSE_MULTIBAND_NS", "COMPOSE_MULTIBAND_RESIZE_NS",
         "COMPOSE_MULTIBAND_RESIZES")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(name, seed=5):
    (h, w), offsets = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (len(offsets) + 1, h, w), np.uint8), offsets


def _counters():
    return {k: getattr(profiling, k) for k in SPANS}


def _moved(before):
    return {k: getattr(profiling, k) - v for k, v in before.items()}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_port_within_the_cells_limit_and_bfloat16_above(name):
    frames, offsets = _frames(name)
    bench = manifest.Manifest(ROOT)
    limit = bench.limits(CELL)["pano_diff_max"]
    fuse = bench.fuser("multiBandBlending")
    before = _counters()
    pano = tcompose.compose(frames, offsets, MULTIBAND, device="cpu")
    assert _moved(before)["COMPOSE_MULTIBAND_RESIZES"] > 0
    segments = [((0, len(frames)), offsets)]
    assert judge.pano_difference(segments, [pano], frames, "cpu",
                                 fuse) <= limit
    ctrl = reference.compose(frames, offsets, dtype="bfloat16", fuse=fuse)
    assert judge.pano_difference(segments, [ctrl], frames, "cpu",
                                 fuse) > limit


def test_the_reference_fuser_loads_neither_package():
    code = ("import sys; from stitchbench import manifest; "
            "manifest.Manifest().fuser('multiBandBlending'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'imagestitch_tpu', 'imagestitch_tpu_torch', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_fuser_refuses_color():
    fuse = manifest.Manifest(ROOT).fuser("multiBandBlending")
    a = torch.zeros((8, 8, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="gray"):
        fuse(a, a, 0, 4, True)


@pytest.mark.parametrize("method", ["multiBandBlending",
                                    "fadeInAndFadeOut"])
def test_multiband_spans_move_there_only_and_keep_the_bits(method):
    frames, offsets = _frames("odd", seed=9)
    cfg = StitchConfig(color_mode=False, fuse_method=method)
    before = _counters()
    plain = tcompose.compose(frames, offsets, cfg, device="cpu")
    moved = _moved(before)
    if method == "multiBandBlending":
        assert all(v > 0 for v in moved.values()), moved
        assert moved["COMPOSE_MULTIBAND_NS"] >= \
            moved["COMPOSE_MULTIBAND_RESIZE_NS"]
    else:
        assert not any(moved.values()), moved
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        traced = tcompose.compose(frames, offsets, cfg, device="cpu")
    assert np.array_equal(traced, plain)
    names = {e.key for e in prof.key_averages()}
    marked = {profiling.PREFIX + "compose.multiband",
              profiling.PREFIX + "compose.multiband.resize"}
    assert (marked <= names) == (method == "multiBandBlending")


def test_resize_bands_stay_cached_over_a_projects_shapes():
    """The dendritic grid's 87 rects make 67 resize bands; a cache smaller
    than a project's shapes copied every band to the card again on each
    project, and each copy waits for the card's queue.  Here 70 rects of
    odd heights make more than 64: a second pass over them builds none."""
    rng = np.random.default_rng(3)
    rects = [torch.from_numpy(rng.integers(0, 256, (2, h, 12), np.int32))
             for h in range(21, 160, 2)]
    tpyr._band.cache_clear()
    for r in rects:
        tpyr.fuse_multiband(r[0], r[1])
    built = tpyr._band.cache_info().misses
    assert built > 64
    for r in rects:
        tpyr.fuse_multiband(r[0], r[1])
    assert tpyr._band.cache_info().misses == built


def test_the_manifest_has_no_problems():
    with open(ROOT / "BENCHMARK.json") as f:
        data = json.load(f)
    assert manifest.problems(data, ROOT) == []
    bench = manifest.Manifest(ROOT)
    assert [m["name"] for m in bench.per_layer(CELL)] == [
        "compose.multiband.s_per_frame",
        "compose.multiband.resize.s_per_frame",
        "compose.multiband.resizes_per_frame",
        "upload.stage_reuse_share"]
    cfg = bench.config("dendritic_multiband")["stitch_config"]
    assert (cfg["color_mode"], cfg["fuse_method"]) == (
        False, "multiBandBlending")
