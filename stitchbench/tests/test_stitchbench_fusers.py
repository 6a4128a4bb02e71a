"""Each configuration's panoramas are judged by its own fuse method
(``stitchbench/fusers/<fuse_method>.py``) on its own color or gray frames:
the fade fuser is the reference's fade; a gray configuration reads exact
on its gray and one level off where one pixel is; a color configuration
reads what it read before fusers were found by name; a fuser is found in
the root a manifest reads; a configuration without one stops at set-up."""
import json
import shutil

import numpy as np
import pytest

from imagestitch_tpu_torch import StitchConfig
from imagestitch_tpu_torch.core import compose as port_compose
from stitchbench import control, manifest, project, reference, run

from conftest import ROOT
from test_stitchbench_faults import SEED
from test_stitchbench_reference import LAYOUTS, _frames

#: the numbers the comparison read on the tiny grid at SEED before
#: ``reference.compose`` took its fuse from ``fusers/`` (color, fade)
PARENT_CHECKS = {
    "dendritic.frames89": {"offset_err_px": 0.8233460629850242,
                           "pano_diff_max": 0},
    "dendritic.files89": {"offset_err_px": 0.8233460629850242,
                          "pano_diff_max": 0, "ingest_diff_max": 0},
}
PARENT_CONTROL = {
    "lower": {"offset_err_px": 0.8233460629850242, "pano_diff_max": 0,
              "ingest_diff_max": 0},
    "upper": {"offset_err_px": 0.8233460629850242, "pano_diff_max": 2,
              "ingest_diff_max": 1},
}


class GrayBench(manifest.Manifest):
    """The repository's manifest with every configuration in gray."""

    def config(self, name):
        cfg = super().config(name)
        cfg["stitch_config"]["color_mode"] = False
        return cfg


def _jpeg(tiny):
    tiny.update(arrival="jpeg", jpeg_quality=95)
    return tiny


def _root(tmp_path, fuse_method, fusers):
    """A checkout at ``tmp_path`` whose ``dendritic`` configuration fuses by
    ``fuse_method`` and whose ``stitchbench/fusers/`` holds ``fusers``
    ({file stem: source}); every other file is the repository's."""
    bench = tmp_path / "stitchbench"
    (bench / "configs").mkdir(parents=True)
    (bench / "fusers").mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("cells", "checks", "metrics"):
        (bench / sub).symlink_to(ROOT / "stitchbench" / sub)
    for name in ("dendritic", "zircon_rem"):
        cfg = manifest.Manifest(ROOT).config(name)
        if name == "dendritic":
            cfg["stitch_config"]["fuse_method"] = fuse_method
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for stem, source in fusers.items():
        (bench / "fusers" / f"{stem}.py").write_text(source)
    return tmp_path


FADE = "from stitchbench.reference import fade as fuse\n"
#: notFuse: the frame pasted wins the whole rect
PASTE = "def fuse(before, after, drow, dcol, color, dtype):\n" \
        "    return after.clamp(0, 255).to(__import__('torch').uint8)\n"


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("color", [True, False])
def test_the_fade_fuser_composes_the_ports(tiny, name, color):
    fuse = manifest.Manifest(ROOT).fuser("fadeInAndFadeOut")
    assert fuse is reference.fade
    offsets = LAYOUTS[name]
    frames = _frames(tiny, len(offsets) + 1, color)
    want = port_compose.compose(frames, offsets, StitchConfig(), device="cpu")
    assert np.array_equal(reference.compose(frames, offsets, fuse=fuse),
                          want)


def _pixel_altered(monkeypatch):
    orig = port_compose.compose

    def compose(*a, **k):
        out = orig(*a, **k).copy()
        out[(0,) * out.ndim] ^= 1
        return out

    monkeypatch.setattr(port_compose, "compose", compose)


def test_a_gray_configuration_is_judged_on_its_gray(tiny, monkeypatch):
    bench = GrayBench(ROOT)
    out = run.run_cell("dendritic.frames89", SEED, 0.0, False, device="cpu",
                       bench=bench, traffic=tiny)
    assert out["correct"], out["checks"]
    assert out["checks"]["pano_diff_max"]["value"] == 0
    _pixel_altered(monkeypatch)
    out = run.run_cell("dendritic.frames89", SEED, 0.0, False, device="cpu",
                       bench=bench, traffic=tiny)
    assert not out["correct"]
    assert out["checks"]["pano_diff_max"]["value"] == 1


def test_a_gray_configuration_on_files_compares_the_gray(tiny):
    out = run.run_cell("dendritic.files89", SEED, 0.0, False, device="cpu",
                       bench=GrayBench(ROOT), traffic=_jpeg(tiny))
    assert out["correct"], out["checks"]
    assert out["checks"]["ingest_diff_max"]["value"] == 0


def test_the_gray_control_fails_where_the_program_passes(tiny):
    out = control.readings("dendritic.frames89", [SEED], device="cpu",
                           bench=GrayBench(ROOT), traffic=tiny,
                           emit=lambda line: None)
    limits = manifest.Manifest(ROOT).limits("dendritic.frames89")
    assert out["lower"]["pano_diff_max"] == 0
    assert out["upper"]["pano_diff_max"] > limits["pano_diff_max"]


@pytest.mark.parametrize("workload", sorted(PARENT_CHECKS))
def test_a_color_configuration_reads_as_before(tiny, workload):
    if workload.endswith("files89"):
        _jpeg(tiny)
    out = run.run_cell(workload, SEED, 0.0, False, device="cpu",
                       traffic=tiny)
    assert {k: c["value"] for k, c in out["checks"].items()} == \
        PARENT_CHECKS[workload]


def test_a_color_control_reads_as_before(tiny):
    out = control.readings("dendritic.files89", [SEED], device="cpu",
                           traffic=_jpeg(tiny), emit=lambda line: None)
    assert out == PARENT_CONTROL


def test_a_fuser_is_found_in_the_manifests_root(tmp_path, tiny):
    root = _root(tmp_path, "notFuse",
                 {"notFuse": PASTE, "fadeInAndFadeOut": FADE})
    bench = manifest.Manifest(root)
    assert manifest.problems(bench.data, root) == []
    cell = run.Cell(bench, "dendritic.frames89", SEED, "cpu", tiny)
    assert cell.fuse.__module__ == "stitchbench_fuser_notFuse"
    out = run.run_cell("dendritic.frames89", SEED, 0.0, False, device="cpu",
                       bench=bench, traffic=tiny)
    assert out["correct"], out["checks"]
    # the fade would judge the pasted panoramas wrong
    frames = cell.project.color
    offs = reference.expected_offsets(cell.project.truth)[1:]
    pasted = reference.compose(frames[1:], offs, fuse=cell.fuse)
    assert np.abs(pasted.astype(int) - reference.compose(
        frames[1:], offs).astype(int)).max() > 0


def test_a_missing_fuser_is_named_and_stops_set_up(tmp_path, tiny,
                                                   monkeypatch):
    root = _root(tmp_path, "multiBandBlending", {"fadeInAndFadeOut": FADE})
    bench = manifest.Manifest(root)
    assert manifest.problems(bench.data, root) == [
        "dendritic: no fuser for fuse_method 'multiBandBlending'"]
    assert manifest.problems(bench.data, ROOT) == []

    def build(*a, **k):
        raise AssertionError("the project was built")

    monkeypatch.setattr(project, "build", build)
    with pytest.raises(KeyError, match="multiBandBlending"):
        run.run_cell("dendritic.frames89", SEED, 0.0, False, device="cpu",
                     bench=bench, traffic=tiny)
