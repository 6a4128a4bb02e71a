"""The control: the plain reference in the program's place, computed in
bfloat16, fails the comparison where the program passes it.  On the CPU
at the tiny grid; on the card at each cell's own size."""
import pytest

from stitchbench import control, manifest

from conftest import ROOT
from test_stitchbench_faults import SEED


def test_control_fails_where_the_program_passes(tiny):
    tiny.update(arrival="jpeg", jpeg_quality=95)
    lines = []
    out = control.readings("dendritic.files89", [SEED], device="cpu",
                           traffic=tiny, emit=lines.append)
    limits = manifest.Manifest(ROOT).limits("dendritic.files89")
    assert all(out["lower"][k] <= limits[k] for k in limits)
    assert out["upper"]["pano_diff_max"] > limits["pano_diff_max"]
    assert out["upper"]["ingest_diff_max"] > limits["ingest_diff_max"]
    assert len(lines) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dendritic.frames89",
                                      "zircon_rem.frames11",
                                      "dendritic.files89"])
def test_control_at_the_cells_size(card, workload):
    out = control.readings(workload, [4000000001], emit=lambda line: None)
    limits = manifest.Manifest(ROOT).limits(workload)
    assert all(out["lower"][k] <= limits[k] for k in limits)
    assert any(out["upper"][k] > limits[k] for k in limits)
