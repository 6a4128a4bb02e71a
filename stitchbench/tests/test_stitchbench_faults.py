"""A run on the CPU, the look for a card skipped, with the timed path
broken underneath: each fault the cells can have turns ``correct`` false.
(There is no exchange between chips to leave out: every cell takes one.)"""
import dataclasses

import numpy as np
import pytest

from imagestitch_tpu_torch.core import compose as port_compose
from imagestitch_tpu_torch.core import registration as port_reg
from imagestitch_tpu_torch.io import dataset as port_dataset
from stitchbench import run

#: a seed whose tiny grid the port registers soundly on the CPU
SEED = 32


def _run(tiny, workload="dendritic.frames89"):
    return run.run_cell(workload, SEED, 0.0, False, device="cpu",
                        traffic=tiny)


def _alter_answer(orig):
    def registrar(*a, **k):
        recs = list(orig(*a, **k))
        r = recs[2]
        recs[2] = dataclasses.replace(r, offset=(r.offset[0] + 5,
                                                 r.offset[1]))
        return recs
    return registrar


def _compose_fault(orig, kind):
    def compose(images, offsets, cfg, *a, **k):
        if kind == "half_left_out":
            n = images.shape[0] // 2 + 1
            return orig(images[:n], offsets[:n - 1], cfg, *a, **k)
        out = orig(images, offsets, cfg, *a, **k)
        if kind == "state_unchanged":
            return np.zeros_like(out)
        out = out.copy()
        out[0, 0, 0] ^= 1
        return out
    return compose


def test_sound_run_is_correct(tiny):
    out = _run(tiny)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["answer_altered", "pixel_altered",
                                   "half_left_out", "state_unchanged"])
def test_a_fault_is_not_correct(tiny, monkeypatch, fault):
    if fault == "answer_altered":
        monkeypatch.setattr(port_reg, "register_sequence_features_incre",
                            _alter_answer(
                                port_reg.register_sequence_features_incre))
    else:
        monkeypatch.setattr(port_compose, "compose",
                            _compose_fault(port_compose.compose, fault))
    out = _run(tiny)
    assert not out["correct"], out["checks"]


def test_an_ingest_fault_is_not_correct(tiny, monkeypatch):
    tiny.update(arrival="jpeg", jpeg_quality=95)
    assert _run(tiny, "dendritic.files89")["correct"]
    orig = port_dataset.bgr_to_gray

    def gray(bgr):
        g = orig(bgr).copy()
        g[0, 0] ^= 1
        return g

    monkeypatch.setattr(port_dataset, "bgr_to_gray", gray)
    out = _run(tiny, "dendritic.files89")
    assert not out["correct"]
    assert out["checks"]["ingest_diff_max"]["value"] >= 1
