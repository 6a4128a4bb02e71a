"""Import hygiene of the port: it never loads jax or the JAX package, and
every module — the kernel wrappers included — imports on a machine with
no nvcc and no GPU; the kernels are built only when one is launched, and
the C++ host runtime only when it is first asked for."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import imagestitch_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from imagestitch_tpu_torch import _build
from imagestitch_tpu_torch.io import native_loader
from imagestitch_tpu_torch.ops.kernels import describe, doh, matcher, window_sum
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "imagestitch_tpu."))
             or m == "imagestitch_tpu")
assert not bad, bad
assert _build._lib is None
assert native_loader._lib is None and not native_loader._tried
assert "imagestitch_tpu_torch.ops.kernels.doh" in names
print("ok", len(names))
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PATH"] = "/usr/bin:/bin"            # no nvcc on the path
    env["CUDA_HOME"] = "/nonexistent"
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_without_jax_or_cuda():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_cpu_tensors_take_the_plain_versions():
    from imagestitch_tpu_torch import _build
    from imagestitch_tpu_torch.ops.kernels import (describe, doh, matcher,
                                                   window_sum)
    counts = lambda: (doh.LAUNCHES, doh.SCORE_MAP_LAUNCHES,
                      describe.LAUNCHES, matcher.LAUNCHES,
                      matcher.TOP2_LAUNCHES, window_sum.LAUNCHES)
    before = counts()
    img = torch.rand(64, 80) * 255
    doh.doh_select(img, r_cands=2, use_kernel=True)
    doh.doh_score_map(img, use_kernel=True)
    describe.describe_atlas(img, torch.zeros(3, dtype=torch.int32),
                            torch.zeros(3, dtype=torch.int32))
    d = torch.rand(1, 8, 32)
    valid = torch.ones(1, 8, dtype=torch.bool)
    matcher.top2_l2_coords(d, d, valid, torch.zeros(1, 8), torch.zeros(1, 8))
    matcher.top2_l2(d, d, valid, use_kernel=True)
    window_sum.window_colsum(img, torch.zeros(3, dtype=torch.int32),
                             torch.zeros(3, dtype=torch.int32), rows=24,
                             cols=32, use_kernel=True)
    assert counts() == before
    assert _build._lib is None


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """chip_smoke.py outside the repo (or without a GPU) exits nonzero and
    prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _clean_env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
