"""Build and load the port's CUDA kernels.

The kernels under ``csrc/*.cu`` expose a plain C interface.  At first use
they are compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared
library under ``build/``, named by a hash of the sources and of the headers
they include (``csrc/*.cuh``), and loaded with ``ctypes`` — no PyTorch
headers are compiled, and the sources compile in parallel, which keeps the
build to seconds.  A library whose
name matches the current sources is reused.

Nothing here runs at import: the package imports on a machine without
``nvcc`` or a GPU, and only a kernel launch asks for the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_longlong
#: C signature of every exported launcher (all return cudaGetLastError())
SIGNATURES = {
    # atlas, pitch, n_oct, bands*, threshold, n_scales, radii*, s4*, taps*,
    # sc, col, dr, dc, scratch, scratch_entries, stream
    "doh_select_launch": [P, I, I, P, F, I, P, P, P, P, P, P, P, P, I, P],
    # atlas, pitch, n_bands, bands*, threshold, n_scales, radii*, s4*,
    # taps*, raw, score (null: compact), keys, key_capacity, counts, stream
    "doh_score_map_launch": [P, I, I, P, F, I, P, P, P, P, P, P, L, P, P],
    # atlas, ah, aw, r0, c0, k, gw, extended, out, stream
    "describe_launch": [P, I, I, P, P, I, P, I, P, P],
    # da, db, valid_b, rows_b, cols_b, batch, ka, kb, d, splits, scratch,
    # d0, i0, d1, rb_sel, cb_sel, stream
    "matcher_launch": [P, P, P, P, P, I, I, I, I, I, P, P, P, P, P, P, P],
    # da, db, valid_b, batch, ka, kb, d, splits, scratch, d0, i0, d1, stream
    "matcher_top2_launch": [P, P, P, I, I, I, I, I, P, P, P, P, P],
    # atlas, ah, aw, r0, ca, k, rows, cols, out, stream
    "window_colsum_launch": [P, I, I, P, P, I, I, I, P, P],
}

_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when a cached library was loaded)
last_build_seconds = 0.0


def sources():
    """The translation units nvcc compiles."""
    return sorted(CSRC.glob("*.cu"))


def headers():
    """The shared device code the sources include (hashed, not compiled)."""
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sources() + headers():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _run(procs, what: str) -> None:
    """Wait for every nvcc process; raise with the output of a failed one."""
    failed = []
    for name, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError(f"nvcc {what} failed: " + "\n".join(failed))


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/libimagestitch_<hash>.so``: one
    nvcc per source, all started together, then one link."""
    global last_build_seconds
    so = BUILD / f"libimagestitch_{source_hash()}.so"
    if so.exists():
        last_build_seconds = 0.0
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs = [os.path.join(tmp, f.stem + ".o") for f in sources()]
        _run([(f.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(f), "-o", o],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
              for f, o in zip(sources(), objs)], "compile")
        lib = os.path.join(tmp, so.name)
        _run([("link", subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))],
             "link")
        os.replace(lib, so)
    last_build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
