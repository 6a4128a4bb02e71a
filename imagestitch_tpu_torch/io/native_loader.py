"""ctypes bridge to the shared C++ host runtime (native/stitch_runtime.cpp).

Port of ``imagestitch_tpu/io/native_loader.py``: a thread-pool libjpeg
batch decoder, the fixed-point BGR -> gray conversion, and the float64 host
fusion kernels of the streamed-output composers (core/stream_out.py).

The port builds its own copy of the runtime: ``g++`` with the JAX
package's Makefile flags (native/Makefile:4-5) into
``imagestitch_tpu_torch/build/libstitch_runtime_<hash>.so``, named by a hash
of the source, the flags and the host CPU (``-march=native`` code runs only
where it was built), through a temporary directory and ``os.replace`` so that
concurrent builders never see a torn file.  It never writes ``native/``.

Nothing builds at import.  ``get_lib()`` builds on first call and returns
None when the build fails (no ``g++`` or no libjpeg headers); callers then
take the same numpy routes as the JAX package does without its runtime.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "stitch_runtime.cpp"
BUILD = _PKG / "build"
#: native/Makefile:4-5.  -ffp-contract=off keeps the float64 blend's
#: multiply and add separate, rounding as numpy does.
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC",
             "-std=c++17", "-shared"]
LD_FLAGS = ["-ljpeg", "-lpthread"]
VERSION = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def library_path() -> Path:
    """Where the runtime for this source, these flags and this CPU lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(f"{platform.machine()} {_cpu_model()}".encode())
    return BUILD / f"libstitch_runtime_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        out = os.path.join(tmp, so.name)
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", out, str(SOURCE),
                            *LD_FLAGS], check=True, capture_output=True,
                           timeout=300)
        except (OSError, subprocess.SubprocessError):
            return False
        os.replace(out, so)
    return True


def _bind(lib: ctypes.CDLL) -> None:
    c_int, c_ll = ctypes.c_int, ctypes.c_longlong
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.isr_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(c_int),
                              ctypes.POINTER(c_int)]
    lib.isr_probe.restype = c_int
    lib.isr_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int,
                                   c_int, u8p, c_int, c_int, c_int]
    lib.isr_load_batch.restype = c_int
    lib.isr_bgr_to_gray.argtypes = [u8p, u8p, c_int, c_int]
    lib.isr_paste.argtypes = [u8p, c_int, c_int, c_int, u8p, c_int, c_int,
                              c_int, c_int]
    lib.isr_blend_rect.argtypes = [i16p, i16p, u8p, c_int, c_int, c_int,
                                   f64p, f64p, f64p, f64p, c_int, c_int]
    lib.isr_paste16.argtypes = [i16p, c_int, c_int, c_int, u8p, c_int, c_int,
                                c_int, c_int, c_int]
    lib.isr_rect_stats.argtypes = [i16p, c_int, c_int, c_int, c_int, c_int,
                                   c_int, i64p, i32p, i32p, i64p]
    lib.isr_fuse_step.argtypes = [i16p, c_int, c_int, c_int, u8p, c_int,
                                  c_int, c_int, c_int, c_int, c_int, c_int,
                                  c_int, f64p, f64p, f64p, f64p, c_int, c_int]
    lib.isr_fill16.argtypes = [i16p, c_ll, ctypes.c_int16, c_int]
    lib.isr_finalize16.argtypes = [i16p, u8p, c_ll, c_int]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded runtime (built on first call), or None if it cannot be
    built or loaded here."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.isr_version.restype = ctypes.c_int
        if lib.isr_version() != VERSION:
            return None
        _bind(lib)
        _lib = lib
        return _lib


def route() -> str:
    """'native' when the runtime loads, else 'numpy'."""
    return "native" if get_lib() is not None else "numpy"


def _is_jpeg(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in (".jpg", ".jpeg")


class NativeLoader:
    """Thread-pool batch decoder with the ``read_all`` protocol of
    io.dataset.load_batch: JPEGs in the runtime's libjpeg pool; anything
    else, or every file when the runtime is absent, through io/codec.py on
    a pool of as many threads (cv2 and PIL decode without the GIL)."""

    def __init__(self, threads: Optional[int] = None):
        self.threads = threads or max(2, os.cpu_count() or 2)

    def read_all(self, files: Sequence[str], color: bool) -> List[np.ndarray]:
        lib = get_lib()
        if lib is None or not all(_is_jpeg(f) for f in files):
            from . import codec
            with ThreadPoolExecutor(min(self.threads, len(files))) as pool:
                return list(pool.map(lambda f: codec.imread(f, color),
                                     files))
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = lib.isr_probe(files[0].encode(), ctypes.byref(h), ctypes.byref(w))
        if rc != 0:
            raise IOError(f"failed to probe {files[0]} (rc={rc})")
        n = len(files)
        shape = (n, h.value, w.value, 3) if color else (n, h.value, w.value)
        out = np.empty(shape, np.uint8)
        arr = (ctypes.c_char_p * n)(*[f.encode() for f in files])
        rc = lib.isr_load_batch(
            arr, n, 1 if color else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h.value, w.value, self.threads)
        if rc != 0:
            raise IOError(f"native decode failed for {files[rc - 1]}")
        return list(out)


def probe_dims(path: str) -> Optional[tuple]:
    """(H, W) of an image: from the JPEG header in the runtime, else from a
    decode through io/codec.py; None when the file cannot be read."""
    lib = get_lib()
    if lib is not None and _is_jpeg(path):
        h, w = ctypes.c_int(), ctypes.c_int()
        if lib.isr_probe(path.encode(), ctypes.byref(h), ctypes.byref(w)) == 0:
            return (h.value, w.value)
    from . import codec
    try:
        return codec.imread(path, False).shape[:2]
    except (OSError, RuntimeError):
        return None


def bgr_to_gray_native(bgr: np.ndarray) -> Optional[np.ndarray]:
    """(H, W, 3) BGR uint8 -> (H, W) gray with cv2's 14-bit fixed point, in
    the runtime; None without it."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = bgr.shape[:2]
    bgr = np.ascontiguousarray(bgr)
    gray = np.empty((h, w), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.isr_bgr_to_gray(bgr.ctypes.data_as(u8p), gray.ctypes.data_as(u8p),
                        h, w)
    return gray
