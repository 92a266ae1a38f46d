"""Build and load the CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``build/`` inside the package (listed in
``.gitignore``), and is redone whenever a source's content changes: the
library's file name carries a hash of the sources.

Usage::

    from cpu_ray_tracing_implementation_tpu_torch.kernels import build
    lib = build.load()          # builds on first call
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
SOURCES = ("closest_hit.cu",)
# multiply-add contraction stays on; a kernel that must round like its plain
# version says so in its source (K2's sphere quadratic, csrc/closest_hit.cu)
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build did: {"seconds": float, "cached": bool, "log": str}
last_build: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcrt_kernels_{source_hash()}.so"


def compile_library() -> Path:
    """Compile the sources if the library for their hash is missing."""
    path = library_path()
    if path.exists():
        last_build.update(seconds=0.0, cached=True, log="")
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", tmp] + [str(CSRC / s) for s in SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    last_build.update(seconds=seconds, cached=False,
                      log=proc.stdout + proc.stderr)
    return path


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(compile_library()))
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.crt_planar_closest.argtypes = [ptr, i32, ptr, i32, i32, f32,
                                               f32, i32, ptr, ptr]
            lib.crt_planar_closest.restype = i32
            lib.crt_sphere_closest.argtypes = [ptr, i32, ptr, i32, i32, f32,
                                               f32, ptr, ptr]
            lib.crt_sphere_closest.restype = i32
            lib.crt_error_string.argtypes = [i32]
            lib.crt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(err: int) -> str:
    return load().crt_error_string(err).decode()
