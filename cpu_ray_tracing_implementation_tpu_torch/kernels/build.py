"""Build and load the CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build
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
SOURCES = ("closest_hit.cu", "cull_select.cu", "visit_sweep.cu",
           "gather_sum.cu", "packet_closest.cu", "scatter.cu")
# headers the sources include: part of the library's hash
HEADERS = ("hit_tests.cuh",)
# multiply-add contraction stays on; a kernel that must round like its plain
# version says so in its source (K2's sphere quadratic, csrc/closest_hit.cu;
# K4, K7 and K8, csrc/visit_sweep.cu; K9 rounds each operation on its own,
# csrc/scatter.cu)
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build did: {"seconds": float, "cached": bool, "log": str,
# "sources": {source: nvcc seconds}}
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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcrt_kernels_{source_hash()}.so"


def _run_all(cmds) -> tuple[str, list[float]]:
    """Run the commands at once -> (their output, each one's seconds);
    raise with the output of any that fails."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs, secs = [""] * len(procs), [0.0] * len(procs)

    def wait(i):
        outs[i] = procs[i].communicate()[0]
        secs[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed ({p.returncode}) "
                               f"on {cmd[-1]}:\n{out}")
    return "".join(outs), secs


def compile_library() -> Path:
    """Compile the sources if the library for their hash is missing: one
    ``nvcc -c`` per source in parallel, then one link."""
    path = library_path()
    if path.exists():
        last_build.update(seconds=0.0, cached=True, log="", sources={})
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [str(Path(work) / f"{Path(s).stem}.o") for s in SOURCES]
        log, secs = _run_all([[nvcc, *FLAGS, "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                               "-c", "-o", o, str(CSRC / s)]
                              for s, o in zip(SOURCES, objs)])
        tmp = str(Path(work) / "lib.so")
        log += _run_all([[nvcc, *FLAGS, "-shared", "-o", tmp, *objs]])[0]
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    last_build.update(seconds=time.perf_counter() - t0, cached=False, log=log,
                      sources=dict(zip(SOURCES, secs)))
    return path


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(compile_library()))
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.crt_planar_closest.argtypes = [ptr, i32, ptr, i32, i32, f32,
                                               f32, i32, ptr, ptr, ptr]
            lib.crt_planar_closest.restype = i32
            lib.crt_sphere_closest.argtypes = [ptr, i32, ptr, i32, i32, f32,
                                               f32, ptr, ptr, ptr]
            lib.crt_sphere_closest.restype = i32
            lib.crt_cull_select.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                            f32, i32, i32, ptr, ptr, ptr, ptr]
            lib.crt_cull_select.restype = i32
            lib.crt_visit_sweep.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                            i32, i32, f32, i32, i32, i32, ptr, ptr, i32,
                                            ptr]
            lib.crt_visit_sweep.restype = i32
            lib.crt_subtile_sweep.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                              f32, i32, i32, ptr, ptr, i32, ptr]
            lib.crt_subtile_sweep.restype = i32
            lib.crt_gather_sum.argtypes = [ptr, i32, i32, ptr, i32, i32, ptr, ptr,
                                           ptr]
            lib.crt_gather_sum.restype = i32
            lib.crt_packet_planar.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, i32, i32,
                                              f32, i32, i32, ptr, ptr, ptr, ptr]
            lib.crt_packet_planar.restype = i32
            lib.crt_packet_sphere.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, i32, i32,
                                              f32, i32, ptr, ptr, ptr, ptr]
            lib.crt_packet_sphere.restype = i32
            lib.crt_packet_info.argtypes = [i32, i32, i32, ptr]
            lib.crt_packet_info.restype = i32
            lib.crt_scatter.argtypes = ([ptr, i32, i32, ptr, i32, i32] + [ptr] * 4
                                        + [i32, i32, ptr, i32, i32, ptr, ptr, i32, i32]
                                        + [ptr] * 7 + [i32] + [ptr] * 4 + [i32] + [ptr] * 2
                                        + [i32, i32] + [ptr] * 4)
            lib.crt_scatter.restype = i32
            lib.crt_error_string.argtypes = [i32]
            lib.crt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(err: int) -> str:
    return load().crt_error_string(err).decode()
