"""Host-side BVH ordering of large primitive tables.

Port of ``cpu_ray_tracing_implementation_tpu/utils/accel.py:58-153``. The
chunked tables (``models/scene.py``) store primitives in the depth-first
leaf order of a binned-SAH BVH, so that fixed-size chunks of 128
primitives get tight AABBs. The builder is the repository's
``native/bvh_builder.cc``, the same source the JAX package uses, so both
packages cut the same chunks. It is compiled with g++ at first use into the
port's build directory (``build/``, listed in ``.gitignore``; nothing is
written next to the source), under a name that carries a hash of the
source and flags. Without a compiler, a numpy Morton order stands in
(looser chunk bounds, the same rendered result).

The builder's node array and its threaded links (``threaded_links``)
give the BVH traversal oracle its tree (``ops/bvh.py``, the scene's
``*_tree`` fields).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG.parent / "native" / "bvh_builder.cc"
BUILD_DIR = PKG / "build"
# the flags of native/Makefile, which the JAX package's loader uses too
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbvh_{h.hexdigest()[:16]}.so"


def _compile() -> Path:
    path = _library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load_native() -> ctypes.CDLL | None:
    """The native builder, compiled on first use; None without g++."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_compile()))
        except (OSError, subprocess.SubprocessError) as e:
            warnings.warn(f"native BVH builder unavailable ({e}); using the "
                          "numpy Morton order", RuntimeWarning)
            return None
        fptr = ctypes.POINTER(ctypes.c_float)
        iptr = ctypes.POINTER(ctypes.c_int32)
        lib.bvh_build.restype = ctypes.c_int32
        lib.bvh_build.argtypes = [fptr, fptr, fptr, ctypes.c_int32,
                                  ctypes.c_int32, iptr, fptr]
        _lib = lib
        return _lib


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Fallback spatial sort: 3x10-bit Morton codes of quantized centroids."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    extent = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip(((c - lo) / extent * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)


def build_bvh(centroids: np.ndarray, lo: np.ndarray, hi: np.ndarray,
              max_leaf: int = 8):
    """(order [n] int32 new->old, nodes [m,8] float32 or None).

    Node row: [lo(3), hi(3), a, b]: internal, a = right-child index (left is
    row+1) and b = 0; leaf, a = first primitive (in the reordered array)
    and b = count. ``nodes`` is None under the Morton fallback.
    """
    n = len(centroids)
    if n == 0:
        return np.zeros((0,), np.int32), None
    lib = _load_native()
    if lib is None:
        return _morton_order(centroids), None
    c = np.ascontiguousarray(centroids, np.float32)
    lo32 = np.ascontiguousarray(lo, np.float32)
    hi32 = np.ascontiguousarray(hi, np.float32)
    order = np.zeros((n,), np.int32)
    nodes = np.zeros((2 * n, 8), np.float32)
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int32)
    count = lib.bvh_build(
        c.ctypes.data_as(fptr), lo32.ctypes.data_as(fptr),
        hi32.ctypes.data_as(fptr), n, int(max_leaf),
        order.ctypes.data_as(iptr), nodes.ctypes.data_as(fptr))
    if count < 0:
        return _morton_order(centroids), None
    return order, nodes[:count].copy()


def threaded_links(nodes: np.ndarray):
    """Hit and miss links for stackless ("threaded") BVH traversal
    (``accel.py:106-153`` of the JAX package).

    The builder emits nodes in depth-first order (left child = i+1, right
    child = nodes[i,6] for internal nodes). The skip link of a node is the
    node visited after its whole subtree: skip(root) = sentinel n,
    skip(left) = right sibling, skip(right) = skip(parent). Traversal then
    keeps one int per ray:

        next = aabb_hit ? hit_link[node] : miss_link[node]

    with hit_link = node+1 (descend) for internal nodes and skip for leaves
    (the reference's recursive descent, src/bvh_node.h:49-58).

    Returns (hit_link [n] int32, miss_link [n] int32, leaf_first [n] int32,
    leaf_count [n] int32); the sentinel n ends a traversal.
    """
    n = len(nodes)
    skip = np.full(n, n, np.int32)
    stack = [(0, n)]
    while stack:
        i, sk = stack.pop()
        skip[i] = sk
        if nodes[i, 7] == 0:  # internal
            right = int(nodes[i, 6])
            stack.append((i + 1, right))
            stack.append((right, sk))
    is_leaf = nodes[:, 7] > 0
    hit_link = np.where(is_leaf, skip, np.arange(n, dtype=np.int32) + 1)
    leaf_first = np.where(is_leaf, nodes[:, 6], 0).astype(np.int32)
    leaf_count = nodes[:, 7].astype(np.int32)
    return hit_link.astype(np.int32), skip, leaf_first, leaf_count


def chunk_bounds(lo: np.ndarray, hi: np.ndarray, chunk: int):
    """Per-chunk AABBs of an already-ordered primitive array, padded to a
    multiple of ``chunk``. Returns (chunk_lo [K,3], chunk_hi [K,3]) float32;
    padding rows get inverted (empty) boxes that never pass a slab test."""
    n = len(lo)
    k = max(1, (n + chunk - 1) // chunk)
    clo = np.full((k, 3), np.inf, np.float32)
    chi = np.full((k, 3), -np.inf, np.float32)
    for i in range(k):
        s, e = i * chunk, min((i + 1) * chunk, n)
        if s < e:
            clo[i] = lo[s:e].min(axis=0)
            chi[i] = hi[s:e].max(axis=0)
    return clo, chi
