"""ctypes binding for the native host runtime (``native/mv_native.cpp``).

Port of ``multiview_tpu/native.py``. The library is compiled with g++ from
the repo's ``native/mv_native.cpp`` on first use, into the port's own build
directory (``multiview_tpu_torch/_build/``, keyed by a hash of the source);
nothing is ever written into ``native/``. Every entry point keeps a
pure-Python fallback, so the package works without a host toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "mv_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_lib = None
_tried = False


def load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        key = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        out = _BUILD_DIR / f"mv_native_{key}.so"
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
                 str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.mv_union_find.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C")]
        lib.mv_dedup_keypoints.restype = ctypes.c_int64
        lib.mv_dedup_keypoints.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C")]
        lib.mv_read_files.argtypes = [
            ctypes.c_int64, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib


def available() -> bool:
    """Whether the native library built and loaded."""
    return load() is not None


def union_find_roots(n_nodes: int, edges: np.ndarray) -> np.ndarray:
    """Final root per node after merging edge pairs [E,2]. Native when
    available, NumPy/python fallback otherwise."""
    edges = np.ascontiguousarray(edges, np.int64)
    lib = load()
    out = np.empty(n_nodes, np.int64)
    if lib is not None:
        a = np.ascontiguousarray(edges[:, 0])
        b = np.ascontiguousarray(edges[:, 1])
        lib.mv_union_find(n_nodes, len(edges), a, b, out)
        return out
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for ea, eb in edges:
        ra, rb = find(int(ea)), find(int(eb))
        if ra != rb:
            parent[rb] = ra
    for i in range(n_nodes):
        out[i] = find(i)
    return out


def dedup_keypoints_array(xy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(ids [N], unique_xy [U,2]) with bit-exact float matching."""
    xy = np.ascontiguousarray(xy, np.float64)
    n = len(xy)
    lib = load()
    if lib is not None and n > 0:
        ids = np.empty(n, np.int64)
        uniq = np.empty((n, 2), np.float64)
        u = lib.mv_dedup_keypoints(n, xy, ids, uniq)
        return ids, uniq[:u].copy()
    seen = {}
    ids = np.empty(n, np.int64)
    uniq: List[np.ndarray] = []
    for i in range(n):
        key = (xy[i, 0].tobytes(), xy[i, 1].tobytes())
        if key not in seen:
            seen[key] = len(uniq)
            uniq.append(xy[i])
        ids[i] = seen[key]
    return ids, (np.stack(uniq) if uniq else np.zeros((0, 2)))


def read_files(paths: List[str], num_threads: int = 0) -> List[Optional[bytes]]:
    """The bytes of many files, read concurrently by the native thread pool
    (``num_threads`` 0: one per hardware thread); None for a file that
    cannot be read."""
    lib = load()
    if lib is None:
        out = []
        for p in paths:
            try:
                out.append(Path(p).read_bytes())
            except OSError:
                out.append(None)
        return out
    n = len(paths)
    blob = b"\0".join(str(p).encode() for p in paths) + b"\0"
    sizes = np.empty(n, np.int64)
    offsets = np.empty(n, np.int64)
    lib.mv_read_files(n, blob, sizes, offsets, None, 0, num_threads)
    buf = np.empty(int(sizes[sizes > 0].sum()), np.uint8)
    lib.mv_read_files(n, blob, sizes, offsets, buf.ctypes.data_as(ctypes.c_void_p), buf.size,
                      num_threads)
    return [None if sizes[i] < 0 else bytes(buf[offsets[i]:offsets[i] + sizes[i]])
            for i in range(n)]
