"""Build the package's CUDA sources (``csrc/*.cu``) into shared libraries
with a plain C interface, at first use, and load them with ``ctypes``.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``multiview_tpu_torch/_build/`` under a name keyed by a hash of the source,
the local headers it includes (``#include "..."`` under ``csrc/``, followed
into the headers they include) and the flags, so an edited source or header
rebuilds every library that uses it and an unchanged one is reused.
``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
``/usr/local/cuda/bin``; a missing compiler is an error, never a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# source name -> (build seconds, nvcc/ptxas report) for builds made by this process
build_reports: Dict[str, Tuple[float, str]] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc was not found on PATH or under $CUDA_HOME/bin; it is "
                       "needed to build the CUDA kernels of multiview_tpu_torch")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_headers(source_name: str, csrc: Path = CSRC_DIR) -> Tuple[str, ...]:
    """The headers under ``csrc`` that ``source_name`` includes with
    ``#include "..."``, directly or through another of them, in the order
    first reached; a named header that does not exist there is an error."""
    seen, todo = [], [source_name]
    while todo:
        for name in _LOCAL_INCLUDE.findall((csrc / todo.pop()).read_bytes()):
            name = name.decode()
            if not (csrc / name).is_file():
                raise FileNotFoundError(f"{source_name} includes {name!r}, which is not in {csrc}")
            if name not in seen:
                seen.append(name)
                todo.append(name)
    return tuple(seen)


def build_key(source_name: str, csrc: Path = CSRC_DIR) -> str:
    """The hash a library's file name carries: the source, its local
    headers and the flags."""
    h = hashlib.sha256((csrc / source_name).read_bytes())
    for name in local_headers(source_name, csrc):
        h.update(name.encode() + b"\0" + (csrc / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def library_path(source_name: str) -> Path:
    return BUILD_DIR / f"{Path(source_name).stem}_{build_key(source_name)[:16]}.so"


def _start_build(source_name: str, out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source_name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, time.perf_counter()


def _finish_build(source_name: str, out: Path, proc, tmp: Path, t0: float) -> str:
    """Waits for one nvcc; returns its error text, empty when it succeeded."""
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        return f"nvcc failed to build {source_name}:\n{stdout}\n{stderr}"
    os.replace(tmp, out)   # atomic: concurrent builders never see a torn file
    build_reports[source_name] = (time.perf_counter() - t0, (stdout + stderr).strip())
    return ""


def build_libraries(source_names: Sequence[str]) -> None:
    """Build every source of ``source_names`` that is not built yet, one
    ``nvcc`` process each, all started together; every process is waited
    for before a failure is raised."""
    todo = [(name, library_path(name)) for name in source_names if name not in _libs]
    running = [(name, out, _start_build(name, out)) for name, out in todo if not out.exists()]
    errors = [_finish_build(name, out, *started) for name, out, started in running]
    if any(errors):
        raise RuntimeError("\n".join(e for e in errors if e))


def load_library(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source_name>``."""
    lib = _libs.get(source_name)
    if lib is not None:
        return lib
    build_libraries([source_name])
    lib = ctypes.CDLL(str(library_path(source_name)))
    _libs[source_name] = lib
    return lib


def check_tensor(kernel: str, name: str, t, shape, dtype, dev) -> None:
    """Raises where tensor ``t`` is not what ``kernel`` takes: another dtype
    (TypeError), device, shape or a non-contiguous layout (ValueError)."""
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
    if t.device != dev:
        raise ValueError(f"{kernel}: {name} lies on {t.device}, expected {dev}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")


def ptr(t) -> "int | None":
    """A tensor's device address for a kernel's argument (None for None)."""
    return None if t is None else t.data_ptr()


def stream(dev) -> int:
    """The current CUDA stream of ``dev``, as a kernel's launch takes it."""
    import torch
    return torch.cuda.current_stream(dev).cuda_stream
