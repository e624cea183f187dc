"""Build the package's CUDA sources (``csrc/*.cu``) into shared libraries
with a plain C interface, at first use, and load them with ``ctypes``.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``multiview_tpu_torch/_build/`` under a name keyed by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one is reused.
``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
``/usr/local/cuda/bin``; a missing compiler is an error, never a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

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


def library_path(source_name: str) -> Path:
    src = CSRC_DIR / source_name
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}_{key[:16]}.so"


def load_library(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source_name>``."""
    lib = _libs.get(source_name)
    if lib is not None:
        return lib
    out = library_path(source_name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source_name)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source_name}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builders never see a torn file
        build_reports[source_name] = (time.perf_counter() - t0,
                                      (proc.stdout + proc.stderr).strip())
    lib = ctypes.CDLL(str(out))
    _libs[source_name] = lib
    return lib
