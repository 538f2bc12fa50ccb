"""Build and load the port's CUDA C++ kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``elbencho_tpu_torch/_build/lib<name>-<hash>.so`` (the hash covers the
source and the flags, so an edited source is never served from a stale
library) and loaded with ``ctypes``. A failed build raises. Nothing is
built at import: the CPU tests import every module on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: "dict[str, ctypes.CDLL]" = {}

#: per kernel source: (seconds the build took, compiler's -Xptxas -v report)
build_reports: "dict[str, tuple[float, str]]" = {}


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return nvcc


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name))
            _libs[name] = lib
        return lib


def _build(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        build_reports.setdefault(name, (0.0, "cached"))
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.monotonic()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src} (rc "
                           f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_reports[name] = (time.monotonic() - t0,
                           (proc.stdout + proc.stderr).strip())
    return out
