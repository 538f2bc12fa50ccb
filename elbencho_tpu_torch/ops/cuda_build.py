"""Build and load the port's native libraries (compiler -> shared library -> ctypes).

Each source under ``csrc/`` has a plain C interface. At first use it is
compiled into ``elbencho_tpu_torch/_build/lib<name>-<hash>.so`` (the hash
covers the source, the compiler and its flags, so an edited source is
never served from a stale library) and loaded with ``ctypes``:

- ``load_library(name)``: the CUDA kernel ``csrc/<name>.cu``, built with
  ``nvcc -gencode arch=compute_90a,code=sm_90a`` (``source_dir`` names
  another directory, for a checkout's test kernels outside the package);
- ``load_host_library(name)``: the host C++ source ``csrc/<name>.cpp``
  (the native I/O engine), built with ``g++ -O2 -fPIC -std=c++17 -shared``.

A failed build raises with the compiler's output. The library is written
under a name of its own process and moved into place with an atomic
``os.replace``, so processes that build the same source at once (the
tests run under pytest-xdist) each load a whole library. Nothing is built
at import: the CPU tests import every module on machines without
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
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_libs: "dict[str, ctypes.CDLL]" = {}

#: per source name: (seconds the build took, the compiler's report)
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


def find_gxx() -> "str | None":
    """The host C++ compiler, or None where the machine has none."""
    return shutil.which("g++")


def load_library(name: str, source_dir: str = CSRC_DIR) -> ctypes.CDLL:
    """The loaded library of <source_dir>/<name>.cu (csrc/ by default),
    built on first call."""
    return _load(name, os.path.join(source_dir, f"{name}.cu"), find_nvcc,
                 NVCC_FLAGS)


def load_host_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cpp, built with g++ on first
    call; raises where there is no g++."""
    def gxx() -> str:
        path = find_gxx()
        if path is None:
            raise RuntimeError(f"g++ not found; csrc/{name}.cpp is built "
                               f"from source at first use")
        return path
    return _load(name, os.path.join(CSRC_DIR, f"{name}.cpp"), gxx,
                 GXX_FLAGS)


def _load(name: str, src: str, find_compiler, flags) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name, src, find_compiler(), flags))
            _libs[name] = lib
        return lib


def _build(name: str, src: str, compiler: str, flags) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join((os.path.basename(compiler),
                                 *flags)).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        build_reports.setdefault(name, (0.0, "cached"))
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.monotonic()
    proc = subprocess.run([compiler, *flags, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed to build "
                           f"{src} (rc {proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_reports[name] = (time.monotonic() - t0,
                           (proc.stdout + proc.stderr).strip())
    return out
