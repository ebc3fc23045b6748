"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file under ``cranesched_tpu_torch/csrc/`` with
a plain C interface, compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library and loaded with ``ctypes``.  The build happens at first
use, into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the source and the flags, so a fresh
checkout builds everything it runs and a rebuilt source never loads a
stale library.  A missing ``nvcc`` raises: there is no fallback.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them; ``load(name)`` builds one kernel if needed and returns its
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# name -> source file under csrc/
SOURCES = {"greedy_place": "greedy_place.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source at "
        "first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for one kernel; returns (process, tmp, target) or None
    when the library for this source is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> str:
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(rc={proc.returncode}):\n{out}")
    os.replace(tmp, target)   # atomic: a reader never sees half a library
    return out


def build_all() -> dict[str, dict]:
    """Build every kernel that is not built yet, one nvcc per source,
    all started together.  Returns per-kernel ``{"seconds", "log"}``
    (the log carries ``-Xptxas -v``'s register and memory report)."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SOURCES}
    report = {}
    for name, st in started.items():
        log = _finish(name, st) if st is not None else "cached"
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        st = _start(name)
        if st is not None:
            _finish(name, st)
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib
