"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file under ``cranesched_tpu_torch/csrc/`` with
a plain C interface (sharing code through the ``.cuh`` headers there),
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library and
loaded with ``ctypes``.  The build happens at first use, into
``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the source, every header and the
flags, so a fresh checkout builds everything it runs and a changed
source or header never loads a stale library.  A missing ``nvcc`` raises: there is no fallback.
Every lookup is counted in ``obs.flight.kernel_cache_stats`` (a library
found built is a hit, one built now a miss), and every build in
``obs.introspect.total_compiles`` (the cycle trace's ``recompiles``).

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

from cranesched_tpu_torch.obs import flight

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# name -> source file under csrc/
SOURCES = {"greedy_place": "greedy_place.cu",
           "kattr_variants": "kattr_variants.cu"}

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
    h = hashlib.sha256((CSRC_DIR / SOURCES[name]).read_bytes())
    # every header, by name and content: a source includes any of them
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one kernel; returns (process, tmp, target, start)
    or None when the library for this source is already built."""
    target = library_path(name)
    if target.exists():
        flight.note_kernel_cache(name, hit=True)
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target, time.perf_counter()


def _finish(name: str, started) -> str:
    proc, tmp, target, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(rc={proc.returncode}):\n{out}")
    os.replace(tmp, target)   # atomic: a reader never sees half a library
    flight.note_kernel_cache(name, hit=False,
                             seconds=time.perf_counter() - t0)
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
