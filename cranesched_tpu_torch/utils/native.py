"""ctypes bridge to the native C++ library (the port's copy of
``cranesched_tpu/utils/native.py``).

Builds the shared source ``native/crane_native.cpp`` (outside both
packages; the port never edits it) with g++ on first use (~1 s) into
the port's own cache, ``build/native/`` at the root of the checkout
(git-ignored), keyed by a hash of the source and the flags like the
CUDA kernels' (``kernels/build.py``): a changed source never loads a
stale library, and the JAX package's ``native/libcrane_native.so`` is
never touched.  ``available()`` tells callers whether the library
loaded; ``solve_greedy_native`` returns None where it cannot take the
shape.  The port's hostlist grammar stays pure Python
(``utils/hostlist.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

from cranesched_tpu_torch.obs import flight

ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = ROOT / "native" / "crane_native.cpp"
BUILD_DIR = ROOT / "build" / "native"

# -march=native vectorizes the solver's per-dimension loops for the
# host the library is built on (it is always compiled locally, never
# shipped).  No -ffast-math: QuantizedDcost's round-half-to-even must
# stay bit-identical to the fixed-point ledger.
_FLAGS = (("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native"),
          ("-O3", "-shared", "-fPIC", "-std=c++17"))

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source lives in the cache."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(repr(_FLAGS).encode())
    return BUILD_DIR / f"libcrane_native-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    for flags in _FLAGS:
        try:
            subprocess.run(["g++", *flags, "-o", str(tmp), str(_SRC)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, target)  # atomic: no reader sees half a library
        flight.note_kernel_cache("crane_native", hit=False,
                                 seconds=time.perf_counter() - t0)
        return True
    return False


def load():
    """The loaded CDLL, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        so = library_path()
        if so.exists():
            flight.note_kernel_cache("crane_native", hit=True)
        elif not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.crane_parse_hostlist.restype = ctypes.c_int
        lib.crane_parse_hostlist.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.crane_compress_hostlist.restype = ctypes.c_int
        lib.crane_compress_hostlist.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.crane_fits.restype = ctypes.c_int
        lib.crane_fits.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.crane_fit_count.restype = ctypes.c_int32
        lib.crane_fit_count.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.crane_fits_batch.restype = None
        lib.crane_fits_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.crane_solve_greedy.restype = ctypes.c_int
        lib.crane_solve_greedy.argtypes = [
            i32p, i32p, u8p, i32p, ctypes.c_int, ctypes.c_int,
            i32p, i32p, i32p, u8p, i32p, i32p, u8p,
            ctypes.c_int, ctypes.c_int, u8p, i32p, i32p]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def parse_hostlist(expr: str) -> list[str] | None:
    """Native hostlist expansion; None if the library is unavailable.
    Raises ValueError on malformed expressions."""
    lib = load()
    if lib is None:
        return None
    cap = max(1 << 16, len(expr) * 64)
    buf = ctypes.create_string_buffer(cap)
    n = lib.crane_parse_hostlist(expr.encode(), buf, cap)
    if n < 0:
        raise ValueError(f"malformed hostlist expression: {expr!r}")
    return buf.value.decode().split(",") if n else []


def solve_greedy_native(avail, total, alive, cost, req, node_num,
                        time_limit, valid, max_nodes: int, mask=None,
                        job_part=None, node_part=None):
    """Native greedy placement — bit-identical to models.solver
    solve_greedy (asserted in tests/test_torch_native.py).

    Eligibility comes from either a dense ``mask`` [J, N] or partition id
    vectors (``job_part``/``node_part``) for shapes where the dense mask
    is too big.  Returns (placed, nodes, reason, avail', cost') or None
    when the native library is unavailable."""
    import numpy as np
    # pure-shape checks BEFORE load(): never trigger a g++ build for a
    # call that cannot use the library anyway
    if np.asarray(avail).shape[1] > 16:
        return None  # beyond Treap::kMaxDims: the caller falls back
    if mask is None:
        parts = np.asarray(node_part)
        jparts = np.asarray(job_part)
        if (parts.size and parts.min() < 0) or \
                (jparts.size and jparts.min() < 0):
            return None  # negative ids: the caller falls back
        # partition ids are LABELS: densely remap them so the C++ side's
        # per-partition storage is O(distinct partitions), not O(max id)
        uniq, inv = np.unique(np.concatenate([parts, jparts]),
                              return_inverse=True)
        node_part = inv[: parts.size].astype(np.int32)
        job_part = inv[parts.size:].astype(np.int32)
    lib = load()
    if lib is None:
        return None
    avail = np.ascontiguousarray(avail, np.int32).copy()
    total = np.ascontiguousarray(total, np.int32)
    alive = np.ascontiguousarray(alive, np.uint8)
    cost = np.ascontiguousarray(cost, np.int32).copy()
    req = np.ascontiguousarray(req, np.int32)
    node_num = np.ascontiguousarray(node_num, np.int32)
    time_limit = np.ascontiguousarray(time_limit, np.int32)
    valid = np.ascontiguousarray(valid, np.uint8)
    n, dims = avail.shape
    j = req.shape[0]
    max_nodes = min(max_nodes, n)
    placed = np.zeros(j, np.uint8)
    nodes = np.full((j, max_nodes), -1, np.int32)
    reason = np.zeros(j, np.int32)

    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def p32(a):
        return a.ctypes.data_as(i32p)

    def pu8(a):
        return a.ctypes.data_as(u8p)

    if mask is not None:
        mask = np.ascontiguousarray(mask, np.uint8)
        mask_p, jp_p, np_p = pu8(mask), None, None
    else:
        jp = np.ascontiguousarray(job_part, np.int32)
        npart = np.ascontiguousarray(node_part, np.int32)
        mask_p, jp_p, np_p = None, p32(jp), p32(npart)
    rc = lib.crane_solve_greedy(
        p32(avail), p32(total), pu8(alive), p32(cost), n, dims,
        p32(req), p32(node_num), p32(time_limit),
        mask_p, jp_p, np_p, pu8(valid), j, max_nodes,
        pu8(placed), p32(nodes), p32(reason))
    if rc < 0:
        raise ValueError("crane_solve_greedy: bad arguments")
    return placed.astype(bool), nodes, reason, avail, cost


def compress_hostlist(names: list[str]) -> str | None:
    lib = load()
    if lib is None:
        return None
    csv = ",".join(names)
    cap = max(1 << 16, len(csv) * 2 + 16)
    buf = ctypes.create_string_buffer(cap)
    n = lib.crane_compress_hostlist(csv.encode(), buf, cap)
    if n < 0:
        raise ValueError("hostlist compression failed")
    return buf.value.decode()
