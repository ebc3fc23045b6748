"""Attribution of the greedy-placement kernel's time per job, stage by
stage (port of ``tools/kattr.py``).

Four stripped variants of ``csrc/greedy_place.cu``'s per-job loop
(``csrc/kattr_variants.cu``, built from the same stages in
``csrc/place_common.cuh``) run over the north-star shape, each
returning a checksum instead of placements.  One block owns every node
(state in shared memory when it fits, as ``variant_plan`` says):

  floor    job scalars staged a chunk at a time, summed; one barrier
           per job
  bcast    floor + the owned-slot walk testing the request
  onemin   bcast + each thread's least (cost, id) key, the warp merge
           and the one-barrier block merge
  select   onemin with the top 2 of the same walk (a gang of two)

``full`` is the real kernel, ``greedy_place`` with one stream and K = 2,
on the same data.  Differences between the rows attribute its time per
job to the stages.

Run on the card from the root of a checkout (the kernels build at first
use):

    python -m cranesched_tpu_torch.tools.kattr [--jobs J] [--nodes N]
        [variant ...]

It prints one row per variant: milliseconds (median of CUDA-event runs),
microseconds per job and the least time the card could take.  It writes
no file.  The data is the reference tool's, from ``default_rng(0)``: job
scalars int32[1, R+4, J_pad] in 1..999, avail int32[R, 8, W] in
0..9,999 and cost int32[1, 8, W] in 0..99, with J_pad = J rounded up to
a multiple of the block of BJ jobs, N rounded up to a multiple of 1,024
nodes and node id = sublane * W + lane.

``attr_variant`` is the kernel wrapper: on a CUDA tensor it launches the
variant's kernel, or raises; on a CPU tensor it runs
``attr_variant_plain``, the same checksum in plain PyTorch.
``attr_variant.launches[kind]`` counts kernel launches.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from cranesched_tpu_torch.device import resolve_device
from cranesched_tpu_torch.models.gpu_solver import THREADS, launch_plan
from cranesched_tpu_torch.models.solver import COST_INF

SUB, LANES = 8, 128
VARIANTS = ("floor", "bcast", "onemin", "select")
_KIND = {name: i for i, name in enumerate(VARIANTS)}
# H100 SXM int32 rate: 67 TFLOP/s float32 (NVIDIA's data sheet) counts
# an FMA as two operations on 128 float32 lanes per SM; an SM has 64
# int32 lanes (Hopper architecture white paper)
INT32_OPS_PER_S = 67e12 / 4
HBM_BYTES_PER_S = 3.35e12
# CUDA-event runs per measurement, after one warm-up launch
REPS = 5
# jobs per slice of the plain min passes ([chunk, N] temporaries)
_PLAIN_CHUNK = 2048


def make_data(jobs: int, nodes: int, R: int = 3, block_jobs: int = 256):
    """The reference tool's arrays (numpy int32), from ``default_rng(0)``
    as its ``run()`` draws them: ``job [1, R+4, J_pad]``, ``avail [R, 8,
    W]``, ``cost [1, 8, W]``."""
    n_pad = -(-nodes // (SUB * LANES)) * (SUB * LANES)
    W = n_pad // SUB
    j_pad = -(-jobs // block_jobs) * block_jobs
    rng = np.random.default_rng(0)
    job = rng.integers(1, 1000, (1, R + 4, j_pad)).astype(np.int32)
    avail = rng.integers(0, 10000, (R, SUB, W)).astype(np.int32)
    cost = rng.integers(0, 100, (1, SUB, W)).astype(np.int32)
    return job, avail, cost


def kernel_inputs(job, avail, cost, device=None):
    """Lay the reference arrays out for the kernels: ``(job int32[F,
    J_pad], avail int32[N, R], cost int32[N])``, contiguous on
    ``device`` (the CUDA card by default).  Node n = sublane * W + lane
    is row n of ``avail``, as in ``greedy_place``'s ``[N, R]``."""
    dev = resolve_device(device)
    job = torch.as_tensor(np.asarray(job, np.int32)).to(dev)
    avail = torch.as_tensor(np.asarray(avail, np.int32)).to(dev)
    cost = torch.as_tensor(np.asarray(cost, np.int32)).to(dev)
    R = avail.shape[0]
    return (job.reshape(job.shape[-2], -1).contiguous(),
            avail.reshape(R, -1).t().contiguous(),
            cost.reshape(-1).contiguous())


# ---- the kernels and their plain versions ----


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 to int32, wrapping as int32 arithmetic does."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def attr_variant_plain(kind: str, job, avail, cost, block_jobs: int
                       ) -> torch.Tensor:
    """Plain PyTorch version of variant ``kind``: the checksum
    ``int32[NB, 1, BJ]`` of the reference tool, on the kernel's inputs
    (``kernel_inputs``), on any device."""
    F, J = job.shape
    R = F - 4
    NB = J // block_jobs
    s = job.to(torch.int64).sum(dim=0)                         # [J]
    req = job[:R].t()                                          # [J, R]
    if kind in ("floor", "bcast"):
        per = s if kind == "floor" else (avail[0][None, :] >= req).all(1)
        acc = torch.cumsum(per.to(torch.int64), dim=0)
        lanes = acc[block_jobs - 1::block_jobs]                # [NB]
        return _wrap32(lanes)[:, None, None].expand(
            NB, 1, block_jobs).contiguous()
    if kind not in ("onemin", "select"):
        raise ValueError(f"unknown variant {kind!r}")
    out = torch.empty(J, dtype=torch.int64, device=job.device)
    chunk = _PLAIN_CHUNK
    for j0 in range(0, J, chunk):
        r = req[j0:j0 + chunk]
        feas = (avail[None, :, :] >= r[:, None, :]).all(-1)    # [c, N]
        mcost = torch.where(feas, cost[None, :], COST_INF)
        # argmin takes the first minimum: the lowest node id
        idx = torch.argmin(mcost, dim=1, keepdim=True)
        if kind == "select":
            mcost.scatter_(1, idx, COST_INF)
            idx = torch.argmin(mcost, dim=1, keepdim=True)
        val = mcost.gather(1, idx)[:, 0].to(torch.int64)
        if kind == "select":
            val = val + idx[:, 0]
        out[j0:j0 + chunk] = s[j0:j0 + chunk] + val
    return _wrap32(out).reshape(NB, 1, block_jobs)


def _kernel():
    from cranesched_tpu_torch.kernels.build import load

    fn = load("kattr_variants").kattr_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes each pointer as a 32-bit int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(job, avail, cost, block_jobs):
    dev = job.device
    for name, t in (("job", job), ("avail", avail), ("cost", cost)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, job on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} has dtype {t.dtype}, want int32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if job.dim() != 2 or avail.dim() != 2 or cost.dim() != 1:
        raise ValueError("job must be [R+4, J], avail [N, R], cost [N]")
    if (job.shape[0] != avail.shape[1] + 4 or cost.shape[0] != avail.shape[0]
            or block_jobs < 1 or job.shape[1] % block_jobs):
        raise ValueError("job/avail/cost shapes disagree or J is not a "
                         "multiple of block_jobs")


def variant_plan(N: int, R: int):
    """The variants' launch plan: one block owning all N nodes, laid out
    as ``greedy_place`` lays out a serial solve over N nodes (no class
    bits)."""
    return launch_plan(N, R, 0, 0)


def attr_variant(kind: str, job, avail, cost, block_jobs: int
                 ) -> torch.Tensor:
    """Kernel wrapper: the checksum ``int32[NB, 1, BJ]`` of variant
    ``kind``.  CPU tensors take ``attr_variant_plain``; CUDA tensors
    launch the kernel on the current stream or raise."""
    if kind not in _KIND:
        raise ValueError(f"unknown variant {kind!r}")
    if job.device.type == "cpu":
        return attr_variant_plain(kind, job, avail, cost, block_jobs)
    _check(job, avail, cost, block_jobs)
    F, J = job.shape
    N, R = avail.shape
    plan = variant_plan(N, R)
    dev = job.device
    out = torch.empty(J, dtype=torch.int32, device=dev)
    side = torch.empty(THREADS, dtype=torch.int32, device=dev)
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    rc = _kernel()(_KIND[kind], job.data_ptr(), avail.data_ptr(),
                   cost.data_ptr(), ids.data_ptr(), out.data_ptr(),
                   side.data_ptr(), J, N, R, block_jobs,
                   plan.state == "shared", plan.smem_bytes,
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kattr {kind} launch failed: CUDA error {rc} "
                           f"({plan})")
    attr_variant.launches[kind] += 1
    return out.reshape(J // block_jobs, 1, block_jobs)


attr_variant.launches = {kind: 0 for kind in VARIANTS}


# ---- the real kernel on the same data ----


def greedy_inputs(job, avail, cost):
    """``greedy_place``'s inputs for the same data: one stream of every
    job in order as a gang of two (K = 2), request = the job's first R
    scalars, time limit its (R+1)-th, every node alive and eligible, the
    cost divisor max(avail cpu, 1).  Returns ``(jobs, nelig, elig,
    cpu_total, avail, cost, K)``; avail and cost are fresh copies."""
    F, J = job.shape
    R = F - 4
    N = avail.shape[0]
    dev = job.device
    jobs = torch.stack([*job[:R],
                        torch.full((J,), 2, dtype=torch.int32, device=dev),
                        job[R + 1],
                        torch.ones(J, dtype=torch.int32, device=dev),
                        torch.zeros(J, dtype=torch.int32, device=dev)],
                       dim=1)[None].contiguous()           # [1, J, R+4]
    nelig = torch.full((1,), N, dtype=torch.int32, device=dev)
    elig = torch.ones((1, N), dtype=torch.bool, device=dev)
    cpu_total = avail[:, 0].clamp(min=1).to(torch.float32)
    return (jobs, nelig, elig, cpu_total, avail.clone(), cost.clone(), 2)


# ---- measurement ----


def bound(kind: str, J: int, N: int, R: int) -> tuple[float, str]:
    """The least time the card could take for variant ``kind`` (or
    ``"full"``): the larger of its int32 operations over the int32 rate
    and its bytes (each input read once, each output written once) over
    the memory rate.  Per job: F adds; per job and node R compares and
    an AND for feasibility (bcast on), plus a select and a compare per
    minimum pass (onemin 1, select and full 2).  Returns ``(ms, by)``."""
    F = R + 4
    passes = {"floor": 0, "bcast": 0, "onemin": 1, "select": 2,
              "full": 2}[kind]
    ops = J * F + (0 if kind == "floor" else J * N * (R + 1 + 2 * passes))
    nbytes = J * F * 4 + J * 4
    if kind != "floor":
        nbytes += N * R * 4
    if passes:
        nbytes += N * 4
    if kind == "bcast":
        nbytes += THREADS * 4
    if kind == "full":
        # avail and cost written back, placements and reasons out
        nbytes += N * (R + 1) * 4 + J * (2 + 2) * 4
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def event_ms(fn, reps: int = REPS) -> list[float]:
    """``reps`` CUDA-event times of ``fn()`` in milliseconds, one by
    one."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def check_variants(job, avail, cost, block_jobs: int,
                   kinds=VARIANTS) -> dict[str, int]:
    """Each variant's kernel against its plain version on the card,
    bitwise; raises on a difference.  Returns each variant's largest
    absolute difference (0)."""
    errs = {}
    for kind in kinds:
        got = attr_variant(kind, job, avail, cost, block_jobs)
        want = attr_variant_plain(kind, job, avail, cost, block_jobs)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise RuntimeError(f"kattr {kind}: {bad} checksum lanes "
                               "differ from the plain version")
        errs[kind] = int((got.long() - want.long()).abs().max())
    return errs


def attribute(job, avail, cost, block_jobs: int, kinds=VARIANTS
              ) -> list[dict]:
    """Time each variant (one warm-up launch, then ``REPS`` CUDA-event
    runs, median) and the real kernel on the same data.  Returns one row
    per variant and a last row ``full``."""
    from cranesched_tpu_torch.models.gpu_solver import (
        greedy_place,
        owned_slots,
    )

    F, J = job.shape
    N, R = avail.shape
    rows = []
    for kind in kinds:
        attr_variant(kind, job, avail, cost, block_jobs)
        times = event_ms(
            lambda: attr_variant(kind, job, avail, cost, block_jobs))
        rows.append(dict(variant=kind, runs=times))
    jobs, nelig, elig, cpu_total, a0, c0, K = greedy_inputs(job, avail,
                                                            cost)
    owned = [torch.from_numpy(x).to(job.device)
             for x in owned_slots(elig.cpu().numpy())]   # every node
    greedy_place(jobs, nelig, elig, cpu_total, a0.clone(), c0.clone(), K,
                 *owned)
    times = []
    for _ in range(REPS):
        a, c = a0.clone(), c0.clone()
        times += event_ms(lambda: greedy_place(
            jobs, nelig, elig, cpu_total, a, c, K, *owned), 1)
    rows.append(dict(variant="full", runs=times))
    for row in rows:
        row["ms"] = float(np.median(row["runs"]))
        row["us_per_job"] = row["ms"] * 1e3 / J
        row["bound_ms"], row["bound_by"] = bound(row["variant"], J, N, R)
    return rows


def format_rows(rows) -> str:
    lines = [f"{'variant':8s} {'ms':>10s} {'us/job':>8s} {'bound ms':>10s}"]
    for r in rows:
        lines.append(f"{r['variant']:8s} {r['ms']:10.3f} "
                     f"{r['us_per_job']:8.3f} {r['bound_ms']:10.4f} "
                     f"({r['bound_by']})")
    return "\n".join(lines)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them:
    a card set below its maximum power runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", choices=VARIANTS,
                    help="default: all four")
    ap.add_argument("--jobs", type=int, default=100_000)
    ap.add_argument("--nodes", type=int, default=10_000)
    args = ap.parse_args(argv)
    kinds = tuple(args.variants) or VARIANTS
    if not torch.cuda.is_available():
        print("kattr: no CUDA device visible; the variants run on the card",
              file=sys.stderr)
        return 2
    bj = 256
    job, avail, cost = kernel_inputs(*make_data(args.jobs, args.nodes, 3,
                                                bj))
    print(f"card: {card_line()}; J={job.shape[1]} N={avail.shape[0]} "
          f"R={avail.shape[1]} BJ={bj}", flush=True)
    check_variants(job, avail, cost, bj, kinds)
    rows = attribute(job, avail, cost, bj, kinds)
    print(format_rows(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
