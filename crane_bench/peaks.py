"""Published peaks of the card and the work of the greedy placement kernel.

NVIDIA's H100 SXM data sheet (dense, no sparsity, at its 700 W limit):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.  The
data sheet gives no int32 rate; the card issues int32 arithmetic at no more
than its float32 rate, so 67 T operations a second bounds the kernel's
compares and selects from above, and a share against it cannot read too
high.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def greedy_place_work(jobs: int, nodes_per_job: int, nodes: int,
                      dims: int = 3, gang: int = 2) -> tuple[float, float]:
    """(operations, bytes) one immediate-fit solve needs for ``jobs`` jobs,
    each eligible on ``nodes_per_job`` of ``nodes`` nodes with ``dims``
    resource dimensions: a compare per eligible node and dimension for the
    fit and one for the cheapest pick; the node state (free resources, cost,
    cpu capacity) read and written back once, each job's row (request,
    node count, limit, class) read once and its answer (placed, ``gang``
    nodes, reason) written once, all 4-byte words."""
    ops = float(jobs) * nodes_per_job * (dims + 1)
    state = nodes * (dims + 2) * 4
    byts = 2.0 * state + jobs * (dims + 3) * 4 + jobs * (gang + 2) * 4
    return ops, byts


def least_seconds(ops: float, byts: float) -> tuple[float, str]:
    """The least time at the published peaks and the bound that sets it."""
    t_ops, t_bytes = ops / ALU_OPS_PER_S, byts / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
