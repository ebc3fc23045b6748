"""Resource algebra as dense integer tensors (PyTorch port of
``cranesched_tpu/ops/resources.py``).

A resource quantity is a flat int32 vector with one dimension per
resource kind, so that

* feasibility       = elementwise ``req <= avail`` reduced over the last axis,
* allocation/free   = vector add/sub,
* max-fit count     = ``min_over_dims(avail // req)``,

all of which vectorize over (jobs x nodes) without data-dependent shapes.

Encoding
--------
dim 0: cpu, fixed point with 8 fractional bits (CPU_SCALE = 256 units per
       core).
dim 1: memory, MiB.
dim 2: memory+swap, MiB.
dim 3+: one dimension per configured GRES (name, type) pair, unit = slots.

``ResourceLayout`` is host-side numpy and identical to the JAX package's,
so both packages encode the same request to the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from cranesched_tpu_torch.utils.gres import (  # noqa: F401
    gres_key_pair,
    gres_key_str,
)

# Fixed-point scale for cpu counts: 8 fractional bits.
CPU_SCALE = 256
# Memory unit for device tensors.
MEM_UNIT_BYTES = 1 << 20  # 1 MiB


DIM_CPU = 0
DIM_MEM = 1
DIM_MEMSW = 2
NUM_BASE_DIMS = 3

# A value safely above any real per-dimension quantity, used for "infinite"
# availability in masked comparisons. Kept well under int32 max so sums of a
# few of these cannot overflow.
BIG = np.int32(2**30)


@dataclasses.dataclass(frozen=True)
class ResourceLayout:
    """Static mapping of resource dimensions.

    ``gres_pairs`` is the ordered tuple of GRES ``(name, type)`` pairs —
    e.g. ``("gpu", "a100")`` — whose tensor dimension index is
    ``NUM_BASE_DIMS + position``.
    """

    gres_pairs: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "gres_pairs", tuple(self.gres_pairs))

    @property
    def gres_dims(self) -> dict[tuple[str, str], int]:
        return {p: NUM_BASE_DIMS + i for i, p in enumerate(self.gres_pairs)}

    @property
    def num_dims(self) -> int:
        return NUM_BASE_DIMS + len(self.gres_pairs)

    @staticmethod
    def from_gres_names(pairs: Sequence[tuple[str, str]]) -> "ResourceLayout":
        return ResourceLayout(tuple(pairs))

    def encode(
        self,
        cpu: float = 0.0,
        mem_bytes: int = 0,
        memsw_bytes: int = 0,
        gres: Mapping[tuple[str, str], int] | None = None,
        is_capacity: bool = False,
    ) -> np.ndarray:
        """Encode one resource quantity as an int32 vector.

        cpu is rounded to the nearest 1/256 core.  Memory rounding is
        direction-aware so quantization never admits a job raw bytes would
        refuse: requests round UP to MiB, capacities (``is_capacity=True``)
        round DOWN.
        """
        v = np.zeros(self.num_dims, dtype=np.int32)
        v[DIM_CPU] = int(round(cpu * CPU_SCALE))
        if is_capacity:
            v[DIM_MEM] = int(mem_bytes) // MEM_UNIT_BYTES
            v[DIM_MEMSW] = int(memsw_bytes) // MEM_UNIT_BYTES
        else:
            v[DIM_MEM] = -(-int(mem_bytes) // MEM_UNIT_BYTES)
            v[DIM_MEMSW] = -(-int(memsw_bytes) // MEM_UNIT_BYTES)
        gres_dims = self.gres_dims
        for key, count in (gres or {}).items():
            v[gres_dims[key]] = int(count)
        return v

    def decode_cpu(self, v: np.ndarray) -> float:
        return float(v[DIM_CPU]) / CPU_SCALE

    def decode_mem_bytes(self, v: np.ndarray) -> int:
        return int(v[DIM_MEM]) * MEM_UNIT_BYTES


def fits(req: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """``req <= avail`` over the resource axis.

    req: [..., R], avail: [..., R] (broadcastable) -> bool[...]
    """
    return torch.all(req <= avail, dim=-1)


def fit_count(avail: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """How many tasks of ``req`` fit into ``avail`` (elementwise min
    quotient over the dimensions the job requests).

    avail: [..., R], req: [..., R] -> int32[...]
    """
    avail, req = torch.broadcast_tensors(avail, req)
    q = torch.where(req > 0, torch.div(avail, req.clamp(min=1),
                                       rounding_mode="floor"),
                    torch.full_like(avail, int(BIG)))
    return q.min(dim=-1).values.to(torch.int32)
