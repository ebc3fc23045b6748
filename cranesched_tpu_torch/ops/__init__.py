from cranesched_tpu_torch.ops.resources import (
    BIG,
    CPU_SCALE,
    DIM_CPU,
    DIM_MEM,
    DIM_MEMSW,
    MEM_UNIT_BYTES,
    NUM_BASE_DIMS,
    ResourceLayout,
    fit_count,
    fits,
)

__all__ = [
    "BIG",
    "CPU_SCALE",
    "DIM_CPU",
    "DIM_MEM",
    "DIM_MEMSW",
    "MEM_UNIT_BYTES",
    "NUM_BASE_DIMS",
    "ResourceLayout",
    "fit_count",
    "fits",
]
