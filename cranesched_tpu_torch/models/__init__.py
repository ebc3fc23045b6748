from cranesched_tpu_torch.models.solver import (
    COST_INF,
    COST_SCALE,
    REASON_CONSTRAINT,
    REASON_NONE,
    REASON_RESOURCE,
    ClusterState,
    FactoredJobBatch,
    JobBatch,
    Placements,
    make_cluster_state,
    solve_greedy,
)
from cranesched_tpu_torch.models.gpu_solver import (
    solve_greedy_gpu,
    solve_greedy_gpu_auto,
    solve_greedy_gpu_from_batch,
)

__all__ = [
    "COST_INF",
    "COST_SCALE",
    "REASON_CONSTRAINT",
    "REASON_NONE",
    "REASON_RESOURCE",
    "ClusterState",
    "FactoredJobBatch",
    "JobBatch",
    "Placements",
    "make_cluster_state",
    "solve_greedy",
    "solve_greedy_gpu",
    "solve_greedy_gpu_auto",
    "solve_greedy_gpu_from_batch",
]
