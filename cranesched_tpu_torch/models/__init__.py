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
from cranesched_tpu_torch.models.solver_time import (
    NO_START,
    TimedClusterState,
    TimedJobBatch,
    TimedPlacements,
    TimeGrid,
    make_timed_state,
    solve_backfill,
)
from cranesched_tpu_torch.models.gpu_solver import (
    solve_greedy_gpu,
    solve_greedy_gpu_auto,
    solve_greedy_gpu_from_batch,
)
from cranesched_tpu_torch.models.packing import (
    PackedJobBatch,
    PackedPlacements,
    solve_packed,
)
from cranesched_tpu_torch.models.preempt import (
    PreemptDecisions,
    PreemptorBatch,
    VictimRows,
    solve_preempt,
)
from cranesched_tpu_torch.models.preempt_time import (
    TimedPreemptDecisions,
    TimedPreemptorBatch,
    TimedVictimRows,
    solve_preempt_timed,
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
    "NO_START",
    "PackedJobBatch",
    "PackedPlacements",
    "Placements",
    "PreemptDecisions",
    "PreemptorBatch",
    "TimeGrid",
    "TimedClusterState",
    "TimedJobBatch",
    "TimedPlacements",
    "TimedPreemptDecisions",
    "TimedPreemptorBatch",
    "TimedVictimRows",
    "VictimRows",
    "make_cluster_state",
    "make_timed_state",
    "solve_backfill",
    "solve_greedy",
    "solve_greedy_gpu",
    "solve_greedy_gpu_auto",
    "solve_greedy_gpu_from_batch",
    "solve_packed",
    "solve_preempt",
    "solve_preempt_timed",
]
