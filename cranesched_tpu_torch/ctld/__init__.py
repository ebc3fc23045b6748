"""Host control plane of the port: job lifecycle, cluster state and the
scheduling cycle.

- ``defs``      job/step lifecycle types
- ``meta``      authoritative cluster state — nodes, partitions, resource
                ledger, mid-cycle reduce events
- ``scheduler`` submit → cycle → commit → dispatch → status-change → free,
                and recovery from a WAL replay
- ``wal``       write-ahead log of job runtime records (group commit)
- ``archive``   durable history of terminal jobs (sqlite)
- ``acct_store`` durable accounts, users and QoS (sqlite)
"""

from cranesched_tpu_torch.ctld.defs import (
    JobSpec,
    JobStatus,
    PendingReason,
    ResourceSpec,
    Step,
    StepSpec,
    StepStatus,
)
from cranesched_tpu_torch.ctld.meta import MetaContainer, NodeMeta, Partition
from cranesched_tpu_torch.ctld.scheduler import JobScheduler, SchedulerConfig
from cranesched_tpu_torch.ctld.wal import WriteAheadLog

__all__ = [
    "JobScheduler",
    "JobSpec",
    "JobStatus",
    "MetaContainer",
    "NodeMeta",
    "Partition",
    "PendingReason",
    "ResourceSpec",
    "SchedulerConfig",
    "Step",
    "StepSpec",
    "StepStatus",
    "WriteAheadLog",
]
