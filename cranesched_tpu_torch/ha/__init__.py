"""High availability (port of ``cranesched_tpu/ha/``): snapshot + WAL
replication, leader lease with fencing, hot-standby failover.

- :mod:`lease` -- an OS-level file lock on the WAL directory as the
  leader lease, plus a monotonically increasing fencing epoch persisted
  beside the WAL and stamped into every craned push, so a deposed
  leader's in-flight pushes are refused after a failover;
- :mod:`snapshot` -- periodic fsync'd, atomically-renamed snapshots of
  scheduler + meta state, with WAL segment rotation so recovery replays
  snapshot + tail instead of the full log;
- :mod:`follower` -- a standby ctld that pulls a snapshot and streams
  WAL records over the gRPC plane into a shadow scheduler (no cycles, no
  dispatch), and promotes itself when the leader's lease frees.
"""

from cranesched_tpu_torch.obs.metrics import REGISTRY

# 1 = leader, 0 = standby (labelless; one ctld process = one role)
ROLE_GAUGE = REGISTRY.gauge(
    "crane_ha_role", "HA role of this ctld (1=leader, 0=standby)")
LAG_GAUGE = REGISTRY.gauge(
    "crane_ha_replication_lag_records",
    "standby only: WAL records the shadow state trails the leader by")
FAILOVERS = REGISTRY.counter(
    "crane_ha_failovers_total", "standby->leader promotions")
SNAPSHOTS = REGISTRY.counter(
    "crane_ha_snapshots_total", "durable snapshots written")
WAL_SEQ_GAUGE = REGISTRY.gauge(
    "crane_ha_wal_seq", "last durable WAL sequence number")

from cranesched_tpu_torch.ha.lease import (  # noqa: E402
    FencingEpoch,
    LeaderLease,
)
from cranesched_tpu_torch.ha.snapshot import (  # noqa: E402
    SnapshotStore,
    Snapshotter,
    capture_snapshot,
    recover_from_snapshot,
    restore_snapshot,
)
from cranesched_tpu_torch.ha.follower import HaFollower  # noqa: E402

__all__ = [
    "ROLE_GAUGE", "LAG_GAUGE", "FAILOVERS", "SNAPSHOTS", "WAL_SEQ_GAUGE",
    "FencingEpoch", "LeaderLease", "SnapshotStore", "Snapshotter",
    "capture_snapshot", "recover_from_snapshot", "restore_snapshot",
    "HaFollower",
]
