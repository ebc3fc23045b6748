"""The single leader's restart path (port of ``cranesched_tpu/ha/``):

- :mod:`lease` -- an OS-level file lock on the WAL directory as the
  leader lease, plus a monotonically increasing fencing epoch persisted
  beside the WAL, so a second controller pointed at the same WAL fails
  fast instead of corrupting the log;
- :mod:`snapshot` -- periodic fsync'd, atomically-renamed snapshots of
  scheduler + meta state, with WAL segment rotation so recovery replays
  snapshot + tail instead of the full log.

The hot standby and its promotion (``ha/follower.py``) are ROADMAP.md
A13.
"""

from cranesched_tpu_torch.obs.metrics import REGISTRY

# 1 = leader (labelless; one ctld process = one role)
ROLE_GAUGE = REGISTRY.gauge(
    "crane_ha_role", "HA role of this ctld (1=leader, 0=standby)")
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

__all__ = [
    "ROLE_GAUGE", "SNAPSHOTS", "WAL_SEQ_GAUGE",
    "FencingEpoch", "LeaderLease", "SnapshotStore", "Snapshotter",
    "capture_snapshot", "recover_from_snapshot", "restore_snapshot",
]
