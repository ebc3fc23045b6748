"""Federated control plane (port of ``cranesched_tpu/fed/``):
partition-sharded schedulers, a placement arbiter for cross-partition
gangs, and a bounded-staleness scatter-gather query plane.

One logical cluster is split across controller *shards*.  Each shard is
a full ctld — its own :class:`~cranesched_tpu_torch.ctld.scheduler.JobScheduler`,
pending table, and WAL — over a disjoint set of partitions, so submit
ingest, accounting checks, and WAL fsyncs scale horizontally.  The only
cross-shard authority is the :class:`~cranesched_tpu_torch.fed.arbiter.
PlacementArbiter`, which owns cross-partition gang jobs and commits
them through two-phase reserve/confirm records in each shard's WAL
under that shard's fencing epoch.

Modules:

* :mod:`.shardmap`  — the versioned partition→shard routing table (YAML
  ``Federation:`` section).
* :mod:`.usage`     — cluster-wide usage limits over gossiped summaries.
* :mod:`.shard`     — the per-shard lease plane grafted onto a local
  JobScheduler (reserve / confirm / release / expire / recover).
* :mod:`.arbiter`   — the cross-partition gang coordinator.
* :mod:`.rebalance` — hot-shard detection and live partition migration.
* :mod:`.query`     — scatter-gather fan-out with the ``max_staleness``
  read contract.
* :mod:`.sim`       — an in-process federated cluster harness; every
  shard's scheduler runs on the device the caller names.

The device path is the shards themselves: each one's scheduler solves
its own partitions through ``greedy_place`` on the card.
"""

from cranesched_tpu_torch.fed.shardmap import ShardMap, ShardSpec

__all__ = ["ShardMap", "ShardSpec"]
