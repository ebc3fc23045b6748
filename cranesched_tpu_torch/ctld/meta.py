"""Authoritative cluster state: nodes, partitions, the resource ledger.

The TPU-native counterpart of the reference's CranedMetaContainer
(reference: src/CraneCtld/Node/CranedMetaContainer.h:31 — per-node alive/
drain state, resource malloc/free, partition membership, and the
ResReduceEvent log :162-196 that captures concurrent resource reductions
during a scheduling cycle so the cycle's decisions can be re-validated
before commit).

Host-side this is plain Python + NumPy (it is the *ledger*, mutated by
events); each cycle exports a dense device snapshot via ``snapshot()``.
The two-phase pattern — device solve on the snapshot, host re-validation
against the live ledger at commit — is exactly the reference's
NodeSelect-then-ResReduceEvent-check design (JobScheduler.cpp:1437-1540).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from cranesched_tpu_torch.ops.resources import ResourceLayout


@dataclasses.dataclass
class Partition:
    """Reference PartitionMeta (NodeDefs.h:104-122): name, priority, node
    membership, account ACLs."""

    name: str
    priority: int = 0
    node_ids: set[int] = dataclasses.field(default_factory=set)
    allowed_accounts: set[str] | None = None   # None = all
    denied_accounts: set[str] = dataclasses.field(default_factory=set)

    def account_allowed(self, account: str) -> bool:
        if account in self.denied_accounts:
            return False
        return self.allowed_accounts is None or (
            account in self.allowed_accounts)


# NodeMeta fields that feed the device snapshot (avail/total rows and
# the schedulable flag): writes to these mark the node dirty so
# MetaContainer.snapshot() can patch its cached arrays instead of
# rebuilding.  last_ping/running_jobs are deliberately absent — a ping
# must not bump the meta epoch and wake an idle scheduler.
_SNAP_FIELDS = frozenset({"avail", "total", "alive", "drained",
                          "health_drained", "power_state", "fed_leased"})


@dataclasses.dataclass
class NodeMeta:
    """Reference CranedMeta (NodeDefs.h:59-81): static total + live avail,
    alive/drain flags, running job registry."""

    node_id: int
    name: str
    total: np.ndarray                    # int32[R], capacity encoding
    avail: np.ndarray                    # int32[R]
    alive: bool = False
    drained: bool = False
    partitions: set[str] = dataclasses.field(default_factory=set)
    running_jobs: set[int] = dataclasses.field(default_factory=set)
    # real node plane: craned's push address + liveness tracking
    # (reference CranedPing every 10 s, timeout 30 s, PublicHeader.h:145)
    address: str = ""
    last_ping: float = 0.0
    expect_pings: bool = False
    # power state (reference PublicDefs.proto:87-96: ACTIVE/IDLE/
    # SLEEPING/POWEREDOFF; transitions driven by control ops + plugins)
    power_state: str = "ACTIVE"
    # operator drain and health drain are SEPARATE flags (the reference
    # tracks distinct control/drain reasons): a recovering health check
    # must not clear a maintenance drain
    health_drained: bool = False
    health_message: str = ""          # last health-check report
    # interconnect position, stamped by MetaContainer.set_topology():
    # top-down group-name path (e.g. (switch, block)) and torus coords
    block_path: tuple = ()
    coords: tuple | None = None
    # federation: lease id while the node is reserved for the placement
    # arbiter's cross-partition gang solve (fed/shard.py).  Folding the
    # flag into ``schedulable`` excludes the node from snapshots AND
    # fails local malloc attempts for the lease's whole lifetime, so a
    # shard-local cycle can never race the arbiter onto the same node.
    fed_leased: str = ""

    @property
    def schedulable(self) -> bool:
        return (self.alive and not self.drained
                and not self.health_drained
                and not self.fed_leased
                and self.power_state != "POWEREDOFF")

    def __setattr__(self, name, value):
        # every mutation path in the tree (ledger, RPC handlers, HA
        # follower, health checks) is a plain attribute assignment of a
        # NEW value — never an in-place element write — so this hook is
        # the single chokepoint that keeps the container's cached
        # snapshot coherent.  During dataclass __init__ the owner
        # backref does not exist yet, so construction is a no-op here.
        object.__setattr__(self, name, value)
        if name in _SNAP_FIELDS:
            owner = self.__dict__.get("_owner")
            if owner is not None:
                owner._touch_node(self.node_id)


@dataclasses.dataclass
class Reservation:
    """Named time-windowed node carve-out (reference ResvMeta,
    NodeDefs.h:83-98; CreateReservationRequest Crane.proto:692-707):
    during [start_time, end_time) the nodes belong exclusively to jobs
    that name the reservation (and pass its ACL)."""

    name: str
    partition: str
    node_ids: set[int]
    start_time: float
    end_time: float
    allowed_accounts: set[str] | None = None   # None = all
    denied_accounts: set[str] = dataclasses.field(default_factory=set)

    def active(self, now: float) -> bool:
        return self.start_time <= now < self.end_time

    def expired(self, now: float) -> bool:
        return now >= self.end_time

    def account_allowed(self, account: str) -> bool:
        if account in self.denied_accounts:
            return False
        return (self.allowed_accounts is None
                or account in self.allowed_accounts)


@dataclasses.dataclass(frozen=True)
class ResReduceEvent:
    """A resource reduction that happened while a cycle was in flight
    (reference CranedMetaContainer.h:162-196): node died or was drained."""

    node_id: int


class MetaContainer:
    """Node/partition registry + resource ledger.

    Single-threaded by design: the gRPC layer serializes mutations onto the
    scheduler loop, so per-entry locks (the reference's AtomicHashMap) are
    unnecessary; the event log still exists because dispatch I/O can
    interleave with cycles.
    """

    def __init__(self, layout: ResourceLayout | None = None):
        self.layout = layout or ResourceLayout()
        self.nodes: dict[int, NodeMeta] = {}
        self.partitions: dict[str, Partition] = {}
        self._name_to_id: dict[str, int] = {}
        self._part_max_cache: dict[str, np.ndarray] = {}
        self._events: list[ResReduceEvent] = []
        self._logging = False
        self.reservations: dict[str, Reservation] = {}
        # bumped on any reservation change so mask caches invalidate
        self.resv_epoch = 0
        # bumped on any snapshot-relevant node mutation (see
        # _SNAP_FIELDS) — one term of the scheduler's no-op-cycle
        # fingerprint.  ``_dirty_nodes`` are the rows snapshot() must
        # patch in its cached arrays; ``delta_snapshot=False`` restores
        # the full per-node rebuild (oracle baseline for the parity
        # tests and bench --churn).
        self.meta_epoch = 0
        self._dirty_nodes: set[int] = set()
        self._snap: tuple | None = None
        self.delta_snapshot = True
        self.last_snapshot_dirty = 0
        # interconnect topology (topo.model.Topology), attached via
        # set_topology() once the node registry is complete
        self.topology = None
        # dirty-row fan-out beyond the snapshot cache: callables
        # ``fn(node_id)`` invoked from _touch_node on every
        # snapshot-relevant mutation.  The device-resident cluster
        # state (ctld/resident.py) registers here so it can scatter-
        # patch exactly the rows that moved instead of re-uploading
        # [N, R] every cycle.
        self.dirty_listeners: list = []

    # ---- partitions & node registry ----

    def add_partition(self, name: str, priority: int = 0,
                      allowed_accounts: Iterable[str] | None = None,
                      denied_accounts: Iterable[str] = ()) -> Partition:
        part = Partition(
            name=name, priority=priority,
            allowed_accounts=(set(allowed_accounts)
                              if allowed_accounts is not None else None),
            denied_accounts=set(denied_accounts))
        self.partitions[name] = part
        return part

    def add_node(self, name: str, total: np.ndarray,
                 partitions: Iterable[str] = ("default",)) -> NodeMeta:
        node_id = len(self.nodes)
        node = NodeMeta(node_id=node_id, name=name,
                        total=np.asarray(total, np.int32),
                        avail=np.asarray(total, np.int32).copy(),
                        partitions=set(partitions))
        self.nodes[node_id] = node
        self._name_to_id[name] = node_id
        node._owner = self        # arm the dirty-row hook (NodeMeta)
        self.meta_epoch += 1
        self._snap = None         # shape changed: next snapshot rebuilds
        for p in node.partitions:
            if p not in self.partitions:
                self.add_partition(p)
            self.partitions[p].node_ids.add(node_id)
            self._part_max_cache.pop(p, None)
        return node

    def node_by_name(self, name: str) -> NodeMeta:
        return self.nodes[self._name_to_id[name]]

    def partition_max_total(self, partition: str) -> np.ndarray:
        """Elementwise max of node totals in a partition — the submit-time
        'could this request ever fit one node' bound, cached so submit
        stays O(R) instead of O(nodes)."""
        cached = self._part_max_cache.get(partition)
        if cached is not None:
            return cached
        part = self.partitions.get(partition)
        out = np.zeros(self.layout.num_dims, np.int32)
        if part is not None:
            for i in part.node_ids:
                out = np.maximum(out, self.nodes[i].total)
        self._part_max_cache[partition] = out
        return out

    def update_node_total(self, node_id: int, new_total: np.ndarray) -> bool:
        """Apply a changed node capacity (dynamic craned re-registration
        with different hardware/cgroup limits).  ``avail`` moves by the
        delta so running allocations stay charged, and the per-partition
        max-total cache is invalidated — without that, a node
        re-registering with more (or fewer) resources would leave
        ``partition_max_total`` stale and submit-time feasibility wrong.
        Returns True iff the total actually changed."""
        node = self.nodes[node_id]
        new_total = np.asarray(new_total, np.int32)
        if new_total.shape != node.total.shape:
            raise ValueError(
                f"total shape {new_total.shape} != {node.total.shape}")
        if (new_total == node.total).all():
            return False
        delta = new_total - node.total
        shrank = bool((delta < 0).any())
        node.total = new_total
        node.avail = np.minimum(node.avail + delta, new_total)
        if shrank:
            # a shrink can invalidate an in-flight cycle's placements,
            # same as a node death — force commit-time revalidation
            self._log_event(ResReduceEvent(node_id))
        for p in node.partitions:
            self._part_max_cache.pop(p, None)
        return True

    # ---- interconnect topology (topo.model.Topology) ----

    def set_topology(self, topology) -> None:
        """Attach the interconnect topology and stamp each node's
        ``block_path``/``coords``.  Topology node ids must line up with
        the registry (build it after all nodes are added)."""
        if topology.num_nodes != len(self.nodes):
            raise ValueError(
                f"topology covers {topology.num_nodes} nodes but the "
                f"registry has {len(self.nodes)}")
        self.topology = topology
        for nid, node in self.nodes.items():
            node.block_path = topology.block_path(nid)
            node.coords = (
                tuple(int(c) for c in topology.coords[nid])
                if topology.coords is not None else None)

    # ---- reservations (reference CreateReservation handling +
    #      reservation scheduling domains, JobScheduler.cpp:6624-6732) ----

    def create_reservation(self, name: str, partition: str,
                           node_names: Iterable[str], start_time: float,
                           end_time: float,
                           allowed_accounts: Iterable[str] | None = None,
                           denied_accounts: Iterable[str] = ()
                           ) -> Reservation | None:
        """Returns None on conflict (name taken, unknown nodes, or node
        already in an overlapping reservation)."""
        if name in self.reservations or end_time <= start_time:
            return None
        ids = set()
        for nm in node_names:
            if nm not in self._name_to_id:
                return None
            ids.add(self._name_to_id[nm])
        part = self.partitions.get(partition)
        if part is None or not ids <= part.node_ids:
            return None
        for other in self.reservations.values():
            if (ids & other.node_ids
                    and start_time < other.end_time
                    and other.start_time < end_time):
                return None
        resv = Reservation(
            name=name, partition=partition, node_ids=ids,
            start_time=start_time, end_time=end_time,
            allowed_accounts=(set(allowed_accounts)
                              if allowed_accounts is not None else None),
            denied_accounts=set(denied_accounts))
        self.reservations[name] = resv
        self.resv_epoch += 1
        return resv

    def delete_reservation(self, name: str) -> bool:
        if name not in self.reservations:
            return False
        del self.reservations[name]
        self.resv_epoch += 1
        return True

    def purge_expired_reservations(self, now: float) -> list[str]:
        """Cycle-start cleanup (reference reservation cleanup thread +
        timers, JobScheduler.h:1471-1482)."""
        gone = [n for n, r in self.reservations.items() if r.expired(now)]
        for n in gone:
            del self.reservations[n]
        if gone:
            self.resv_epoch += 1
        return gone

    # ---- liveness (reference CranedUp/CranedDown,
    #      CranedMetaContainer.h:105-124) ----

    def craned_up(self, node_id: int) -> None:
        self.nodes[node_id].alive = True

    def craned_down(self, node_id: int) -> list[int]:
        """Mark dead; returns running jobs that must be terminated.  Logs a
        reduce event so an in-flight cycle revalidates."""
        node = self.nodes[node_id]
        node.alive = False
        self._log_event(ResReduceEvent(node_id))
        return sorted(node.running_jobs)

    def drain(self, node_id: int, drained: bool = True) -> None:
        self.nodes[node_id].drained = drained
        if drained:
            self._log_event(ResReduceEvent(node_id))

    # ---- ledger (reference MallocResourceFromNode :126 / free) ----

    @staticmethod
    def _per_node(req, count: int) -> list[np.ndarray]:
        """Normalize a single vector or a per-node list to a list."""
        if isinstance(req, np.ndarray) and req.ndim == 1:
            return [req] * count
        return list(req)

    def malloc_resource(self, job_id: int, node_ids: Iterable[int],
                        req) -> bool:
        """Atomically subtract from every node or none (host authoritative
        commit; the device solve already believed it fits).  ``req`` is a
        single [R] vector or a per-node list (task packing / exclusive
        allocations differ per node)."""
        node_ids = list(node_ids)
        nodes = [self.nodes[i] for i in node_ids]
        reqs = self._per_node(req, len(nodes))
        if not all(n.schedulable and (r <= n.avail).all()
                   for n, r in zip(nodes, reqs)):
            return False
        for n, r in zip(nodes, reqs):
            n.avail = n.avail - r
            n.running_jobs.add(job_id)
        return True

    def malloc_resource_batch(self, entries) -> list[bool]:
        """Commit a whole placed set in one call: ``entries`` is a list
        of (job_id, node_ids, req) handled sequentially in order, so an
        entry sees every earlier entry's subtraction exactly as
        per-entry ``malloc_resource`` calls would.  Returns the
        per-entry all-or-none outcomes.  This is the commit hot path at
        10^4–10^5 placements per cycle — one call, hoisted lookups,
        instead of a method call per job."""
        nodes = self.nodes
        per_node = self._per_node
        out: list[bool] = []
        for job_id, node_ids, req in entries:
            ns = [nodes[i] for i in node_ids]
            reqs = per_node(req, len(ns))
            if not all(n.schedulable and (r <= n.avail).all()
                       for n, r in zip(ns, reqs)):
                out.append(False)
                continue
            for n, r in zip(ns, reqs):
                n.avail = n.avail - r
                n.running_jobs.add(job_id)
            out.append(True)
        return out

    def free_resource(self, job_id: int, node_ids: Iterable[int],
                      req) -> None:
        node_ids = list(node_ids)
        reqs = self._per_node(req, len(node_ids))
        for i, r in zip(node_ids, reqs):
            node = self.nodes[i]
            if job_id in node.running_jobs:
                node.running_jobs.discard(job_id)
                node.avail = np.minimum(node.avail + r, node.total)

    # ---- mid-cycle event capture (reference StartLogging /
    #      GetResReduceEvents, consumed at JobScheduler.cpp:1466-1540) ----

    def start_logging(self) -> None:
        self._events.clear()
        self._logging = True

    def stop_logging(self) -> list[ResReduceEvent]:
        self._logging = False
        events, self._events = list(self._events), []
        return events

    def _log_event(self, ev: ResReduceEvent) -> None:
        if self._logging:
            self._events.append(ev)

    # ---- device snapshot ----

    def _touch_node(self, node_id: int) -> None:
        """NodeMeta.__setattr__ hook: a snapshot-relevant field moved."""
        self.meta_epoch += 1
        if self._snap is not None:
            self._dirty_nodes.add(node_id)
        for fn in self.dirty_listeners:
            fn(node_id)

    def snapshot(self):
        """Dense SoA arrays for the device solve, aligned by node_id.

        Returns (avail[N,R], total[N,R], alive[N]) as NumPy; the scheduler
        owns moving them to device and building per-job masks.

        Delta-based: the arrays are cached and only the rows dirtied
        since the last call are re-read from the ledger (O(dirty), not
        O(nodes)).  Callers must treat the result as read-only — the
        same arrays are returned every cycle (``jnp.asarray`` copies to
        device, and host-side consumers never write).
        """
        n = len(self.nodes)
        if (not self.delta_snapshot or self._snap is None
                or len(self._snap[2]) != n):
            r = self.layout.num_dims
            avail = np.zeros((n, r), np.int32)
            total = np.zeros((n, r), np.int32)
            alive = np.zeros(n, bool)
            for i, node in self.nodes.items():
                avail[i] = node.avail
                total[i] = node.total
                alive[i] = node.schedulable
            self.last_snapshot_dirty = n
            if self.delta_snapshot:
                self._snap = (avail, total, alive)
                self._dirty_nodes.clear()
            return avail, total, alive
        avail, total, alive = self._snap
        dirty = self._dirty_nodes
        self.last_snapshot_dirty = len(dirty)
        if dirty:
            nodes = self.nodes
            for i in dirty:
                node = nodes[i]
                avail[i] = node.avail
                total[i] = node.total
                alive[i] = node.schedulable
            dirty.clear()
        return avail, total, alive

    def partition_mask(self, partition: str, include: Iterable[str] = (),
                       exclude: Iterable[str] = ()) -> np.ndarray:
        """bool[N] eligibility from partition membership and
        include/exclude nodelists (precomputed host-side, reference
        GetNodesAndTrySchedule_ include/exclude handling)."""
        n = len(self.nodes)
        mask = np.zeros(n, bool)
        part = self.partitions.get(partition)
        if part is None:
            return mask
        for i in part.node_ids:
            mask[i] = True
        include = list(include)
        if include:
            inc = np.zeros(n, bool)
            for name in include:
                if name in self._name_to_id:
                    inc[self._name_to_id[name]] = True
            mask &= inc
        for name in exclude:
            if name in self._name_to_id:
                mask[self._name_to_id[name]] = False
        return mask
