"""Placement arbiter: the one thin coordinator in the federation.

Everything partition-local schedules on its shard with zero cross-shard
traffic.  The arbiter owns exactly one job class — cross-partition
gangs, which need nodes from partitions living on different shards —
and commits them with a two-phase protocol over the shards' WALs:

1. **Reserve**: lease concrete nodes from each involved shard
   (``LeaseNodes`` → a durable ``fed_reserve`` record under the
   shard's fencing epoch; the nodes vanish from that shard's local
   scheduling while leased).
2. **Confirm**: turn each lease into a RUNNING shard-local gang member
   (``ConfirmGang`` → ``fed_confirm`` + the member's job records in
   ONE WAL group).  Only the confirm creates a job, so a shard crash
   between the phases leaves a bare reserve that the shard's recovery
   releases — never a double placement, never a half-placed gang that
   survives as state.

If any confirm fails (shard died, fencing epoch moved), the arbiter
*aborts*: already-confirmed members are cancelled through the normal
cancel path, unconfirmed leases are released, and the gang goes back in
the queue for a later pump.  The abort is idempotent against a crashed
shard — its recovery drops the reserve on its own.

Member sizing mirrors the topology solver's best-fit-block discipline
one level up, with shards as the blocks: a gang is first tried whole in
the single partition with the tightest fit, and only split across
partitions (fewest first) when no single one can host it — the same
"smallest sufficient block, least fragmentation" rule
``topo/place.py`` applies to switch blocks.
"""

from __future__ import annotations

import dataclasses
import itertools

from cranesched_tpu_torch.ctld.defs import JobSpec
from cranesched_tpu_torch.obs import REGISTRY as _OBS
from cranesched_tpu_torch.obs.events import EventLog

_MET_COMMITS = _OBS.counter(
    "crane_fed_arbiter_commits_total",
    "cross-partition gangs fully confirmed by the arbiter")
_MET_ABORTS = _OBS.counter(
    "crane_fed_arbiter_aborts_total",
    "cross-partition gang commits undone after a partial confirm")


@dataclasses.dataclass
class GangRequest:
    """A cross-partition gang: ``node_num`` nodes total, drawn from any
    of ``partitions`` (each possibly on a different shard)."""

    name: str
    node_num: int
    partitions: tuple[str, ...]
    spec: JobSpec  # template: res/user/account/time_limit/sim knobs
    gang_id: str = ""
    attempts: int = 0


class PlacementArbiter:
    """Coordinates gang placement across shard handles.

    ``handles``: shard name -> an object with the shard-plane surface
    (``free_count`` / ``lease`` / ``confirm`` / ``release`` /
    ``cancel``) — in-process wrappers in fed/sim.py, RPC clients in a
    real deploy.  The arbiter itself is synchronous and stateless
    between pumps except for its retry queue: all durable state lives
    in the shards' WALs.
    """

    #: leases self-expire on the shard this many (virtual) seconds
    #: after reserve — a dead arbiter never strands capacity
    LEASE_TTL = 120.0
    #: give up on a gang after this many failed pumps
    MAX_ATTEMPTS = 100

    def __init__(self, shard_map, handles: dict, events=None):
        self.shard_map = shard_map
        self.handles = handles
        self.events = events if events is not None else EventLog()
        self.queue: list[GangRequest] = []
        self._ids = itertools.count(1)
        self.committed: dict[str, dict[str, list[int]]] = {}
        self.stats = {"commits": 0, "aborts": 0, "failed": 0}

    def submit_gang(self, gang: GangRequest) -> str:
        gang.gang_id = gang.gang_id or f"gang-{next(self._ids)}"
        self.queue.append(gang)
        return gang.gang_id

    # -- placement --

    def _plan(self, gang: GangRequest, now: float
              ) -> list[tuple[str, str, int]] | None:
        """-> [(shard, partition, count)] or None when nothing fits.
        Best-fit-block over shards: whole-gang in the single partition
        with the least leftover, else split across partitions taking
        the fullest-fitting first."""
        free: list[tuple[str, str, int]] = []
        for part in gang.partitions:
            shard = self.shard_map.shard_for_partition(part)
            handle = self.handles.get(shard)
            if handle is None:
                continue
            try:
                n = handle.free_count(part, gang.spec)
            except Exception:
                continue  # shard unreachable — plan around it
            if n > 0:
                free.append((shard, part, n))
        whole = [(n, shard, part) for shard, part, n in free
                 if n >= gang.node_num]
        if whole:
            _n, shard, part = min(whole)  # tightest fit
            return [(shard, part, gang.node_num)]
        plan, remaining = [], gang.node_num
        for shard, part, n in sorted(free, key=lambda t: -t[2]):
            take = min(remaining, n)
            plan.append((shard, part, take))
            remaining -= take
            if remaining == 0:
                return plan
        return None

    def _member_spec(self, gang: GangRequest, partition: str,
                     count: int) -> JobSpec:
        return dataclasses.replace(
            gang.spec, name=f"{gang.name}@{partition}",
            partition=partition, node_num=count)

    def pump(self, now: float) -> list[str]:
        """One arbiter round: try every queued gang once.  Returns the
        gang ids committed this round."""
        done: list[str] = []
        retry: list[GangRequest] = []
        for gang in self.queue:
            if self._try_place(gang, now):
                done.append(gang.gang_id)
            else:
                gang.attempts += 1
                if gang.attempts >= self.MAX_ATTEMPTS:
                    self.stats["failed"] += 1
                else:
                    retry.append(gang)
        self.queue = retry
        return done

    def _try_place(self, gang: GangRequest, now: float) -> bool:
        plan = self._plan(gang, now)
        if plan is None:
            return False
        # phase one: reserve every member's nodes
        leases: list[tuple[str, str, str, int, list, int]] = []
        for i, (shard, part, count) in enumerate(plan):
            lease_id = f"{gang.gang_id}.{i}"
            try:
                names, epoch, _seq = self.handles[shard].lease(
                    lease_id, part, count,
                    self._member_spec(gang, part, count),
                    self.LEASE_TTL, now)
            except Exception:
                for sh, lid, *_ in leases:
                    self._release(sh, lid, now)
                return False
            leases.append((shard, lease_id, part, count, names, epoch))
        # phase two: confirm member by member
        confirmed: list[tuple[str, int]] = []
        for shard, lease_id, part, count, names, epoch in leases:
            spec = self._member_spec(gang, part, count)
            try:
                job_id = self.handles[shard].confirm(
                    lease_id, gang.gang_id, spec, names, now, epoch)
            except Exception as e:
                # abort: cancel what committed, release what didn't.
                # A dead shard's reserve is dropped by its own recovery;
                # both calls below tolerate an unreachable handle.
                for sh, jid in confirmed:
                    self._cancel(sh, jid, now)
                # release everything — a no-op for leases already
                # consumed by a successful confirm
                for sh, lid, *_ in leases:
                    self._release(sh, lid, now)
                self.events.emit(
                    "fed_arbiter_abort", "warning", time=now,
                    detail=f"gang={gang.gang_id} shard={shard}: {e}")
                _MET_ABORTS.inc()
                self.stats["aborts"] += 1
                return False
            confirmed.append((shard, job_id))
        self.committed[gang.gang_id] = {
            sh: [] for sh in {s for s, _ in confirmed}}
        for sh, jid in confirmed:
            self.committed[gang.gang_id][sh].append(jid)
        self.events.emit(
            "fed_arbiter_commit", "info", time=now,
            detail=f"gang={gang.gang_id} members="
                   f"{','.join(f'{s}:{j}' for s, j in confirmed)}")
        _MET_COMMITS.inc()
        self.stats["commits"] += 1
        return True

    def _release(self, shard: str, lease_id: str, now: float) -> None:
        try:
            self.handles[shard].release(lease_id, now)
        except Exception:
            pass  # dead shard: its recovery drops the reserve

    def _cancel(self, shard: str, job_id: int, now: float) -> None:
        try:
            self.handles[shard].cancel(job_id, now)
        except Exception:
            pass  # dead shard: the member's records replay, but its
            # gang siblings were never confirmed — the caller re-places
