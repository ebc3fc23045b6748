"""Elastic federation: hot-shard detection and the live partition
migration coordinator.

A federation's partition->shard assignment is chosen once, at config
time, against a guess about load.  When the guess goes stale one shard
saturates — submit latency climbs, its server lock stays held, SLO
budget burns — while its peers idle.  This module closes that loop:

:class:`HotShardDetector`
    Watches per-shard signals from the obs plane (submit p99, lock-held
    share, SLO burn rate) and latches a shard *hot* only after the
    signal sustains — with a hysteresis band and a post-migration
    cooldown so a flapping signal can never drive a migration storm.

:class:`MigrationCoordinator`
    Drives one partition handoff end to end over the four-phase WAL
    protocol on :class:`~cranesched_tpu_torch.fed.shard.FedShardPlane`:

    1. **seal** the partition on the source (submits refuse, arbiter
       leases release, ``fed_migrate_begin`` durable),
    2. **export** the partition payload (nodes and placements by NAME),
    3. **import** on the destination — one WAL group creates every job
       under a fresh dest-local id (``fed_migrate_import``),
    4. **flip** the shard map: the successor map (epoch + 1) installs
       at the arbiter/routing layer; servers stamp the new epoch on
       replies and clients re-learn via the existing redirect-hint /
       ``learn_shard_map`` path,
    5. **commit** on the source (``fed_migrate_commit``): migrated jobs
       drop with no terminal stamps and the partition's nodes go dead.

    A source SIGKILL anywhere in flight is safe: recovery surfaces the
    bare ``fed_migrate_begin`` and :meth:`MigrationCoordinator.resolve`
    asks the destination ``has_import(mid)`` — adopted means commit,
    not adopted means abort.  Exactly one shard owns every job either
    way; the jobtrace ledger stays zero-lost / zero-doubled.

Endpoints are duck-typed "shard handles" (name -> object), the same
registry the :class:`~cranesched_tpu_torch.fed.arbiter.PlacementArbiter`
uses: in-process wrappers in fed/sim.py, RPC clients in a deploy.  The
coordinator needs ``seal`` / ``export`` / ``import_`` / ``commit`` /
``abort`` / ``has_import`` / ``unresolved`` on them.
"""

from __future__ import annotations

import dataclasses

from cranesched_tpu_torch.obs import REGISTRY as _OBS

_MET_MIGRATIONS = _OBS.counter(
    "crane_fed_migrations_total",
    "live partition migrations committed (source handed off)")
_MET_MIG_ABORTS = _OBS.counter(
    "crane_fed_migration_aborts_total",
    "live partition migrations aborted (handoff never adopted)")
_MET_MAP_EPOCH = _OBS.gauge(
    "crane_fed_map_epoch",
    "shard-map epoch this process currently routes by")
_MET_HOT = _OBS.gauge(
    "crane_fed_hot_shards",
    "shards currently latched hot by the rebalance detector")


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Thresholds and damping for :class:`HotShardDetector`.

    A shard samples *hot* when ANY signal crosses its hot threshold,
    and *cool* only when EVERY signal drops below ``cool_ratio`` times
    its threshold — the band between is the hysteresis dead zone:
    samples there neither extend a hot streak nor unlatch a hot shard.
    """

    submit_p99_hot_ms: float = 50.0   # submit latency p99
    lock_share_hot: float = 0.5       # fraction of wall time lock held
    slo_burn_hot: float = 1.0         # SLO burn rate (1.0 = at budget)
    cool_ratio: float = 0.6           # cool when below ratio*threshold
    sustain: int = 3                  # consecutive hot samples to latch
    cooldown_s: float = 300.0         # quiet period after a migration


class HotShardDetector:
    """Hysteresis-latched hot-shard detection over obs-plane samples.

    Push samples with :meth:`observe`; ask :meth:`decide` which shard
    (if any) warrants a migration.  Damping, in order:

    * **sustain**: ``sustain`` consecutive hot samples latch a shard —
      one spike never moves a partition;
    * **hysteresis**: once latched, only a genuinely *cool* sample
      unlatches; a flapping signal that dips into the dead zone and
      back keeps resetting the streak and never latches at all;
    * **cooldown**: after any migration the detector answers None for
      ``cooldown_s`` — back-to-back moves (thrash) are impossible by
      construction.

    Cold start (no samples) and a single-shard federation both decide
    None: there is nowhere to move load, so nothing is ever hot.
    """

    def __init__(self, config: DetectorConfig | None = None):
        self.config = config or DetectorConfig()
        self._streak: dict[str, int] = {}
        self._latched: dict[str, float] = {}  # shard -> latch time
        self._cooldown_until = float("-inf")

    def observe(self, shard: str, now: float,
                submit_p99_ms: float = 0.0,
                lock_held_share: float = 0.0,
                slo_burn: float = 0.0) -> bool:
        """Feed one sample; returns whether ``shard`` is latched hot."""
        cfg = self.config
        pairs = ((submit_p99_ms, cfg.submit_p99_hot_ms),
                 (lock_held_share, cfg.lock_share_hot),
                 (slo_burn, cfg.slo_burn_hot))
        hot = any(v >= lim for v, lim in pairs)
        cool = all(v < lim * cfg.cool_ratio for v, lim in pairs)
        if hot:
            self._streak[shard] = self._streak.get(shard, 0) + 1
            if (self._streak[shard] >= cfg.sustain
                    and shard not in self._latched):
                self._latched[shard] = now
                _MET_HOT.set(len(self._latched))
        else:
            self._streak[shard] = 0
            if cool and shard in self._latched:
                del self._latched[shard]
                _MET_HOT.set(len(self._latched))
        return shard in self._latched

    def decide(self, now: float, shards: list[str]) -> str | None:
        """The shard to unload, or None (cold start, single shard,
        cooldown, or nothing latched).  Ties break to the longest-hot
        shard — it has waited longest for relief."""
        if len(shards) < 2 or now < self._cooldown_until:
            return None
        latched = [s for s in shards if s in self._latched]
        if not latched:
            return None
        return min(latched, key=lambda s: (self._latched[s], s))

    def migrated(self, now: float) -> None:
        """A migration just ran: start the cooldown and drop every
        latch/streak — post-move load is a different regime and must
        re-earn its sustain from scratch."""
        self._cooldown_until = now + self.config.cooldown_s
        self._streak.clear()
        self._latched.clear()
        _MET_HOT.set(0)

    def stats(self) -> dict:
        return {"latched": sorted(self._latched),
                "cooldown_until": self._cooldown_until,
                "streaks": dict(self._streak)}


class MigrationCoordinator:
    """Drives live partition migrations over duck-typed shard handles.

    Holds the federation's current :class:`ShardMap` and installs
    successors through ``flip_map(new_map)`` — the caller's hook into
    wherever routing state lives (the sim's FederatedCluster, a real
    deployment's arbiter + servers).
    """

    def __init__(self, shard_map, handles: dict, flip_map):
        self.shard_map = shard_map
        self.handles = handles
        self.flip_map = flip_map
        #: migrations whose source died before acknowledging commit —
        #: :meth:`resolve` settles them after the source restarts
        self.pending_resolution: list[dict] = []
        _MET_MAP_EPOCH.set(shard_map.epoch)

    def migrate(self, partition: str, dest: str, now: float,
                on_exported=None) -> dict:
        """One full handoff of ``partition`` to shard ``dest``.

        ``on_exported(payload)`` is the chaos seam: it runs after the
        source's export, exactly where a source SIGKILL mid-handoff
        lands in the drills.  Returns a result doc; ``committed`` False
        means the source went down after the dest adopted — the jobs
        are safe on the dest and :meth:`resolve` finishes the paperwork
        when the source returns.
        """
        source = self.shard_map.shard_for_partition(partition)
        if not source:
            raise ValueError(f"partition {partition!r} not in the map")
        if dest == source:
            raise ValueError(f"partition {partition!r} already on "
                             f"{dest!r}")
        if dest not in self.shard_map.shards:
            raise ValueError(f"unknown destination shard {dest!r}")
        src_h = self.handles[source]
        dst_h = self.handles[dest]
        mid = (f"mig:{partition}:{self.shard_map.epoch}"
               f":{source}->{dest}")
        job_ids = src_h.seal(mid, partition, dest, now)
        payload = src_h.export(mid, partition)
        if on_exported is not None:
            on_exported(payload)
        jobs_imported = 0
        try:
            imported, _nodes = dst_h.import_(payload, now)
            jobs_imported = len(imported)
        except ValueError:
            # a structured refusal: the dest's two-phase import
            # validates and mallocs everything BEFORE its first WAL
            # write, so this genuinely means "not adopted" — annul
            # durably and re-open the partition where it is
            src_h.abort(mid, partition, now)
            _MET_MIG_ABORTS.inc()
            raise
        except Exception as exc:
            # the call died in flight — AMBIGUOUS: the dest may hold
            # the jobs durably (and a retried handle call may have
            # been the one that landed).  A blind abort here would
            # leave BOTH shards owning the jobs; ask the dest instead.
            try:
                adopted = bool(dst_h.has_import(mid))
            except Exception:
                adopted = None
            if adopted is None:
                # dest unreachable: the only safe move is none — the
                # partition stays sealed (no admits, no duplicates on
                # either side) and resolve() settles the begin later
                self.pending_resolution.append(
                    {"mid": mid, "partition": partition,
                     "source": source, "dest": dest,
                     "job_ids": list(job_ids)})
                raise RuntimeError(
                    f"dest {dest!r} unreachable after import ({exc}); "
                    f"partition {partition!r} stays sealed pending "
                    "resolution") from exc
            if not adopted:
                src_h.abort(mid, partition, now)
                _MET_MIG_ABORTS.inc()
                raise
            # adopted after all: fall through to flip + commit (the
            # exact dest-local ids live on the dest; the source only
            # needs the fact of adoption)
            jobs_imported = len(job_ids)
        # dest holds the jobs durably — the map may flip.  Flip BEFORE
        # the source commit: if the source dies in between, routing
        # already points at the shard that has the jobs, and resolve()
        # settles the source's begin record later.
        new_map = self.shard_map.with_partition_moved(partition, dest)
        self.flip_map(new_map)
        self.shard_map = new_map
        _MET_MAP_EPOCH.set(new_map.epoch)
        committed = True
        try:
            src_h.commit(mid, partition, now)
        except Exception:
            committed = False
            self.pending_resolution.append(
                {"mid": mid, "partition": partition, "source": source,
                 "dest": dest})
        _MET_MIGRATIONS.inc()
        return {"mid": mid, "partition": partition, "source": source,
                "dest": dest, "epoch": new_map.epoch,
                "jobs_sealed": len(job_ids),
                "jobs_imported": jobs_imported,
                "committed": committed}

    def resolve(self, source: str, now: float) -> list[dict]:
        """Settle ``source``'s unresolved begins (surfaced by its
        recovery, or queued here after an ambiguous import call): for
        each, ask the recorded dest whether the import happened —
        commit (the jobs live there; drop the source copies, and make
        sure the map routes to the dest first) or abort (they never
        left; unseal).  A dest that cannot ANSWER leaves its begin
        pending and the partition sealed — never guess: a blind abort
        against a dest that did adopt doubles every job."""
        src_h = self.handles[source]
        queued = [r for r in self.pending_resolution
                  if r["source"] == source]
        self.pending_resolution = [
            r for r in self.pending_resolution if r["source"] != source]
        seen = set()
        records = []
        for rec in list(src_h.unresolved()) + queued:
            if rec["mid"] in seen:
                continue
            seen.add(rec["mid"])
            records.append(rec)
        out = []
        for rec in records:
            dst_h = self.handles.get(rec.get("dest", ""))
            adopted = None
            if dst_h is not None:
                try:
                    adopted = bool(dst_h.has_import(rec["mid"]))
                except Exception:
                    adopted = None
            if adopted is True:
                if (self.shard_map.shard_for_partition(rec["partition"])
                        != rec["dest"]):
                    new_map = self.shard_map.with_partition_moved(
                        rec["partition"], rec["dest"])
                    self.flip_map(new_map)
                    self.shard_map = new_map
                    _MET_MAP_EPOCH.set(new_map.epoch)
                src_h.commit(rec["mid"], rec["partition"], now)
                out.append(dict(rec, resolution="commit"))
            elif adopted is False:
                src_h.abort(rec["mid"], rec["partition"], now)
                _MET_MIG_ABORTS.inc()
                out.append(dict(rec, resolution="abort"))
            else:
                self.pending_resolution.append(
                    dict(rec, source=source))
                out.append(dict(rec, resolution="pending"))
        return out
