"""Persistent structure-of-arrays over the pending queue.

The reference scheduler is event-triggered: its pending task map is a
live structure updated by submits/cancels/status events, and a cycle
consults it without rebuilding anything.  Our reproduction's cycle used
to walk every pending job in Python (`_pending_candidates`) and
re-encode every priority row (`_priority_sort`) each tick; at 100k+
pending jobs the prelude dominated even when nothing changed.

This table keeps one numpy row per pending job, written by the events
that can change it (submit / cancel / hold / modify / dep trigger /
requeue) and masked **vectorially** each cycle:

    candidate = live & ~template & ~held
                & begin <= now & dep_ready(now) & license_ok

so the per-cycle candidate scan is one vectorized pass, and the
priority/batch row build gathers straight from these columns instead of
touching Job objects.  ``epoch`` bumps on every mutation — the
scheduler's no-op-cycle fingerprint (scheduler.py `_cycle_fingerprint`)
is built from it.

Rows live in insertion order (append-only with tombstones, compacted
in-order when mostly dead), which preserves the dict-iteration candidate
order of the old Python loop exactly — required for bit-exact parity
with the from-scratch rebuild path (tests/test_delta_cycle.py).
"""

from __future__ import annotations

import numpy as np

# gate codes: why a live row is not a candidate this cycle.  The
# numeric order encodes the OLD loop's reason precedence (held beats
# begin beats deps beats licenses); -1 marks "never evaluated" so a
# fresh upsert always rewrites the job's pending_reason once.
GATE_NONE = -1          # freshly (re)written row, gate unknown
GATE_CANDIDATE = 0
GATE_HELD = 1
GATE_BEGIN = 2
GATE_DEP = 3
GATE_DEP_NEVER = 4
GATE_LICENSE = 5


class PendingTable:
    """SoA mirror of ``scheduler.pending`` (non-terminal rows only).

    All columns are plain numpy; the scheduler derives the values (it
    owns the Job/JobSpec semantics) and this class owns storage, the
    vectorized gate evaluation, and the epoch/dirty accounting.
    """

    def __init__(self, num_res: int, cap: int = 64):
        self.num_res = int(num_res)
        #: bumped on every upsert/remove — feeds the cycle fingerprint
        self.epoch = 0
        #: rows dirtied since the last candidates() call (trace column)
        self.last_dirty = 0
        self._dirty = 0
        self._row: dict[int, int] = {}     # job_id -> row index
        self._n = 0                        # rows used, incl. tombstones
        self._dead = 0
        # license-set interning: key 0 is the empty set (no licenses)
        self._lic_ids: dict[frozenset, int] = {frozenset(): 0}
        self.lic_sets: list[frozenset] = [frozenset()]
        self._alloc(max(int(cap), 8))

    def _alloc(self, cap: int) -> None:
        self.job_id = np.zeros(cap, np.int64)
        self.live = np.zeros(cap, bool)
        self.template = np.zeros(cap, bool)       # array parents
        self.held = np.zeros(cap, bool)
        self.begin = np.full(cap, -np.inf)        # begin_time gate
        self.dep = np.full(cap, -np.inf)          # dep-ready time
        self.dep_never = np.zeros(cap, bool)
        self.lic = np.zeros(cap, np.int32)        # license-set id
        self.gate = np.full(cap, GATE_NONE, np.int8)
        # priority-row attributes (gathered by _priority_sort)
        self.submit = np.zeros(cap, np.float64)
        self.qos = np.zeros(cap, np.int32)
        self.part = np.zeros(cap, np.int32)       # partition priority
        self.nnum = np.zeros(cap, np.int32)
        self.cpus = np.zeros(cap, np.float64)
        self.mem = np.zeros(cap, np.float64)
        self.acct = np.zeros(cap, np.int32)
        # batch-build attributes (gathered by _build_batch)
        self.tlimit = np.zeros(cap, np.int32)
        self.packed = np.zeros(cap, bool)         # needs the packed route
        self.req = np.zeros((cap, self.num_res), np.int32)
        # cached mask-table class id, valid iff cls_gen matches the
        # mask table's generation (derived state: no epoch bump)
        self.cls = np.zeros(cap, np.int32)
        self.cls_gen = np.full(cap, -1, np.int64)

    def __len__(self) -> int:
        return len(self._row)

    def __contains__(self, job_id: int) -> bool:
        return job_id in self._row

    def _grow(self) -> None:
        old, cap = self._n, len(self.job_id)
        new_cap = cap * 2
        for name in ("job_id", "live", "template", "held", "begin",
                     "dep", "dep_never", "lic", "gate", "submit", "qos",
                     "part", "nnum", "cpus", "mem", "acct", "tlimit",
                     "packed", "req", "cls", "cls_gen"):
            col = getattr(self, name)
            shape = (new_cap,) + col.shape[1:]
            fresh = np.zeros(shape, col.dtype)
            if name == "gate":
                fresh[:] = GATE_NONE
            elif name == "cls_gen":
                fresh[:] = -1
            elif name in ("begin", "dep"):
                fresh[:] = -np.inf
            fresh[:old] = col[:old]
            setattr(self, name, fresh)

    def lic_key(self, licenses) -> int:
        """Intern a license requirement mapping; 0 = no licenses."""
        if not licenses:
            return 0
        key = frozenset(licenses.items())
        lid = self._lic_ids.get(key)
        if lid is None:
            lid = len(self.lic_sets)
            self._lic_ids[key] = lid
            self.lic_sets.append(key)
        return lid

    def upsert(self, job_id: int, *, template, held, begin, dep,
               dep_never, lic, submit, qos, part, nnum, cpus, mem,
               acct, tlimit, packed, req) -> None:
        row = self._row.get(job_id)
        if row is None:
            if self._n == len(self.job_id):
                self._grow()
            row = self._n
            self._n += 1
            self._row[job_id] = row
            self.job_id[row] = job_id
            self.live[row] = True
        self.template[row] = template
        self.held[row] = held
        self.begin[row] = begin
        self.dep[row] = dep
        self.dep_never[row] = dep_never
        self.lic[row] = lic
        self.gate[row] = GATE_NONE       # force one reason rewrite
        self.submit[row] = submit
        self.qos[row] = qos
        self.part[row] = part
        self.nnum[row] = nnum
        self.cpus[row] = cpus
        self.mem[row] = mem
        self.acct[row] = acct
        self.tlimit[row] = tlimit
        self.packed[row] = packed
        self.req[row] = req
        self.cls_gen[row] = -1
        self.epoch += 1
        self._dirty += 1

    def remove(self, job_id: int) -> None:
        row = self._row.pop(job_id, None)
        if row is None:
            return
        self.live[row] = False
        self._dead += 1
        self.epoch += 1
        self._dirty += 1
        if self._dead > 64 and self._dead * 2 > self._n:
            self._compact()

    def _compact(self) -> None:
        """Drop tombstones, preserving insertion order."""
        keep = np.nonzero(self.live[:self._n])[0]
        k = len(keep)
        for name in ("job_id", "live", "template", "held", "begin",
                     "dep", "dep_never", "lic", "gate", "submit", "qos",
                     "part", "nnum", "cpus", "mem", "acct", "tlimit",
                     "packed", "req", "cls", "cls_gen"):
            col = getattr(self, name)
            col[:k] = col[keep]
        self._n = k
        self._dead = 0
        self._row = {int(j): i for i, j in enumerate(self.job_id[:k])}

    # ---- per-cycle vectorized evaluation ----

    def license_mask(self, license_ok) -> np.ndarray:
        """bool per interned license-set id, from a ``sufficient``-style
        predicate evaluated ONCE per unique set (satellite: the old loop
        re-checked identical sets once per job per tick)."""
        ok = np.ones(len(self.lic_sets), bool)
        for lid in range(1, len(self.lic_sets)):
            ok[lid] = license_ok(dict(self.lic_sets[lid]))
        return ok

    def candidates(self, now: float, lic_ok: np.ndarray):
        """One vectorized pass -> (candidate_rows, changed_rows, gates).

        ``candidate_rows`` are row indices in insertion order (== the
        old dict-iteration order); ``changed_rows``/``gates`` are the
        rows whose gate differs from the stored one, so the scheduler
        rewrites pending_reason for O(changed) jobs, not O(pending).
        Resets the dirty-row counter into ``last_dirty``.
        """
        self.last_dirty = self._dirty
        self._dirty = 0
        n = self._n
        if n == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int8))
        gate = np.zeros(n, np.int8)
        # reverse precedence order: later writes win, matching the old
        # loop's held > begin > deps > licenses reason priority
        np.putmask(gate, ~lic_ok[self.lic[:n]], GATE_LICENSE)
        blocked = self.dep[:n] > now
        np.putmask(gate, blocked, GATE_DEP)
        np.putmask(gate, blocked & self.dep_never[:n], GATE_DEP_NEVER)
        np.putmask(gate, self.begin[:n] > now, GATE_BEGIN)
        np.putmask(gate, self.held[:n], GATE_HELD)
        vis = self.live[:n] & ~self.template[:n]
        changed = np.nonzero(vis & (gate != self.gate[:n]))[0]
        self.gate[:n] = np.where(vis, gate, self.gate[:n])
        cand = np.nonzero(vis & (gate == GATE_CANDIDATE))[0]
        return cand, changed, gate[changed]

    def next_edge(self, now: float) -> float:
        """Earliest future time a gate flips without an event: the next
        begin_time or dep-satisfaction deadline strictly after ``now``.
        inf when no time-dependent gate is pending."""
        n = self._n
        if n == 0:
            return np.inf
        live = self.live[:n]
        edge = np.inf
        begin = self.begin[:n]
        m = live & (begin > now) & np.isfinite(begin)
        if m.any():
            edge = float(begin[m].min())
        dep = self.dep[:n]
        m = live & (dep > now) & np.isfinite(dep) & ~self.dep_never[:n]
        if m.any():
            edge = min(edge, float(dep[m].min()))
        return edge
