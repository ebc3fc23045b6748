"""Cluster-wide accounting: per-user/per-account usage summaries
gossiped between shards so global MaxJobs/MaxSubmitJobs and fair-share
hold across the federation under a bounded-staleness contract.

The reference enforces these limits in ONE AccountMetaContainer behind
striped locks (AccountMetaContainer.h:70-265) — trivially globally
consistent, trivially a scaling wall.  Sharded, each controller owns
only its partitions' jobs, so a per-user limit needs the *other*
shards' counts.  This module is the shard-local half of that exchange:

:class:`UsageBook`
    One per shard.  Counts the shard's own live jobs (running) and
    submit slots (pending + running) per user and per account,
    publishes them as a ``durable_seq``-stamped document
    (FetchUsage / the sim's gossip pump), ingests the other shards'
    documents, and answers the conservative admission question.

**The soundness contract.**  Remote counts are stale by up to the
gossip interval; a naive ``local + remote < L`` check would overshoot
L by however many admissions every other shard performed since it last
published.  The book therefore enforces two rules:

1. *Publish throttle*: a shard that has admitted ``publish_slack``
   (B) jobs beyond what its slowest peer has CONFIRMED receiving
   stops admitting until that peer pulls again.  Delivery is what
   counts, not the act of building a summary document: each admission
   bumps a monotone ``_admitted`` counter, and a peer's successful
   pull (FetchUsage with its shard name / the sim's pump) records an
   ack at the current counter.  The throttle gates on
   ``_admitted - min(peer acks)`` — so for ANY observer, at every
   instant, ``true_remote <= known_remote + (S-1)*B``.  (A book built
   without a ``peers`` roster falls back to acking on publish itself —
   the single-consumer sim/unit-test shape.)
2. *Conservative gate*: admit only while
   ``local + known_remote + 1 <= L - (S-1)*B``.

Together: the cluster-wide count can NEVER exceed L — the documented
overshoot bound is zero; staleness converts into early (conservative)
denials of at most ``(S-1)*B`` slots, never into an overshoot.  A peer
that stops pulling freezes its ack, so this shard stops admitting at
B-beyond-acked instead of silently outrunning what that peer knows.
Decrements (job finish) travelling late only make ``known_remote`` an
over-estimate, which again errs toward denial.  With ``B = 0`` the
operator promises synchronous publishing (publish after every
admission before the next admission anywhere — staleness 0); the gate
then has zero slack and admits exactly the set a single controller
would: bit-exact against the single-container oracle.

Fair-share rides the same documents: per-account running-job counts
feed the priority model's service sum (models/priority.py
``extra_service``) so an account burning capacity on another shard
sinks in the local queue too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from cranesched_tpu_torch.ctld.accounting import UNLIMITED
from cranesched_tpu_torch.obs import REGISTRY as _OBS

_MET_STALENESS = _OBS.gauge(
    "crane_fed_usage_staleness_seconds",
    "age of the oldest remote usage summary this shard holds")
_MET_DENIED = _OBS.counter(
    "crane_fed_usage_denied_total",
    "submissions denied by the conservative global-limit gate")
_MET_PUBLISH = _OBS.counter(
    "crane_fed_usage_publish_total",
    "usage summaries published by this shard")


@dataclasses.dataclass(frozen=True)
class GlobalLimits:
    """Federation-wide limits (YAML ``Federation: Limits:``).  These
    bound the CLUSTER total per user/account — the per-shard QoS
    limits (ctld/accounting.py) still apply on top, per shard."""

    max_jobs_per_user: int = UNLIMITED
    max_submit_jobs_per_user: int = UNLIMITED
    max_jobs_per_account: int = UNLIMITED
    max_submit_jobs_per_account: int = UNLIMITED

    @classmethod
    def from_config(cls, section: dict) -> "GlobalLimits":
        def _lim(key):
            v = section.get(key)
            return UNLIMITED if v in (None, "", 0) else int(v)
        return cls(
            max_jobs_per_user=_lim("MaxJobsPerUser"),
            max_submit_jobs_per_user=_lim("MaxSubmitJobsPerUser"),
            max_jobs_per_account=_lim("MaxJobsPerAccount"),
            max_submit_jobs_per_account=_lim("MaxSubmitJobsPerAccount"))

    @property
    def any_set(self) -> bool:
        return any(v != UNLIMITED for v in (
            self.max_jobs_per_user, self.max_submit_jobs_per_user,
            self.max_jobs_per_account,
            self.max_submit_jobs_per_account))


@dataclasses.dataclass
class _Counts:
    jobs: int = 0          # running
    submit_jobs: int = 0   # pending + running
    # run slots admitted this cycle but not yet in the running dict:
    # the scheduler's batch commit checks every candidate BEFORE any
    # insert, so without reservations one cycle could blow through the
    # global cap (N admissions each seeing jobs=0)
    reserved: int = 0


class UsageBook:
    """One shard's view of federation-wide usage.

    ``seq_source`` supplies the shard's WAL ``durable_seq`` for
    stamping published documents — a reader can order two summaries
    from the same shard and a bounded-staleness client can refuse one
    that is too old, mirroring the query plane's contract.
    """

    def __init__(self, shard: str, limits: GlobalLimits | None = None,
                 n_shards: int = 1, publish_slack: int = 1,
                 seq_source: Callable[[], int] | None = None,
                 peers: tuple = ()):
        self.shard = shard
        self.limits = limits or GlobalLimits()
        self.n_shards = max(int(n_shards), 1)
        if publish_slack < 0:
            raise ValueError("publish_slack must be >= 0")
        self.publish_slack = int(publish_slack)
        self.seq_source = seq_source
        self._user: dict[str, _Counts] = {}
        self._acct: dict[str, _Counts] = {}
        # shard -> its last published doc (ingested verbatim)
        self._remote: dict[str, dict] = {}
        self._remote_at: dict[str, float] = {}  # local receive time
        # delivery-confirmed throttle state: admissions are a monotone
        # counter, each peer acks the counter value it has seen (its
        # last successful pull), and the throttle gates on the SLOWEST
        # peer's lag — never on the act of building a document
        self.peers = tuple(p for p in peers if p and p != shard)
        self._admitted = 0
        self._peer_acked: dict[str, int] = {p: 0 for p in self.peers}
        # no-roster fallback (direct construction in unit tests / the
        # single-consumer sim): publish() itself counts as delivery
        self._published_floor = 0
        self.denied = 0

    # ---- local bookkeeping (scheduler hooks) ----

    def _c(self, table: dict, key: str) -> _Counts:
        c = table.get(key)
        if c is None:
            c = table[key] = _Counts()
        return c

    def note_submit(self, user: str, account: str) -> None:
        """A submit slot was taken locally (admission already passed —
        recovery/migration restores call this without re-checking)."""
        self._c(self._user, user).submit_jobs += 1
        if account:
            self._c(self._acct, account).submit_jobs += 1
        self._admitted += 1

    def note_release_submit(self, user: str, account: str) -> None:
        u = self._user.get(user)
        if u is not None and u.submit_jobs > 0:
            u.submit_jobs -= 1
        a = self._acct.get(account) if account else None
        if a is not None and a.submit_jobs > 0:
            a.submit_jobs -= 1

    def note_run(self, user: str, account: str, delta: int) -> None:
        """A job entered (+1) or left (-1) the running set locally."""
        u = self._c(self._user, user)
        u.jobs = max(u.jobs + delta, 0)
        if account:
            a = self._c(self._acct, account)
            a.jobs = max(a.jobs + delta, 0)
        if delta > 0:
            self._admitted += delta

    def reserve_run(self, user: str, account: str) -> None:
        """Hold a run slot between admission and the running-dict
        insert (same cycle, same lock).  The insert converts it via
        :meth:`unreserve_run` + :meth:`note_run`; an admission that
        fails to commit releases it through the scheduler's symmetric
        free path."""
        self._c(self._user, user).reserved += 1
        if account:
            self._c(self._acct, account).reserved += 1

    def unreserve_run(self, user: str, account: str) -> None:
        u = self._user.get(user)
        if u is not None and u.reserved > 0:
            u.reserved -= 1
        a = self._acct.get(account) if account else None
        if a is not None and a.reserved > 0:
            a.reserved -= 1

    # ---- the conservative admission gate ----

    def _slack(self) -> int:
        return (self.n_shards - 1) * self.publish_slack

    def unconfirmed(self) -> int:
        """Admissions the slowest consumer has NOT confirmed seeing —
        the quantity the publish throttle bounds at ``publish_slack``.
        With a peer roster this is the monotone admission counter minus
        the minimum per-peer ack; without one (no ``peers`` given),
        admissions since the last :meth:`publish`."""
        if self._peer_acked:
            return self._admitted - min(self._peer_acked.values())
        return self._admitted - self._published_floor

    def _remote_sum(self, table: str, key: str, field: str) -> int:
        total = 0
        for doc in self._remote.values():
            entry = doc.get(table, {}).get(key)
            if entry:
                total += int(entry.get(field, 0))
        return total

    def check_submit(self, user: str, account: str) -> str:
        """'' when a new submit may be admitted under the global
        MaxSubmitJobs limits, else the refusal reason.  Does NOT take
        the slot — call :meth:`note_submit` after the local admission
        actually happens (the caller holds the shard lock, so the
        check-then-take pair cannot race locally)."""
        lim = self.limits
        if not lim.any_set:
            return ""
        if (self.publish_slack > 0
                and self.unconfirmed() >= self.publish_slack):
            # rule 1: our own count is about to outrun what the
            # slowest peer has CONFIRMED knowing about us — hold
            # admissions until it pulls again
            self.denied += 1
            _MET_DENIED.inc()
            return ("global limit gate: usage publish overdue "
                    f"({self.unconfirmed()} unconfirmed admissions)")
        slack = self._slack()
        checks = [("user", user, lim.max_submit_jobs_per_user,
                   "global MaxSubmitJobsPerUser")]
        if account:
            checks.append(("acct", account,
                           lim.max_submit_jobs_per_account,
                           "global MaxSubmitJobsPerAccount"))
        for table, key, limit, label in checks:
            if limit == UNLIMITED:
                continue
            local = (self._user if table == "user" else
                     self._acct).get(key)
            known = ((local.submit_jobs if local else 0)
                     + self._remote_sum(table, key, "submit_jobs"))
            if known + 1 > limit - slack:
                self.denied += 1
                _MET_DENIED.inc()
                return (f"{label} reached "
                        f"({known}/{limit}, staleness slack {slack})")
        return ""

    def check_run(self, user: str, account: str) -> str:
        """'' when one more RUNNING job fits under the global MaxJobs
        limits (the schedule-commit gate), else the reason."""
        lim = self.limits
        if not lim.any_set:
            return ""
        if (self.publish_slack > 0
                and self.unconfirmed() >= self.publish_slack):
            self.denied += 1
            _MET_DENIED.inc()
            return "global limit gate: usage publish overdue"
        slack = self._slack()
        checks = [("user", user, lim.max_jobs_per_user,
                   "global MaxJobsPerUser")]
        if account:
            checks.append(("acct", account, lim.max_jobs_per_account,
                           "global MaxJobsPerAccount"))
        for table, key, limit, label in checks:
            if limit == UNLIMITED:
                continue
            local = (self._user if table == "user" else
                     self._acct).get(key)
            known = ((local.jobs + local.reserved if local else 0)
                     + self._remote_sum(table, key, "jobs"))
            if known + 1 > limit - slack:
                self.denied += 1
                _MET_DENIED.inc()
                return (f"{label} reached "
                        f"({known}/{limit}, staleness slack {slack})")
        return ""

    # ---- the gossip wire (FetchUsage / the sim's pump) ----

    def publish(self, now: float, peer: str = "") -> dict:
        """This shard's usage summary, durable_seq-stamped.

        ``peer`` names the shard this document is being DELIVERED to
        (the FetchUsage handler passes the puller's shard name, under
        the same lock that built the document): that peer's throttle
        ack advances to the current admission counter — the counts
        below are exactly what it will know about us.  An anonymous
        publish (CLI inspection, ``peer=""``) releases nothing, unless
        the book has no peer roster at all (the no-roster fallback
        treats any publish as the one consumer's delivery)."""
        doc = {
            "shard": self.shard,
            "time": now,
            "durable_seq": (self.seq_source() if self.seq_source
                            else 0),
            "user": {u: {"jobs": c.jobs, "submit_jobs": c.submit_jobs}
                     for u, c in sorted(self._user.items())
                     if c.jobs or c.submit_jobs},
            "acct": {a: {"jobs": c.jobs, "submit_jobs": c.submit_jobs}
                     for a, c in sorted(self._acct.items())
                     if c.jobs or c.submit_jobs},
        }
        if peer and peer in self._peer_acked:
            self._peer_acked[peer] = self._admitted
        elif not self._peer_acked:
            self._published_floor = self._admitted
        _MET_PUBLISH.inc()
        return doc

    def ingest(self, doc: dict, now: float) -> None:
        """Adopt another shard's summary.  Last-writer-wins per shard,
        ordered by durable_seq — a re-delivered older summary must not
        roll the view backwards."""
        shard = str(doc.get("shard", ""))
        if not shard or shard == self.shard:
            return
        prev = self._remote.get(shard)
        if prev is not None and int(prev.get("durable_seq", 0)) > int(
                doc.get("durable_seq", 0)):
            return
        self._remote[shard] = doc
        self._remote_at[shard] = now
        _MET_STALENESS.set(self.staleness(now), shard=self.shard)

    def forget(self, shard: str) -> None:
        """Drop a departed shard's summary (map shrink) — and its
        throttle ack, so a removed peer cannot freeze admissions
        forever."""
        self._remote.pop(shard, None)
        self._remote_at.pop(shard, None)
        self._peer_acked.pop(shard, None)

    def staleness(self, now: float) -> float:
        """Age of the OLDEST remote summary held; 0 with no remotes
        (single shard == nothing to be stale about)."""
        if not self._remote_at:
            return 0.0
        return max(0.0, now - min(self._remote_at.values()))

    # ---- fair-share input (models/priority.py extra_service) ----

    def remote_account_jobs(self) -> dict[str, int]:
        """Per-account running-job counts summed over the remote
        summaries — the cluster-wide service signal for the fair-share
        factor.  Counts, not TRES-seconds: a cross-shard approximation
        that is monotone in remote load, which is all the normalized
        fair-share factor consumes."""
        out: dict[str, int] = {}
        for doc in self._remote.values():
            for acct, entry in doc.get("acct", {}).items():
                jobs = int(entry.get("jobs", 0))
                if jobs:
                    out[acct] = out.get(acct, 0) + jobs
        return out

    def stats(self) -> dict:
        return {
            "shard": self.shard,
            "unpublished": self.unconfirmed(),
            "admitted": self._admitted,
            "peer_acked": dict(self._peer_acked),
            "remotes": sorted(self._remote),
            "denied": self.denied,
            "users": {u: dataclasses.asdict(c)
                      for u, c in sorted(self._user.items())},
        }


def effective_publish_slack(limits: GlobalLimits, n_shards: int,
                            slack: int) -> tuple[int, int]:
    """Clamp ``slack`` so the conservative gate stays satisfiable.

    The gate admits only while ``known + 1 <= L - (S-1)*B``; a
    configured B with ``(S-1)*B >= L`` for any finite global limit L
    would deny EVERY admission forever, even on an idle cluster.  The
    largest satisfiable B leaves at least one admissible slot under
    the smallest limit: ``B <= (L_min - 1) // (S - 1)``.

    Returns ``(effective, configured)`` — ``effective < configured``
    means the caller should warn loudly that staleness tolerance was
    reduced to keep the limits reachable."""
    slack = max(int(slack), 0)
    finite = [v for v in (limits.max_jobs_per_user,
                          limits.max_submit_jobs_per_user,
                          limits.max_jobs_per_account,
                          limits.max_submit_jobs_per_account)
              if v != UNLIMITED]
    if not finite or n_shards < 2 or slack == 0:
        return slack, slack
    max_ok = max((min(finite) - 1) // (n_shards - 1), 0)
    return min(slack, max_ok), slack
