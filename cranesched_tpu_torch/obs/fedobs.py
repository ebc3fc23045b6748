"""Federation-wide observability (port of ``cranesched_tpu/obs/fedobs.py``):
scatter-gather metric aggregation and a cluster-level SLO engine over
per-shard summaries.

The federation silently demoted the observability plane to
per-shard scope: ``cstats --slo`` against a shard shows THAT shard's
burn rates, and nothing computes the number the storm drills need —
the cluster-wide burn over every shard's samples.  This module rides
the existing ``fed/query.py`` stats fan-out (no new RPC): each
``StatsReply`` already carries the shard's full ``REGISTRY.snapshot()``
and its ``SloEngine.evaluate()`` table plus a ``durable_seq``
provenance stamp, so the merge is pure client-side arithmetic.

The burn-rate merge is EXACT, not an average of averages.  A shard row
reports ``burn = (bad/n)/allowed`` with ``allowed = max(1-p/100,
1e-3)`` — both ``n`` (window count) and ``allowed`` (from ``p``) ride
the row, so the per-shard bad count reconstructs exactly::

    bad_i     = round(burn_i * allowed * n_i)
    burn_clu  = (sum bad_i / sum n_i) / allowed

which equals what one controller holding all samples would compute
(the acceptance oracle), up to the bounded-staleness contract: a shard
answering from a follower lags by at most ``max_staleness`` seconds of
samples.  Observed percentile latency cannot be merged exactly from
percentiles, so the cluster row reports the conservative ``max`` over
shards and says so.

Metric snapshots merge by kind: counters and histograms are extensive
(sums over disjoint shard populations -> add them), gauges are not
(adding two shards' queue depths is meaningful, but adding two shards'
"seconds since X" is nonsense) -> gauges keep one row per shard with a
``shard=`` label prefixed, same convention as the ``cqueue`` merge.
"""

from __future__ import annotations

import threading
from typing import Mapping

from cranesched_tpu_torch.obs.metrics import REGISTRY as _OBS

_MET_BURN = _OBS.gauge(
    "crane_fed_slo_burn_rate",
    "Cluster-level error-budget burn rate per SLO and window "
    "(exact merge over per-shard counts)")
_MET_BREACH = _OBS.counter(
    "crane_fed_slo_breaches_total",
    "Cluster-level SLO breach onsets (edge-triggered per slo+window)")
_MET_STALE = _OBS.gauge(
    "crane_fed_slo_staleness_seconds",
    "Age of each shard's slice in the last federated merge")


def _shard_key(key: str, shard: str) -> str:
    """Prefix a ``shard=`` label onto a snapshot label-string key."""
    inner = f'shard="{shard}"'
    if not key or key == "{}":
        return "{" + inner + "}"
    return "{" + inner + "," + key[1:]


def merge_metric_snapshots(
        shard_snaps: Mapping[str, Mapping]) -> dict:
    """Merge per-shard ``REGISTRY.snapshot()`` docs into one cluster
    view: counters/histograms summed per label set, gauges kept
    per-shard under an added ``shard=`` label."""
    out: dict[str, dict] = {}
    for shard in sorted(shard_snaps):
        snap = shard_snaps[shard] or {}
        for name, ent in snap.items():
            kind = ent.get("type", "counter")
            dst = out.setdefault(name, {"type": kind, "values": {}})
            vals = dst["values"]
            for key, v in ent.get("values", {}).items():
                if kind == "gauge":
                    vals[_shard_key(key, shard)] = v
                elif kind == "histogram":
                    cur = vals.setdefault(key,
                                          {"count": 0, "sum": 0.0})
                    cur["count"] += v.get("count", 0)
                    cur["sum"] += v.get("sum", 0.0)
                else:
                    vals[key] = vals.get(key, 0.0) + v
    return out


class ClusterSlo:
    """Merges per-shard SLO tables into cluster rows and keeps the
    breach edge-trigger state across merges (one counter bump per
    onset, like the per-shard engine)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._burning: dict[tuple[str, str], bool] = {}

    def merge(self,
              shard_tables: Mapping[str, list]) -> list[dict]:
        """``{shard: SloEngine.evaluate() table}`` -> cluster table in
        the same row schema, plus ``shards``/``shard_counts`` fields
        for provenance."""
        # group the shard rows by SLO name (specs are config-driven
        # and identical across shards; a shard missing a row simply
        # contributes nothing to it)
        by_name: dict[str, dict[str, dict]] = {}
        order: list[str] = []
        for shard in sorted(shard_tables):
            for row in shard_tables[shard] or []:
                name = row.get("name", "")
                if name not in by_name:
                    by_name[name] = {}
                    order.append(name)
                by_name[name][shard] = row
        out = []
        with self._lock:
            for name in order:
                rows = by_name[name]
                proto = next(iter(rows.values()))
                p = float(proto.get("p", 99))
                allowed = max(1.0 - p / 100.0, 1e-3)
                clu = {"name": name, "from": proto.get("from"),
                       "to": proto.get("to"), "p": p,
                       "target_seconds": proto.get("target_seconds"),
                       "shards": sorted(rows), "windows": {}}
                wkeys: list[str] = []
                for row in rows.values():
                    for wk in row.get("windows", {}):
                        if wk not in wkeys:
                            wkeys.append(wk)
                for wk in wkeys:
                    n = 0
                    bad = 0
                    observed = 0.0
                    counts = {}
                    for shard, row in rows.items():
                        win = row.get("windows", {}).get(wk)
                        if not win:
                            continue
                        n_i = int(win.get("count", 0))
                        n += n_i
                        counts[shard] = n_i
                        # exact bad-count reconstruction (see module
                        # docstring); round() undoes the row's 4-digit
                        # burn rounding
                        bad += int(round(
                            win.get("burn_rate", 0.0) * allowed * n_i))
                        observed = max(observed,
                                       win.get("observed", 0.0))
                    burn = (bad / n) / allowed if n else 0.0
                    breaching = n > 0 and burn >= 1.0
                    key = (name, wk)
                    if breaching and not self._burning.get(key, False):
                        _MET_BREACH.inc(slo=name)
                    self._burning[key] = breaching
                    _MET_BURN.set(burn, slo=name, window=wk)
                    clu["windows"][wk] = {
                        "count": n,
                        "observed": round(observed, 6),
                        "observed_is_max_over_shards": True,
                        "burn_rate": round(burn, 4),
                        "breaching": breaching,
                        "shard_counts": counts}
                out.append(clu)
        return out


#: process-wide merger so repeated CLI/fan-out merges edge-trigger the
#: breach counter exactly once per onset
_CLUSTER = ClusterSlo()


def merge_slo_tables(shard_tables: Mapping[str, list]) -> list[dict]:
    return _CLUSTER.merge(shard_tables)


def cluster_doc(fanout, now: float | None = None,
                max_staleness: float = 0.0) -> dict:
    """Digest one ``FederatedClient.stats()`` round into the cluster
    observability doc ``cstats --federation`` renders.

    ``fanout`` is a ``FanoutResult`` whose replies are ``StatsReply``
    protos (``json`` + ``durable_seq`` + ``shard``).  Dead shards stay
    in ``errors`` — the merge degrades, never blocks."""
    import json as _json
    import time as _time
    if now is None:
        now = _time.time()
    shards: dict[str, dict] = {}
    slo_tables: dict[str, list] = {}
    metric_snaps: dict[str, dict] = {}
    for name, reply in sorted(fanout.replies.items()):
        try:
            doc = _json.loads(reply.json)
        except (ValueError, AttributeError):
            fanout.errors[name] = "unparseable stats reply"
            continue
        stamped = doc.get("watchdog", {}).get("now", 0.0)
        staleness = max(0.0, now - stamped) if stamped else 0.0
        _MET_STALE.set(round(staleness, 3), shard=name)
        shards[name] = {
            "durable_seq": int(getattr(reply, "durable_seq", 0)),
            "staleness_s": round(staleness, 3),
            "flight": doc.get("flight"),
        }
        if doc.get("slo") is not None:
            slo_tables[name] = doc["slo"]
        if doc.get("metrics") is not None:
            metric_snaps[name] = doc["metrics"]
    return {
        "max_staleness": max_staleness,
        "shards": shards,
        "errors": dict(fanout.errors),
        "slo": merge_slo_tables(slo_tables) if slo_tables else [],
        "metrics": merge_metric_snapshots(metric_snaps),
    }
