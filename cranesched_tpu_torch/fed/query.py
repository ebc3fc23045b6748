"""Federated query plane: scatter-gather reads across every shard.

``cqueue``/``cinfo``/``cstats``/``csummary``/``cevents`` against a
federation must show the WHOLE cluster, but no single controller holds
it — each shard owns its partitions' jobs and nodes outright.  The
:class:`FederatedClient` fans a read out to all shards in parallel,
merges the answers, and labels each row with its shard of origin plus
the ``durable_seq`` the answering replica had applied — the caller can
see exactly how fresh each slice is.

Bounded staleness: every fan-out takes ``max_staleness`` (seconds).
Each shard's client dials FOLLOWERS FIRST (leader last): a follower
that has been caught up within the bound serves the read locally and
the leader never sees it; a follower past the bound refuses with
FAILED_PRECONDITION and the client rotation falls through to the
leader.  ``max_staleness=0`` is the legacy contract — any replica
answers with whatever it has.

A dead shard degrades, never blocks: its slice is reported in
``errors`` and the merge carries on with the shards that answered.
"""

from __future__ import annotations

from concurrent import futures

from cranesched_tpu_torch.fed.shardmap import ShardMap


class FanoutResult:
    """One scatter-gather round: per-shard replies + per-shard errors
    (a shard appears in exactly one of the two)."""

    def __init__(self):
        self.replies: dict[str, object] = {}
        self.errors: dict[str, str] = {}

    def __iter__(self):
        return iter(sorted(self.replies.items()))


def _read_addresses(spec) -> list[str]:
    """Follower-first dial order for the bounded-staleness read plane
    (the leader stays the write path and the freshness fallback)."""
    out = list(spec.followers)
    if spec.address:
        out.append(spec.address)
    return out


class FederatedClient:
    """One read client per shard, fanned out in parallel."""

    def __init__(self, shard_map: ShardMap, token: str = "",
                 tls=None, timeout: float = 30.0):
        from cranesched_tpu_torch.rpc.client import make_client
        self.shard_map = shard_map
        self._clients = {
            name: make_client(_read_addresses(shard_map.spec(name)),
                              token=token, tls=tls, timeout=timeout)
            for name in shard_map.names()}
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max(2, len(self._clients)))

    @classmethod
    def connect(cls, address, token: str = "", tls=None,
                timeout: float = 30.0) -> "FederatedClient | None":
        """Learn the shard map from any reachable ctld and build the
        fan-out client; None when the cluster is not federated."""
        from cranesched_tpu_torch.rpc.client import make_client
        seed = make_client(address, token=token, tls=tls,
                           timeout=timeout)
        try:
            reply = seed.query_shard_map()
        finally:
            seed.close()
        if reply.error or not reply.shards:
            return None
        shard_map = ShardMap.from_doc([
            {"name": s.name, "partitions": list(s.partitions),
             "address": s.address, "followers": list(s.followers)}
            for s in reply.shards], epoch=reply.map_epoch)
        return cls(shard_map, token=token, tls=tls, timeout=timeout)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        for cli in self._clients.values():
            cli.close()

    # -- the fan-out core --

    def _each(self, fn) -> FanoutResult:
        res = FanoutResult()
        pending = {self._pool.submit(fn, cli): name
                   for name, cli in self._clients.items()}
        for fut in futures.as_completed(pending):
            name = pending[fut]
            try:
                res.replies[name] = fut.result()
            except Exception as exc:
                res.errors[name] = str(exc)
        return res

    # -- the read surface, one fan-out per CLI verb --

    def jobs(self, max_staleness: float = 0.0, **kw) -> FanoutResult:
        return self._each(
            lambda c: c.query_jobs(max_staleness=max_staleness, **kw))

    def cluster(self, max_staleness: float = 0.0) -> FanoutResult:
        return self._each(
            lambda c: c.query_cluster(max_staleness=max_staleness))

    def stats(self, max_staleness: float = 0.0) -> FanoutResult:
        return self._each(
            lambda c: c.query_stats(max_staleness=max_staleness))

    def summary(self, max_staleness: float = 0.0, **kw) -> FanoutResult:
        return self._each(
            lambda c: c.query_job_summary(max_staleness=max_staleness,
                                          **kw))

    def events(self, max_staleness: float = 0.0, **kw) -> FanoutResult:
        return self._each(
            lambda c: c.query_events(max_staleness=max_staleness, **kw))

    # -- elastic federation: map epochs, usage gossip, migration --

    def shard_maps(self) -> FanoutResult:
        """Each shard's OWN view of the routing table.  During a live
        migration the per-shard ``map_epoch`` values skew for a moment;
        cfed/cinfo surface them so an operator can see a flip settle."""
        return self._each(lambda c: c.query_shard_map())

    def map_epochs(self) -> dict[str, int]:
        """shard -> the map epoch it currently routes by (absent shards
        were unreachable)."""
        return {shard: reply.map_epoch
                for shard, reply in self.shard_maps()}

    def usage(self) -> FanoutResult:
        """Every shard's usage-gossip summary (cluster-wide accounting)."""
        return self._each(lambda c: c.fetch_usage())

    def migrate(self, partition: str, dest: str):
        """Drive a live migration: dial the partition's SOURCE shard —
        the source owns the four-phase protocol end to end."""
        source = self.shard_map.shard_for_partition(partition)
        if not source:
            raise ValueError(f"partition {partition!r} not in the "
                             f"shard map")
        if source not in self._clients:
            raise ValueError(f"no client for source shard {source!r}")
        return self._clients[source].migrate_partition(partition, dest)
