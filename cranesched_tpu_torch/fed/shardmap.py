"""Shard map: the versioned partition -> controller-shard routing table.

The federation is declared in the cluster YAML::

    Federation:
      ShardName: east            # identity of THIS controller process
      Shards:
        - name: east
          partitions: [batch, debug]
          address: 127.0.0.1:50051
          followers: [127.0.0.1:50061]
        - name: west
          partitions: [gpu]
          address: 127.0.0.1:50052

Partitions are owned by exactly one shard (disjoint by construction —
a partition listed twice is a config error, and so is a configured
partition no shard owns).  Each ShardMap *object* is immutable; the
table as a whole is versioned by ``epoch``: live partition migration
(fed/rebalance.py) produces a successor map via
:meth:`with_partition_moved` with ``epoch + 1`` and swaps it in
atomically at the arbiter.  Routing stays a pure dict lookup on both
the client and the server; a submit that lands on the wrong shard is
forwarded once and answered with a redirect hint so the client learns
(see rpc/server.py SubmitBatchJob and client.HaCtldClient).  Two
shards holding maps of different epochs redirect-bounce the client to
whichever shard the *owner's* map names — the one-hop-only rule keeps
a skewed pair from building a forwarding loop, exactly as it did when
the map was static.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """One controller shard: a name, its partitions, and where it
    listens (leader address first, then any HA followers that may
    serve bounded-staleness reads)."""

    name: str
    partitions: tuple[str, ...]
    address: str = ""
    followers: tuple[str, ...] = ()

    @property
    def addresses(self) -> tuple[str, ...]:
        """Leader address followed by follower addresses."""
        out = (self.address,) if self.address else ()
        return out + tuple(self.followers)


class ShardMap:
    """Immutable partition -> shard routing table, versioned by epoch.

    ``configured_partitions`` is the cluster's full partition inventory
    (the YAML ``Partitions:`` section): when given, a partition no
    shard owns is a config error — a federation that silently drops a
    partition routes its submits nowhere.
    """

    def __init__(self, shards: list[ShardSpec], epoch: int = 0,
                 configured_partitions: Iterable[str] | None = None):
        if not shards:
            raise ValueError("Federation declared with no shards")
        self.epoch = int(epoch)
        self.shards: dict[str, ShardSpec] = {}
        self._by_partition: dict[str, str] = {}
        for spec in shards:
            if spec.name in self.shards:
                raise ValueError(f"duplicate shard {spec.name!r}")
            self.shards[spec.name] = spec
            for part in spec.partitions:
                owner = self._by_partition.setdefault(part, spec.name)
                if owner != spec.name:
                    raise ValueError(
                        f"partition {part!r} owned by both {owner!r} "
                        f"and {spec.name!r} (shards must be disjoint)")
        if configured_partitions is not None:
            for part in sorted(set(configured_partitions)):
                if part not in self._by_partition:
                    raise ValueError(
                        f"partition {part!r} is configured but owned "
                        "by no shard (every partition needs exactly "
                        "one owner)")

    @classmethod
    def from_config(cls, section: dict,
                    configured_partitions: Iterable[str] | None = None
                    ) -> "ShardMap":
        """Parse the YAML ``Federation:`` section."""
        shards = []
        for entry in section.get("Shards", []) or []:
            shards.append(ShardSpec(
                name=str(entry["name"]),
                partitions=tuple(str(p) for p in
                                 entry.get("partitions", [])),
                address=str(entry.get("address", "") or ""),
                followers=tuple(str(a) for a in
                                entry.get("followers", []) or [])))
        return cls(shards, epoch=int(section.get("Epoch", 0) or 0),
                   configured_partitions=configured_partitions)

    def shard_for_partition(self, partition: str) -> str:
        """Owning shard name, or '' for an unknown partition (the local
        scheduler then rejects it with its normal diagnostics)."""
        return self._by_partition.get(partition, "")

    def spec(self, name: str) -> ShardSpec | None:
        return self.shards.get(name)

    def names(self) -> list[str]:
        return sorted(self.shards)

    def partitions_of(self, name: str) -> tuple[str, ...]:
        spec = self.shards.get(name)
        return spec.partitions if spec else ()

    # -- successor maps (live migration, fed/rebalance.py) --

    def with_partition_moved(self, partition: str,
                             to_shard: str) -> "ShardMap":
        """The successor map after migrating ``partition`` to
        ``to_shard``: same shards, ownership moved, ``epoch + 1``.
        Raises ValueError on an unknown partition/shard or a move to
        the current owner (a no-op migration must not burn an epoch)."""
        owner = self._by_partition.get(partition, "")
        if not owner:
            raise ValueError(f"partition {partition!r} not in the map")
        if to_shard not in self.shards:
            raise ValueError(f"unknown destination shard {to_shard!r}")
        if owner == to_shard:
            raise ValueError(
                f"partition {partition!r} already owned by {to_shard!r}")
        shards = []
        for name in self.names():
            spec = self.shards[name]
            parts = tuple(p for p in spec.partitions if p != partition)
            if name == to_shard:
                parts = parts + (partition,)
            shards.append(dataclasses.replace(spec, partitions=parts))
        return ShardMap(shards, epoch=self.epoch + 1)

    # -- wire form (QueryShardMap / ShardInfo) --

    def doc(self) -> list[dict]:
        """JSON-serializable shard list for the wire/CLI.  The map
        epoch travels beside this list (QueryShardMapReply.map_epoch,
        QueryStats ``fed.map_epoch``), not inside it — the list shape
        predates versioning and older readers must keep parsing it."""
        return [{"name": s.name, "partitions": list(s.partitions),
                 "address": s.address, "followers": list(s.followers)}
                for s in (self.shards[n] for n in self.names())]

    @classmethod
    def from_doc(cls, doc: list[dict], epoch: int = 0) -> "ShardMap":
        return cls([ShardSpec(
            name=str(e["name"]),
            partitions=tuple(str(p) for p in e.get("partitions", [])),
            address=str(e.get("address", "") or ""),
            followers=tuple(str(a) for a in e.get("followers", []) or []))
            for e in doc], epoch=epoch)

    def __len__(self) -> int:
        return len(self.shards)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ShardMap(epoch={self.epoch}, "
                f"{', '.join(f'{n}:{list(s.partitions)}' for n, s in sorted(self.shards.items()))})")
