"""Seeded cluster and job draws, and the record of every job a run submits.

The shapes are bench.py's north star as ``chip_smoke.build_cell`` draws them
(nodes of 32-128 CPUs and 64-512 GiB in disjoint partitions ``p<i mod P>``;
jobs of 1-16 CPUs and 1-32 GiB on 1-2 nodes in a uniform partition, with a
time limit and a simulated runtime), taken from a configuration file and drawn
in bulk with numpy.  Nodes and jobs come from two streams of one seed, so the
same seed gives the same cluster and the same sequence of jobs.  Nothing here
imports the program: the harness and the reference both read these arrays.
"""

from __future__ import annotations

import numpy as np

CPU_SCALE = 256          # the resource vector's cpu units per core
MIB = 1 << 20            # the resource vector's memory unit
GIB = 1 << 30


def _between(rng, lo_hi, size):
    lo, hi = lo_hi
    return rng.integers(int(lo), int(hi) + 1, size=size)


class Cluster:
    """The node inventory of one configuration: ``cpu`` cores and ``mem_gib``
    per node, node ``i`` in partition ``i % partitions``."""

    def __init__(self, cfg: dict, seed: int):
        rng = np.random.default_rng([int(seed), 0])
        n = int(cfg["nodes"])
        self.num_nodes = n
        self.num_partitions = int(cfg["partitions"])
        self.cpu = _between(rng, cfg["node_cpu"], n).astype(np.int64)
        self.mem_gib = _between(rng, cfg["node_mem_gib"], n).astype(np.int64)
        self.part = np.arange(n, dtype=np.int64) % self.num_partitions

    def names(self) -> list[str]:
        return [f"b{i:05d}" for i in range(self.num_nodes)]

    def totals(self) -> np.ndarray:
        """int64[N, 3] capacity vectors (cpu units, MiB, MiB of swap), as the
        program's layout encodes a capacity."""
        out = np.zeros((self.num_nodes, 3), np.int64)
        out[:, 0] = self.cpu * CPU_SCALE
        out[:, 1] = (self.mem_gib * GIB) // MIB
        return out


class JobLog:
    """Every job a run draws, in draw order, with what the harness knows of
    it: its request, the virtual time and the tick count at which it was
    submitted, and the id the program acknowledged (0 for a refusal)."""

    FIELDS = ("cpu", "mem_gib", "nodes", "part", "time_limit", "runtime",
              "submit_now", "submit_tick", "job_id")

    def __init__(self, cfg: dict, seed: int):
        self._cfg = cfg
        self._rng = np.random.default_rng([int(seed), 1])
        self._cols = {f: [] for f in self.FIELDS}
        self.count = 0

    def draw(self, k: int) -> dict:
        """The next ``k`` jobs as arrays (cpu cores, mem GiB, node count,
        partition index, time limit s, runtime s)."""
        cfg, rng = self._cfg, self._rng
        # one draw per field, in a fixed order, so the stream depends on
        # the counts asked for and on nothing else
        out = {
            "part": rng.integers(0, int(cfg["partitions"]), size=k),
            "time_limit": _between(rng, cfg["time_limit_s"], k),
            "cpu": _between(rng, cfg["job_cpu"], k),
            "mem_gib": _between(rng, cfg["job_mem_gib"], k),
            "nodes": _between(rng, cfg["job_nodes"], k),
            "runtime": _between(rng, cfg["runtime_s"], k),
        }
        return {key: v.astype(np.int64) for key, v in out.items()}

    def record(self, batch: dict, submit_now: float, submit_tick: int,
               job_ids) -> None:
        k = len(job_ids)
        for key in ("cpu", "mem_gib", "nodes", "part", "time_limit",
                    "runtime"):
            self._cols[key].append(np.asarray(batch[key][:k], np.int64))
        self._cols["submit_now"].append(np.full(k, float(submit_now)))
        self._cols["submit_tick"].append(np.full(k, int(submit_tick),
                                                 np.int64))
        self._cols["job_id"].append(np.asarray(job_ids, np.int64))
        self.count += k

    def arrays(self) -> dict:
        return {key: (np.concatenate(v) if v else np.zeros(0))
                for key, v in self._cols.items()}
