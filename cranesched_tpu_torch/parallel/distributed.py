"""Multi-process sharded solve: node slabs across processes (port of
``cranesched_tpu/parallel/distributed.py``).

Process p owns the contiguous node slab ``[sum(n_0..n_{p-1}),
sum(n_0..n_p))``; inside the slab the single-process sharded solve
(``parallel.sharded``) spreads rows over the process's local mesh.  Each
step of the greedy solve splits into a *select* and an *apply* half:

1. ``select``: every process computes, per job stream, its slab-level
   feasible/eligible counts and its k cheapest candidates (the local
   mesh's sum and merge, confined to the slab);
2. one host-level rendezvous ``Fence`` (``rpc/rendezvous.py``,
   epoch-tagged) all-gathers the packed counts and candidate blocks in
   rank order;
3. ``apply``: every process merges the P candidate lists the same way
   (stable sort: cost ascending, ties to the lowest global node id, since
   the rank-major concatenation of per-slab sorted lists is what the
   single-process solve sorts), re-derives the admission decision from
   the summed counts, and subtracts the resources of the winners its slab
   owns.

The fence payload is the JAX package's: little-endian int32 words (a
``[S, k]`` header, the 2S counts, the candidate costs and global ids), so
a JAX rank and a port rank can take part in one solve.  The boot fence
carries the same JSON document (slab size, device count, platform).

Why a host fence and not a collective: NCCL refuses two ranks on one
card, and the per-step payload is O(P * S * max_nodes) bytes, latency-
bound either way.  A mesh of every card of several processes
(``native_global_mesh``) waits for a machine with more than one card
(ROADMAP.md A10b).

Parity contract: ``solve_greedy_sharded_classes_mp`` is bit-identical to
the single-process ``solve_greedy_sharded_classes`` on the concatenated
slabs (``tests/test_torch_multihost.py``).

Metrics: ``crane_mesh_fence_seconds`` (host-barrier latency, by kind)
and ``crane_mesh_solve_seconds`` (wall time of one distributed solve, by
process count).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from cranesched_tpu_torch.models.solver import (
    COST_INF,
    Placements,
    cpu_total_of,
)
from cranesched_tpu_torch.obs.metrics import REGISTRY as _OBS
from cranesched_tpu_torch.parallel.sharded import (
    _Replicas,
    _apply_owned,
    _decide,
    _merge,
    _shard_candidates,
    _sum_counts,
    make_node_mesh,
    shard_cluster_state,
)
from cranesched_tpu_torch.rpc.rendezvous import RendezvousClient

_MET_FENCE = _OBS.histogram(
    "crane_mesh_fence_seconds",
    "Host-level rendezvous fence latency in multi-process solves")
_MET_SOLVE = _OBS.histogram(
    "crane_mesh_solve_seconds",
    "Wall time of one multi-process sharded solve")

DEFAULT_FENCE_TIMEOUT_S = 120.0

# The JAX package serializes its ranks' device programs under a lock
# (XLA's CPU collectives deadlock when two threads of one process run
# them at once).  The port's steps are plain torch operations with no
# collective inside a process, and the multi-rank tests run their ranks
# as threads without one, so it has no such lock.


def native_global_mesh():
    """A mesh over every card of every process, where the runtime can
    run collectives across processes.  None where the host-fenced path
    is the one to use: one process, or no card.  Several processes with
    cards wait for a machine with more than one card (ROADMAP.md A10b)."""
    import torch.distributed as dist
    if (not dist.is_available() or not dist.is_initialized()
            or dist.get_world_size() <= 1):
        return None
    if not torch.cuda.is_available():
        return None
    raise NotImplementedError(
        "a mesh of the cards of several processes is not in the port yet "
        "(ROADMAP.md A10b); use the host-fenced "
        "solve_greedy_sharded_classes_mp")


class ProcessMesh:
    """One process's membership in the gang of solver processes: the
    local mesh (this process's slab is sharded over it), the slab
    geometry agreed at bootstrap, and the epoch-tagged rendezvous client
    of the per-step host fences."""

    def __init__(self, rank: int, nprocs: int, client: RendezvousClient,
                 epoch: int, mesh, node_offset: int, slab_nodes: int,
                 total_nodes: int, peers: list[dict],
                 fence_timeout: float = DEFAULT_FENCE_TIMEOUT_S):
        self.rank = rank
        self.nprocs = nprocs
        self.client = client
        self.epoch = epoch
        self.mesh = tuple(mesh)
        self.node_offset = node_offset
        self.slab_nodes = slab_nodes
        self.total_nodes = total_nodes
        self.peers = peers
        self.fence_timeout = fence_timeout
        self._solve_seq = 0

    @property
    def local_device_count(self) -> int:
        return len(self.mesh)

    def describe(self) -> str:
        """``procs x local-devices``: the MESH column of cstats."""
        return f"{self.nprocs}x{self.local_device_count}"

    def fence(self, name: str, payload: bytes = b"",
              timeout: float | None = None, kind: str = "solve"
              ) -> list[bytes]:
        t0 = time.monotonic()
        try:
            return self.client.fence(
                name, self.rank, self.nprocs, data=payload,
                timeout=self.fence_timeout if timeout is None
                else timeout)
        finally:
            _MET_FENCE.observe(time.monotonic() - t0, kind=kind)

    def next_solve_id(self) -> int:
        self._solve_seq += 1
        return self._solve_seq

    def close(self) -> None:
        self.client.close()


def bootstrap_process_mesh(rank: int, nprocs: int, slab_nodes: int, *,
                           address: str | None = None,
                           token: str | None = None, epoch: int = 1,
                           timeout: float = 60.0, tls=None,
                           devices=None) -> ProcessMesh:
    """Join the gang of solver processes over the rendezvous service.

    Every process dials the coordinator (``address`` or
    ``CRANE_RENDEZVOUS``), contributes its slab size and device inventory
    to an epoch-tagged boot fence, and derives the agreed slab offsets
    from the rank-ordered contributions.  The local mesh is
    ``make_node_mesh(devices)``: every visible card by default.  A
    missing rank surfaces as the fence's structured ``x/y arrived``
    timeout, never a silent hang."""
    address = address or os.environ.get("CRANE_RENDEZVOUS", "")
    if not address:
        raise ValueError("no coordinator: pass address= or set "
                         "CRANE_RENDEZVOUS")
    if token is None:
        token = os.environ.get("CRANE_RENDEZVOUS_TOKEN", "")
    mesh = make_node_mesh(devices)
    client = RendezvousClient(address, token=token, tls=tls, epoch=epoch)
    info = {"slab": int(slab_nodes), "devices": len(mesh),
            "platform": mesh[0].type}
    t0 = time.monotonic()
    try:
        datas = client.fence(f"mesh/boot/{epoch}", rank, nprocs,
                             data=json.dumps(info).encode(),
                             timeout=timeout)
    except BaseException:
        client.close()
        raise
    finally:
        _MET_FENCE.observe(time.monotonic() - t0, kind="boot")
    peers = [json.loads(d.decode()) for d in datas]
    slabs = [int(p["slab"]) for p in peers]
    return ProcessMesh(
        rank=rank, nprocs=nprocs, client=client, epoch=epoch, mesh=mesh,
        node_offset=int(sum(slabs[:rank])), slab_nodes=int(slabs[rank]),
        total_nodes=int(sum(slabs)), peers=peers)


# ---- the select/apply split of one step ----

def _select_step(sharded, cm_slabs, jreq_r, jcls_r, step: int,
                 k_slab: int):
    """Slab-level counts int32[2S] and the k_slab cheapest candidates
    [S, k_slab] (cost, slab-local global id) of one step's S jobs."""
    mesh = sharded.mesh
    dev0 = mesh[0]
    k = min(k_slab, sharded.local_n)
    f_cnt, e_cnt, cc, cg = [], [], [], []
    for d, (sh, off) in enumerate(zip(sharded.shards, sharded.offsets)):
        dev = mesh[d]
        f, e, c, g = _shard_candidates(
            sh, cm_slabs[d][jcls_r.on(dev)[step]], jreq_r.on(dev)[step],
            k, off)
        f_cnt.append(f)
        e_cnt.append(e)
        cc.append(c)
        cg.append(g)
    counts = torch.cat([_sum_counts(f_cnt, dev0), _sum_counts(e_cnt, dev0)])
    sl_cost, sl_gidx = _merge(cc, cg, dev0, k_slab)
    return counts, sl_cost, sl_gidx


def _pack(counts, cc, cg) -> bytes:
    hdr = np.asarray([cc.shape[0], cc.shape[1]], np.int32)
    return b"".join(np.ascontiguousarray(x, "<i4").tobytes()
                    for x in (hdr, counts, cc.reshape(-1),
                              cg.reshape(-1)))


def _unpack(buf: bytes):
    a = np.frombuffer(buf, "<i4")
    s, k = int(a[0]), int(a[1])
    counts = a[2:2 + 2 * s]
    cc = a[2 + 2 * s:2 + 2 * s + s * k].reshape(s, k)
    cg = a[2 + 2 * s + s * k:2 + 2 * (s + s * k)].reshape(s, k)
    return counts, cc, cg


def solve_greedy_sharded_classes_mp(pmesh: ProcessMesh, state, req,
                                    node_num, time_limit, valid, job_class,
                                    class_masks, max_nodes: int = 1,
                                    plan=None):
    """Greedy class-table solve across the process mesh.

    ``state``/``class_masks`` hold only THIS process's node slab (the
    job tensors are the same on every rank).  Same contract and
    bit-identical results as ``solve_greedy_sharded_classes`` over the
    concatenated slabs; the slab state is updated in place and returned
    sharded over the local mesh.

    ``plan`` must be identical on every rank when given (it fixes the
    fence count and payload shapes); the default is the serial S=1 plan,
    which depends only on the job data every rank holds.  A multi-stream
    plan from ``plan_streams`` is legal only when computed from the
    GLOBAL class table."""
    if int(state.num_nodes) != pmesh.slab_nodes:
        raise ValueError(
            f"state has {int(state.num_nodes)} nodes but this rank's "
            f"slab is {pmesh.slab_nodes}")
    if max_nodes > pmesh.total_nodes:
        raise ValueError(f"max_nodes {max_nodes} exceeds the "
                         f"{pmesh.total_nodes}-node cluster")
    sharded = shard_cluster_state(state, pmesh.mesh)
    mesh = sharded.mesh
    dev0 = mesh[0]
    J = int(req.shape[0])
    R = int(req.shape[1])
    C = int(class_masks.shape[0])
    if J == 0:
        return (Placements(
            placed=torch.zeros(0, dtype=torch.bool, device=dev0),
            nodes=torch.zeros((0, max_nodes), dtype=torch.int32,
                              device=dev0),
            reason=torch.zeros(0, dtype=torch.int32, device=dev0)),
            sharded)
    if plan is None:
        plan = (np.zeros(C, np.int32), 1, -(-J // 8) * 8)
    stream_of_class, S, L = plan

    # stream-major regrouping on the host (the job data is the same on
    # every rank, so every rank lays it out the same)
    def host(x, dtype):
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        return np.asarray(x).astype(dtype)

    cls = np.clip(host(job_class, np.int32), 0, C - 1)
    stream = np.asarray(stream_of_class, np.int32)[cls]
    order = np.argsort(stream, kind="stable")
    sorted_stream = stream[order]
    slot = (np.arange(J, dtype=np.int32)
            - np.searchsorted(sorted_stream, sorted_stream).astype(np.int32))
    lin = sorted_stream * L + slot

    def scat(x, fill, dtype):
        x = host(x, dtype)
        flat = np.full((S * L,) + x.shape[1:], fill, dtype)
        flat[lin] = x[order]
        return flat

    req_sl = scat(req, 0, np.int32).reshape(S, L, R).transpose(1, 0, 2)
    nn_sl = scat(node_num, 0, np.int32).reshape(S, L).T
    tl_sl = scat(time_limit, 0, np.int32).reshape(S, L).T
    v_sl = scat(valid, False, np.bool_).reshape(S, L).T
    cls_sl = scat(cls, 0, np.int64).reshape(S, L).T

    def to_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev0)

    jreq_r = _Replicas(to_dev(req_sl), mesh)
    jtl_r = _Replicas(to_dev(tl_sl), mesh)
    jcls_r = _Replicas(to_dev(cls_sl), mesh)
    nn_d, v_d = to_dev(nn_sl), to_dev(v_sl)
    local_n = sharded.local_n
    cm = class_masks if isinstance(class_masks, torch.Tensor) else \
        torch.from_numpy(np.asarray(class_masks, bool))
    cm_slabs = [cm.narrow(1, off, local_n).to(dev)
                for dev, off in zip(mesh, sharded.offsets)]
    cpu_totals = [cpu_total_of(sh) for sh in sharded.shards]

    k_slab = min(max_nodes, pmesh.slab_nodes)
    sid = pmesh.next_solve_id()
    placed_sl = np.zeros((L, S), bool)
    nodes_sl = np.zeros((L, S, max_nodes), np.int32)
    reason_sl = np.zeros((L, S), np.int32)
    t0 = time.monotonic()
    for step in range(L):
        counts, cc, cg = _select_step(sharded, cm_slabs, jreq_r, jcls_r,
                                      step, k_slab)
        payload = _pack(counts.cpu().numpy(), cc.cpu().numpy(),
                        cg.cpu().numpy().astype(np.int32)
                        + pmesh.node_offset)

        datas = pmesh.fence(f"solve/{pmesh.epoch}/{sid}/{step}", payload)

        parts = [_unpack(d) for d in datas]   # rank order
        counts_g = np.sum([p[0] for p in parts], axis=0,
                          dtype=np.int64).astype(np.int32)
        sel_cost = np.full((S, max_nodes), COST_INF, np.int32)
        sel_gidx = np.full((S, max_nodes), -1, np.int32)
        for s in range(S):
            all_c = np.concatenate([p[1][s] for p in parts])
            all_g = np.concatenate([p[2][s] for p in parts])
            o = np.argsort(all_c, kind="stable")[:max_nodes]
            sel_cost[s, :o.size] = all_c[o]
            sel_gidx[s, :o.size] = all_g[o]

        counts_t = torch.from_numpy(counts_g).to(dev0)
        sel_gidx_t = torch.from_numpy(sel_gidx).to(dev0, torch.int64)
        ok, reason, sel, chosen = _decide(
            v_d[step], nn_d[step], max_nodes, counts_t[:S], counts_t[S:],
            torch.from_numpy(sel_cost).to(dev0), sel_gidx_t)
        for d, (sh, off) in enumerate(zip(sharded.shards,
                                          sharded.offsets)):
            dev = mesh[d]
            _apply_owned(sh, cpu_totals[d], jreq_r.on(dev)[step],
                         jtl_r.on(dev)[step], sel.to(dev),
                         sel_gidx_t.to(dev), pmesh.node_offset + off)
        placed_sl[step] = ok.cpu().numpy()
        nodes_sl[step] = chosen.cpu().numpy()
        reason_sl[step] = reason.cpu().numpy()
    _MET_SOLVE.observe(time.monotonic() - t0, procs=str(pmesh.nprocs))

    inv = np.zeros(J, np.int64)
    inv[order] = lin
    placed_j = placed_sl.transpose(1, 0).reshape(-1)[inv]
    nodes_j = nodes_sl.transpose(1, 0, 2).reshape(S * L, max_nodes)[inv]
    reason_j = reason_sl.transpose(1, 0).reshape(-1)[inv]
    return (Placements(placed=torch.from_numpy(placed_j).to(dev0),
                       nodes=torch.from_numpy(nodes_j).to(dev0),
                       reason=torch.from_numpy(reason_j).to(dev0)),
            sharded)
