"""The port's multi-process sharded solve against the single-process
oracle, bit for bit (the cases of ``tests/test_multihost.py``).

Ranks run as threads, each owning a contiguous node slab sharded over a
local mesh of CPU shards, and fence once a step through an in-process
port ``RendezvousServer``; two real subprocesses do the same; and one
JAX rank and one port rank take part in one solve, since the fence
payload is the same little-endian int32 words in both packages.  The
oracle is the JAX package's single-process
``solve_greedy_sharded_classes`` on the whole cluster (and the port's,
which must agree with it).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cranesched_tpu.models import solver as jsolver
from cranesched_tpu.parallel import distributed as jdist
from cranesched_tpu.parallel import sharded as jsharded
from cranesched_tpu_torch import convert
from cranesched_tpu_torch.parallel import distributed as tdist
from cranesched_tpu_torch.parallel import sharded as tsharded
from cranesched_tpu_torch.rpc.rendezvous import RendezvousServer
from test_multihost import _problem

NPROCS = 2
LOCAL = (torch.device("cpu"),) * 4
KEYS = ("req", "node_num", "time_limit", "valid", "job_class")


def _oracle(pb, max_nodes):
    """The JAX single-process sharded solve, checked against the port's
    single-process one; returns the JAX result as numpy."""
    state = jsolver.make_cluster_state(pb["avail"], pb["total"],
                                       pb["alive"], pb["cost"])
    mesh = jsharded.make_node_mesh()
    jp, js = jsharded.solve_greedy_sharded_classes(
        jsharded.shard_cluster_state(state, mesh),
        *(jnp.asarray(pb[k]) for k in KEYS),
        jnp.asarray(pb["class_masks"]), mesh, max_nodes=max_nodes)
    tp, ts = tsharded.solve_greedy_sharded_classes(
        _slab_state(pb, 0, pb["avail"].shape[0]),
        *(torch.from_numpy(pb[k]) for k in KEYS),
        torch.from_numpy(pb["class_masks"]), LOCAL, max_nodes=max_nodes)
    out = {k: np.asarray(getattr(jp, k)) for k in ("placed", "nodes",
                                                   "reason")}
    out.update(avail=np.asarray(js.avail), cost=np.asarray(js.cost))
    for k in ("placed", "nodes", "reason"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), out[k])
    np.testing.assert_array_equal(ts.avail.numpy(), out["avail"])
    np.testing.assert_array_equal(ts.cost.numpy(), out["cost"])
    return out


def _slab_state(pb, lo, hi):
    return convert.cluster_state(pb["avail"][lo:hi], pb["total"][lo:hi],
                                 pb["alive"][lo:hi],
                                 np.asarray(pb["cost"][lo:hi]),
                                 device="cpu")


def _port_rank(pb, rank, nprocs, slab, port, max_nodes, cycles=1,
               pb_next=None):
    lo, hi = rank * slab, (rank + 1) * slab
    state = _slab_state(pb, lo, hi)
    pmesh = tdist.bootstrap_process_mesh(
        rank, nprocs, slab, address=f"127.0.0.1:{port}", token="mp",
        epoch=1, devices=LOCAL)
    try:
        out = None
        for cycle_pb in [pb] + ([pb_next] if pb_next is not None else []):
            out = tdist.solve_greedy_sharded_classes_mp(
                pmesh, state, *(torch.from_numpy(cycle_pb[k]) for k in KEYS),
                torch.from_numpy(cycle_pb["class_masks"][:, lo:hi]),
                max_nodes=max_nodes)
            state = out[1]
        return out
    finally:
        pmesh.close()


def _run(workers, nprocs=NPROCS):
    """Run ``workers[r](port)`` as rank r's thread over one server."""
    server = RendezvousServer(token="mp", nranks=nprocs, epoch=1)
    port = server.start("127.0.0.1:0")
    results: list = [None] * nprocs
    errors: list = []

    def run(rank):
        try:
            results[rank] = workers[rank](port)
        except BaseException as e:  # surfaced by the main thread
            errors.append((rank, e))

    threads = [threading.Thread(target=run, args=(r,))
               for r in range(nprocs)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        server.stop()
    if errors:
        raise errors[0][1]
    assert all(r is not None for r in results)
    return results


def _assert_matches(results, ref):
    for rank, (p, _) in enumerate(results):
        for k in ("placed", "nodes", "reason"):
            np.testing.assert_array_equal(np.asarray(getattr(p, k)),
                                          ref[k], err_msg=f"rank {rank} {k}")
    avail = np.concatenate([np.asarray(s.avail) for _, s in results])
    cost = np.concatenate([np.asarray(s.cost) for _, s in results])
    np.testing.assert_array_equal(avail, ref["avail"])
    np.testing.assert_array_equal(cost, ref["cost"])


@pytest.mark.parametrize("disjoint", [False, True],
                         ids=["overlapping", "disjoint"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mp_solve_matches_single_process_oracle(seed, disjoint):
    max_nodes = 4
    pb = _problem(seed, num_jobs=48, num_nodes=32, num_classes=3,
                  max_nodes=max_nodes, disjoint=disjoint)
    ref = _oracle(pb, max_nodes)
    slab = 32 // NPROCS
    results = _run([lambda port, r=r: _port_rank(pb, r, NPROCS, slab, port,
                                                 max_nodes)
                    for r in range(NPROCS)])
    _assert_matches(results, ref)
    assert all(isinstance(s, tsharded.ShardedClusterState)
               for _, s in results)


def test_mp_second_cycle_reuses_slab_state():
    max_nodes = 2
    pb = _problem(7, num_jobs=24, num_nodes=16, num_classes=2,
                  max_nodes=max_nodes, disjoint=False)
    pb2 = _problem(8, num_jobs=24, num_nodes=16, num_classes=2,
                   max_nodes=max_nodes, disjoint=False)
    # the oracle's two cycles
    state = jsolver.make_cluster_state(pb["avail"], pb["total"],
                                       pb["alive"], pb["cost"])
    mesh = jsharded.make_node_mesh()
    _, s1 = jsharded.solve_greedy_sharded_classes(
        jsharded.shard_cluster_state(state, mesh),
        *(jnp.asarray(pb[k]) for k in KEYS),
        jnp.asarray(pb["class_masks"]), mesh, max_nodes=max_nodes)
    p2, s2 = jsharded.solve_greedy_sharded_classes(
        s1, *(jnp.asarray(pb2[k]) for k in KEYS),
        jnp.asarray(pb2["class_masks"]), mesh, max_nodes=max_nodes)
    ref = {k: np.asarray(getattr(p2, k)) for k in ("placed", "nodes",
                                                   "reason")}
    ref.update(avail=np.asarray(s2.avail), cost=np.asarray(s2.cost))
    results = _run([lambda port, r=r: _port_rank(pb, r, NPROCS, 8, port,
                                                 max_nodes, pb_next=pb2)
                    for r in range(NPROCS)])
    _assert_matches(results, ref)


def test_bootstrap_missing_rank_is_structured():
    server = RendezvousServer(token="mp", nranks=2, epoch=1)
    port = server.start("127.0.0.1:0")
    try:
        with pytest.raises(RuntimeError,
                           match=r"fence timeout \(1/2 arrived\)"):
            tdist.bootstrap_process_mesh(0, 2, 8,
                                         address=f"127.0.0.1:{port}",
                                         token="mp", epoch=1, timeout=1.0,
                                         devices=LOCAL)
    finally:
        server.stop()


def test_process_mesh_describe():
    server = RendezvousServer(token="mp", nranks=1, epoch=1)
    port = server.start("127.0.0.1:0")
    try:
        pmesh = tdist.bootstrap_process_mesh(0, 1, 8,
                                             address=f"127.0.0.1:{port}",
                                             token="mp", epoch=1,
                                             devices=LOCAL)
        assert pmesh.describe() == "1x4"
        assert pmesh.total_nodes == 8 and pmesh.node_offset == 0
        assert pmesh.peers == [{"slab": 8, "devices": 4,
                                "platform": "cpu"}]
        pmesh.close()
    finally:
        server.stop()
    # one process: the host-fenced path is the one to use
    assert tdist.native_global_mesh() is None


_CHILD_SRC = r"""
import json, os, sys
import numpy as np
import torch
from cranesched_tpu_torch import convert
from cranesched_tpu_torch.parallel.distributed import (
    bootstrap_process_mesh, solve_greedy_sharded_classes_mp)

rank = int(os.environ["CRANE_MP_RANK"])
nprocs = int(os.environ["CRANE_MP_NPROCS"])
pb = dict(np.load(sys.argv[1]))
max_nodes = int(pb.pop("max_nodes"))
n = pb["avail"].shape[0]
slab = n // nprocs
lo, hi = rank * slab, (rank + 1) * slab
state = convert.cluster_state(pb["avail"][lo:hi], pb["total"][lo:hi],
                              pb["alive"][lo:hi], pb["cost"][lo:hi],
                              device="cpu")
pmesh = bootstrap_process_mesh(rank, nprocs, slab,
                               devices=[torch.device("cpu")] * 2)
p, s = solve_greedy_sharded_classes_mp(
    pmesh, state, *(torch.from_numpy(pb[k]) for k in
                    ("req", "node_num", "time_limit", "valid", "job_class")),
    torch.from_numpy(pb["class_masks"][:, lo:hi]), max_nodes=max_nodes)
print(json.dumps({
    "rank": rank, "mesh": pmesh.describe(), "jax": "jax" in sys.modules,
    "placed": p.placed.tolist(), "nodes": p.nodes.tolist(),
    "reason": p.reason.tolist(), "avail": s.avail.tolist()}))
pmesh.close()
"""


def test_two_real_processes_agree_with_oracle(tmp_path):
    """Two OS processes, each with a 2-shard CPU mesh and no JAX,
    bootstrap over the rendezvous and solve; their placements must be
    identical and match the oracle."""
    max_nodes = 2
    pb = _problem(3, num_jobs=16, num_nodes=16, num_classes=2,
                  max_nodes=max_nodes, disjoint=False)
    ref = _oracle(pb, max_nodes)
    npz = tmp_path / "problem.npz"
    np.savez(npz, max_nodes=max_nodes, **pb)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    server = RendezvousServer(token="mp2", nranks=2, epoch=1)
    port = server.start("127.0.0.1:0")
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ)
            env.update({
                "PYTHONPATH": root,
                "CRANE_RENDEZVOUS": f"127.0.0.1:{port}",
                "CRANE_RENDEZVOUS_TOKEN": "mp2",
                "CRANE_MP_RANK": str(rank),
                "CRANE_MP_NPROCS": "2",
            })
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD_SRC, str(npz)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env, cwd=root))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["mesh"] == "2x2" and not o["jax"] for o in outs)
    for k in ("placed", "nodes", "reason"):
        assert outs[0][k] == outs[1][k] == ref[k].tolist()
    avail = np.concatenate([np.asarray(o["avail"]) for o in outs])
    np.testing.assert_array_equal(avail, ref["avail"])


def test_jax_rank_and_port_rank_in_one_solve():
    """Rank 0 is the JAX package's (its 8-device CPU mesh), rank 1 the
    port's (a 4-shard CPU mesh); both fence through the port's
    rendezvous server and both equal the oracle."""
    max_nodes = 3
    pb = _problem(4, num_jobs=40, num_nodes=32, num_classes=3,
                  max_nodes=max_nodes, disjoint=False)
    ref = _oracle(pb, max_nodes)
    slab = 16

    def jax_rank(port):
        state = jsolver.make_cluster_state(pb["avail"][:slab],
                                           pb["total"][:slab],
                                           pb["alive"][:slab],
                                           pb["cost"][:slab])
        pmesh = jdist.bootstrap_process_mesh(
            0, 2, slab, address=f"127.0.0.1:{port}", token="mp", epoch=1)
        try:
            return jdist.solve_greedy_sharded_classes_mp(
                pmesh, state, *(jnp.asarray(pb[k]) for k in KEYS),
                jnp.asarray(pb["class_masks"][:, :slab]),
                max_nodes=max_nodes)
        finally:
            pmesh.close()

    results = _run([jax_rank,
                    lambda port: _port_rank(pb, 1, 2, slab, port,
                                            max_nodes)])
    _assert_matches(results, ref)
