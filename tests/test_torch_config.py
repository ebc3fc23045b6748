"""The port's YAML configuration (``cranesched_tpu_torch/utils/config.py``)
against the JAX package's: the same file through both ``load_config``
functions gives the same parsed config, and ``build()`` the same nodes,
partitions, ``SchedulerConfig``, priority weights, licenses, accounts
and topology.  The ``Federation:`` block (refused naming ROADMAP.md A14
until federation came into the port) gives the same ``shard_map()``,
``global_limits()`` and ``shard_name``, and the same refusals of a
partition owned twice or by no shard.
"""

import dataclasses
import os

import numpy as np
import pytest

import cranesched_tpu.utils.config as jconfig
import cranesched_tpu_torch.utils.config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FULL = """
ClusterName: full
Listen: 127.0.0.1:0
Wal: {tmp}/wal/ctld.wal
Archive: {tmp}/archive.db
Nodes:
  - name: "cn[000-015]"
    cpu: 32
    memory: 128G
    partitions: [batch, debug]
  - name: "gpu[0-3]"
    cpu: 64
    memory: 512g
    partitions: [gpu]
    gres:
      "gpu:h100": 8
      "gpu:a100": 2
Partitions:
  - name: batch
    priority: 10
    AllowedAccounts: [phys, chem]
  - name: debug
    priority: 100
    DeniedAccounts: [guest]
  - name: gpu
    priority: 50
Priority:
  Type: priority/basic
  FavorSmall: false
  MaxAge: "2:30:00"
  WeightAge: 100
  WeightFairShare: 5000
  WeightJobSize: 20
  WeightPartition: 700
  WeightQoS: 10000
Scheduler:
  Backfill: false
  TimeResolutionSec: 30
  TimeBuckets: 32
  TimeHorizonSec: 86400
  ScheduledBatchSize: 50000
  PendingQueueMaxSize: 200000
  MaxNodesPerJob: 4
  Solver: device
  CranedTimeoutSec: 45
  PreemptMode: Requeue
  Incremental: true
  ResidentState: false
  MaxStreams: 2
  BlockJobs: 128
  CycleIdleSleep: 12
Observability:
  MetricsPort: 0
  CycleTraceRing: 16
  JobTrace: off
  JobTraceCapacity: 512
  SLO:
    - name: dispatch
      from: submit
      to: dispatched
      p: 95
      target_seconds: 30
      windows: [60, 600]
Accounting:
  RootUsers: [root, ops]
Auth:
  TokenFile: {tmp}/auth/tokens.json
  Admins: [root, ops]
Tls:
  Ca: {tmp}/pki/ca.pem
  Cert: {tmp}/pki/ctld.pem
  Key: {tmp}/pki/ctld.key
  RequireClientCert: true
LicenseSync:
  Program: /bin/true
  Interval: 30
Licenses:
  - name: matlab
    total: 10
  - name: ansys
    total: 4
    remote: true
"""

TOPO = """
Nodes:
  - name: "tpu[00-15]"
    cpu: 8
    memory: 32G
Topology:
  Blocks:
    - name: b0
      nodes: tpu[00-07]
    - name: b1
      nodes: tpu[08-15]
  Switches:
    - name: sw0
      blocks: [b0, b1]
"""


def _write(tmp_path, text):
    path = tmp_path / "crane.yaml"
    path.write_text(text.format(tmp=tmp_path))
    return str(path)


def _cluster(meta):
    """Nodes and partitions of a built MetaContainer, as plain data."""
    nodes = [(n.node_id, n.name, np.asarray(n.total).tolist(),
              sorted(n.partitions), bool(n.alive))
             for n in meta.nodes.values()]
    parts = {name: (p.priority, sorted(p.node_ids),
                    p.allowed_accounts, sorted(p.denied_accounts or ()))
             for name, p in meta.partitions.items()}
    return nodes, parts, tuple(meta.layout.gres_dims)


def _sched(sched):
    cfg = dataclasses.asdict(sched.config)
    accounts = (None if sched.accounts is None else
                {u: rec.admin_level.name
                 for u, rec in sched.accounts.users.items()})
    lics = {n: (lic.total, lic.remote)
            for n, lic in sched.licenses.licenses.items()}
    return cfg, accounts, lics


def _both(path):
    jc, tc = jconfig.load_config(path), tconfig.load_config(path)
    jmeta, jsched = jc.build()
    tmeta, tsched = tc.build(device="cpu")
    return (jc, jmeta, jsched), (tc, tmeta, tsched)


@pytest.mark.parametrize("which", ["etc", "full"])
def test_same_cluster_and_scheduler_config(which, tmp_path):
    path = (os.path.join(REPO, "etc", "config.yaml") if which == "etc"
            else _write(tmp_path, FULL))
    (jc, jmeta, jsched), (tc, tmeta, tsched) = _both(path)
    # the parsed config, field by field
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert jc.metrics_port == tc.metrics_port
    assert jc.shard_name == tc.shard_name == ""
    jt, tt = jc.tls_config(), tc.tls_config()
    assert (None if jt is None else dataclasses.asdict(jt)) == \
        (None if tt is None else dataclasses.asdict(tt))
    # what build() makes of it
    assert _cluster(jmeta) == _cluster(tmeta)
    assert _sched(jsched) == _sched(tsched)
    assert tsched.device.type == "cpu"


def test_topology_section_builds_the_same_tree(tmp_path):
    (_, jmeta, _), (_, tmeta, _) = _both(_write(tmp_path, TOPO))
    jt, tt = jmeta.topology, tmeta.topology
    assert tt is not None and jt.num_blocks == tt.num_blocks == 2
    assert list(jt.block_names) == list(tt.block_names)
    assert np.array_equal(np.asarray(jt.perm), np.asarray(tt.perm))
    free = np.ones(jt.num_nodes, bool)
    free[3] = False
    assert jt.fragmentation(free) == tt.fragmentation(free)


@pytest.mark.parametrize("value", ["64G", "512m", "1.5T", 4096, "2048",
                                   "16gb"])
def test_parse_mem_matches(value):
    assert jconfig.parse_mem(value) == tconfig.parse_mem(value)


@pytest.mark.parametrize("value", ["14-0", "2:30:00", "90", "1-12"])
def test_parse_max_age_matches(value):
    assert jconfig.parse_max_age(value) == tconfig.parse_max_age(value)


def test_federation_refused_naming_a14(tmp_path):
    """The ``Federation:`` block through both packages: the same shard
    map (shards, addresses, followers, epoch), the same global limits and
    shard name, no limits without ``Limits:``, no map without the block,
    and the same refusals of a partition owned by two shards or by none.
    """
    text = FULL + """
Federation:
  ShardName: s0
  Epoch: 3
  Limits:
    MaxJobsPerUser: 6
    MaxSubmitJobsPerAccount: 40
    PublishSlack: 2
  Shards:
    - name: s0
      partitions: [batch, debug]
      address: 127.0.0.1:1
      followers: [127.0.0.1:2]
    - name: s1
      partitions: [gpu]
      address: 127.0.0.1:3
"""
    path = _write(tmp_path, text)
    jcfg, tcfg = jconfig.load_config(path), tconfig.load_config(path)
    jmap, tmap = jcfg.shard_map(), tcfg.shard_map()
    assert tmap.doc() == jmap.doc()
    assert (tmap.epoch, tmap.names()) == (jmap.epoch, jmap.names()) == \
        (3, ["s0", "s1"])
    assert tmap.shard_for_partition("gpu") == "s1"
    assert dataclasses.asdict(tcfg.global_limits()) == \
        dataclasses.asdict(jcfg.global_limits())
    assert tcfg.global_limits().max_jobs_per_user == 6
    assert tcfg.shard_name == jcfg.shard_name == "s0"
    plain = _write(tmp_path, FULL)
    for mod in (jconfig, tconfig):
        cfg = mod.load_config(plain)
        assert cfg.shard_map() is None and cfg.global_limits() is None
        assert cfg.shard_name == ""
    no_limits = _write(tmp_path, text.replace(
        "  Limits:\n    MaxJobsPerUser: 6\n"
        "    MaxSubmitJobsPerAccount: 40\n    PublishSlack: 2\n", ""))
    assert tconfig.load_config(no_limits).global_limits() is None
    for bad, match in ((text.replace("partitions: [gpu]",
                                     "partitions: [gpu, batch]"),
                        "owned by both"),
                       (text.replace("partitions: [gpu]",
                                     "partitions: []"), "owned by no")):
        errors = []
        for mod in (jconfig, tconfig):
            with pytest.raises(ValueError, match=match) as info:
                mod.load_config(_write(tmp_path, bad)).shard_map()
            errors.append(str(info.value))
        assert errors[0] == errors[1]


@pytest.mark.parametrize("name,device,want", [
    ("auto", None, "cuda"), ("Auto", "cuda", "cuda"),
    ("auto", "cuda:0", "cuda"), ("auto", "cpu", "auto"), ("native", None, "native"),
    ("device", None, "device"), ("cuda", "cpu", "cuda")])
def test_auto_solver_is_the_kernel_on_the_card(name, device, want):
    """The JAX package's default solver, ``auto`` (and etc/config.yaml's),
    is the greedy kernel when the scheduler is on the card, and keeps its
    meaning (the C++ solver where it can) on the CPU."""
    assert tconfig.solver_for(name, device) == want


def test_build_defaults_to_the_card():
    """build() with no device is the card's: off the card it raises
    rather than carrying on on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    cfg = tconfig.load_config(os.path.join(REPO, "etc", "config.yaml"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.build()
