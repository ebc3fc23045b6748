"""YAML cluster configuration (port of ``cranesched_tpu/utils/config.py``;
reference etc/config.yaml → Ctld::Config, CtldPublicDefs.h:92-258): node
inventory with hostlist expressions, partitions with priorities and ACLs,
priority weights, scheduler knobs, WAL path, and the listen address.
``build()`` turns a parsed config into live control-plane objects on the
card (or on the device the caller names).  The ``Federation:`` block
(``shard_map()``, ``global_limits()``, ``shard_name``) is read as the JAX
package reads it."""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import yaml

from cranesched_tpu_torch.utils.hostlist import parse_hostlist

def solver_for(name: str, device) -> str:
    """``Scheduler: Solver`` as the scheduler on ``device`` (None = the
    card) runs it.  The JAX package's default, ``auto``, picks the C++
    solver on the host wherever it can take the shape; on the card the
    greedy kernel's cycle solves the north-star shape several times
    faster than that solver (PERF.md), so there ``auto`` is the kernel,
    ``cuda``.  Off the card ``auto`` keeps the JAX package's meaning,
    and every other name is taken as written."""
    name = name.lower()
    on_card = device is None or str(device).startswith("cuda")
    return "cuda" if name == "auto" and on_card else name


_MEM = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_mem(value) -> int:
    if isinstance(value, (int, float)):
        return int(value)
    text = str(value).strip().lower().removesuffix("b")
    if text and text[-1] in _MEM:
        return int(float(text[:-1]) * _MEM[text[-1]])
    return int(text)


def _parse_onoff(value) -> bool:
    """YAML on/off/true/false (the reference uses "on"/"off" strings
    for feature switches; PyYAML already maps on->True, but keep the
    string forms working for hand-built dicts)."""
    if isinstance(value, str):
        return value.strip().lower() in ("on", "true", "yes", "1")
    return bool(value)


def _parse_slo(entries) -> tuple:
    """``Observability: SLO:`` list -> SchedulerConfig.slo tuples
    (name, from, to, p, target_seconds, windows) — the SloSpec.as_tuple
    shape obs/slo.py consumes."""
    out = []
    for e in entries or ():
        if isinstance(e, dict):
            frm, to = str(e["from"]), str(e["to"])
            out.append((
                str(e.get("name", f"{frm}-to-{to}")), frm, to,
                float(e.get("p", 99)), float(e["target_seconds"]),
                tuple(float(w) for w in e.get("windows",
                                              (60, 300, 3600)))))
        else:
            out.append(tuple(e))
    return tuple(out)


def parse_max_age(value) -> int:
    """Reference PriorityMaxAge formats (CraneCtld.cpp:327-364):
    "day-hour", "hour:minute:second", "minute", plain seconds."""
    text = str(value).strip()
    if re.fullmatch(r"\d+", text):
        return int(text) * 60  # bare number = minutes (reference :352)
    m = re.fullmatch(r"(\d+)-(\d+)", text)
    if m:
        return int(m.group(1)) * 86400 + int(m.group(2)) * 3600
    m = re.fullmatch(r"(\d+):(\d+):(\d+)", text)
    if m:
        return (int(m.group(1)) * 3600 + int(m.group(2)) * 60
                + int(m.group(3)))
    raise ValueError(f"bad MaxAge {value!r}")


@dataclasses.dataclass
class NodeConfig:
    names: list[str]
    cpu: float
    mem_bytes: int
    partitions: list[str]
    # GRES inventory: (name, type) -> slots, e.g. {("gpu","a100"): 4}
    # (reference device config, etc/config.yaml:139-160)
    gres: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PartitionConfig:
    name: str
    priority: int = 0
    allowed_accounts: list[str] | None = None
    denied_accounts: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CraneConfig:
    cluster_name: str = "crane"
    listen: str = "127.0.0.1:50051"
    wal_path: str = ""
    # durable history (sqlite; the reference's MongoDB role) — empty =
    # RAM-only history that dies with the process
    archive_path: str = ""
    # durable accounting hierarchy + txn log (sqlite; the reference's
    # user/account/qos MongoDB collections, DbClient.h:87-724) — empty =
    # RAM-only accounting that dies with the process
    acct_store_path: str = ""
    nodes: list[NodeConfig] = dataclasses.field(default_factory=list)
    partitions: list[PartitionConfig] = dataclasses.field(
        default_factory=list)
    scheduler: dict[str, Any] = dataclasses.field(default_factory=dict)
    priority: dict[str, Any] = dataclasses.field(default_factory=dict)
    licenses: list[dict] = dataclasses.field(default_factory=list)
    # path to a Python submit hook module defining
    # job_submit(spec) -> spec | None (reference JobSubmitLuaScript,
    # etc/config.yaml:119)
    submit_hook_path: str = ""
    # accounting: RootUsers bootstrap the RBAC hierarchy; empty list =
    # accounting (and its limits) disabled — the open system
    accounting_root_users: list = dataclasses.field(default_factory=list)
    # authentication (reference CheckCertAndUIDAllowed_ analog): token
    # table path enables it; Admins are always-admin identities
    auth_token_file: str = ""
    auth_admins: list = dataclasses.field(default_factory=lambda: ["root"])
    # node lifecycle event hook script (reference NodeEventHook,
    # Plugin.proto:75-95): run with CRANE_EVENT/CRANE_NODE/... env on
    # up/down/drain/undrain/power transitions
    node_event_hook_path: str = ""
    # transport security (reference TLS domains CtldPublicDefs.h:
    # 133-143): Tls: {Ca, Cert, Key, RequireClientCert} — empty Ca =
    # plaintext wire (sims, trusted loopback)
    tls: dict[str, Any] = dataclasses.field(default_factory=dict)
    # remote license reconciliation (reference server-synced licenses,
    # LicenseManager.h:46-125): LicenseSync: {Program, Interval}
    license_sync: dict[str, Any] = dataclasses.field(
        default_factory=dict)
    # observability (obs/): Observability: {MetricsPort, CycleTraceRing}
    # — MetricsPort absent/None = no /metrics endpoint, 0 = ephemeral
    observability: dict[str, Any] = dataclasses.field(
        default_factory=dict)
    # interconnect topology (topo/): Topology: {Torus + Slice} shorthand
    # or explicit {Blocks, Switches} tree — empty = no topology (gangs
    # place with no locality restriction)
    topology: dict[str, Any] = dataclasses.field(default_factory=dict)
    # federated control plane (fed/): Federation: {ShardName, Shards:
    # [{name, partitions, address}]} — empty = single-controller cluster
    federation: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def metrics_port(self) -> int | None:
        port = self.observability.get("MetricsPort")
        return None if port is None else int(port)

    def tls_config(self):
        """-> utils.pki.TlsConfig for the ctld server, or None."""
        if not self.tls.get("Ca"):
            return None
        from cranesched_tpu_torch.utils.pki import TlsConfig
        return TlsConfig(
            ca=str(self.tls["Ca"]),
            cert=str(self.tls.get("Cert", "") or ""),
            key=str(self.tls.get("Key", "") or ""),
            require_client_cert=bool(
                self.tls.get("RequireClientCert", False)))

    def shard_map(self):
        """-> fed.shardmap.ShardMap from the ``Federation:`` section, or
        None for a single-controller cluster."""
        if not self.federation:
            return None
        from cranesched_tpu_torch.fed.shardmap import ShardMap
        # validate against the cluster's partition inventory: a
        # configured partition no shard owns routes submits nowhere
        return ShardMap.from_config(
            self.federation,
            configured_partitions=[p.name for p in self.partitions])

    def global_limits(self):
        """-> fed.usage.GlobalLimits from ``Federation: Limits:``, or
        None when the section is absent (per-shard limits only)."""
        section = self.federation.get("Limits") if self.federation \
            else None
        if not section:
            return None
        from cranesched_tpu_torch.fed.usage import GlobalLimits
        return GlobalLimits.from_config(section)

    @property
    def shard_name(self) -> str:
        """This controller's shard identity (``Federation: ShardName``);
        empty string outside a federation."""
        return str(self.federation.get("ShardName", "") or "")

    def build(self, device=None):
        """-> (MetaContainer, JobScheduler); nodes start down until their
        craneds register.  ``device`` is the scheduler's (None = the
        CUDA card; ``"cpu"`` off the card)."""
        from cranesched_tpu_torch.ctld.meta import MetaContainer
        from cranesched_tpu_torch.ctld.scheduler import (
            JobScheduler, SchedulerConfig)
        from cranesched_tpu_torch.models.priority import PriorityWeights
        from cranesched_tpu_torch.ops.resources import ResourceLayout

        # the GRES inventory across all nodes defines the tensor layout
        # (a static compile-time axis, reference treats device config as
        # cluster topology)
        gres_pairs = sorted({key for n in self.nodes for key in n.gres})
        layout = ResourceLayout.from_gres_names(gres_pairs)
        meta = MetaContainer(layout)
        for part in self.partitions:
            meta.add_partition(
                part.name, priority=part.priority,
                allowed_accounts=part.allowed_accounts,
                denied_accounts=part.denied_accounts)
        for node_cfg in self.nodes:
            for name in node_cfg.names:
                meta.add_node(
                    name,
                    meta.layout.encode(cpu=node_cfg.cpu,
                                       mem_bytes=node_cfg.mem_bytes,
                                       memsw_bytes=node_cfg.mem_bytes,
                                       gres=node_cfg.gres,
                                       is_capacity=True),
                    partitions=tuple(node_cfg.partitions))
        if self.topology:
            from cranesched_tpu_torch.topo.model import Topology
            meta.set_topology(Topology.from_config(
                self.topology, name_to_id=meta._name_to_id,
                num_nodes=len(meta.nodes)))

        pr = self.priority
        weights = PriorityWeights(
            age=float(pr.get("WeightAge", 500)),
            partition=float(pr.get("WeightPartition", 1000)),
            job_size=float(pr.get("WeightJobSize", 0)),
            fair_share=float(pr.get("WeightFairShare", 10000)),
            qos=float(pr.get("WeightQoS", 1000000)),
            favor_small=bool(pr.get("FavorSmall", True)),
            max_age=parse_max_age(pr.get("MaxAge", "14-0")))
        sc = self.scheduler
        config = SchedulerConfig(
            schedule_batch_size=int(sc.get("ScheduledBatchSize", 100000)),
            pending_queue_max_size=int(sc.get("PendingQueueMaxSize",
                                              900000)),
            max_nodes_per_job=int(sc.get("MaxNodesPerJob", 8)),
            priority_type=("basic" if str(pr.get("Type", "multifactor"))
                           .endswith("basic") else "multifactor"),
            priority_weights=weights,
            backfill=bool(sc.get("Backfill", True)),
            time_resolution=float(sc.get("TimeResolutionSec", 60)),
            time_buckets=int(sc.get("TimeBuckets", 64)),
            time_horizon=(float(sc["TimeHorizonSec"])
                          if sc.get("TimeHorizonSec") else None),
            cycle_trace_ring=int(
                self.observability.get("CycleTraceRing", 64)),
            craned_timeout=float(sc.get("CranedTimeoutSec", 30)),
            preempt_mode=str(sc.get("PreemptMode", "off")).lower(),
            solver=solver_for(str(sc.get("Solver", "auto")), device),
            # post-commit push fan-out width; None lets the dispatcher
            # derive it from cluster size (max(8, nodes // 64), cap 128)
            dispatch_workers=(int(sc["DispatchWorkers"])
                              if sc.get("DispatchWorkers") else None),
            # incremental cycle state (PendingTable + delta snapshot +
            # no-op fingerprint); off = from-scratch rebuild every tick
            incremental=bool(sc.get("Incremental", True)),
            # provably-idle loop sleep bound (event kicks end it early)
            cycle_idle_sleep=float(sc.get("CycleIdleSleep", 30)),
            # device-resident ClusterState across cycles (dirty-row
            # scatter patch instead of a full [N, R] upload per tick)
            resident_state=bool(sc.get("ResidentState", True)),
            # S-stream kernel solve knobs (no H100 sweep yet: A12)
            max_streams=int(sc.get("MaxStreams", 4)),
            block_jobs=int(sc.get("BlockJobs", 256)),
            # per-job lifecycle tracing (obs/jobtrace.py) + SLO targets
            # (obs/slo.py) from the Observability: block
            job_trace=_parse_onoff(
                self.observability.get("JobTrace", True)),
            job_trace_capacity=int(
                self.observability.get("JobTraceCapacity", 4096)),
            slo=_parse_slo(self.observability.get("SLO")))
        hook = None
        if self.submit_hook_path:
            hook = load_submit_hook(self.submit_hook_path)
        accounts = None
        if self.accounting_root_users or self.acct_store_path:
            from cranesched_tpu_torch.ctld.accounting import (
                AccountManager, AdminLevel, User)
            accounts = AccountManager()
            for name in self.accounting_root_users:
                accounts.users[str(name)] = User(
                    name=str(name), admin_level=AdminLevel.ROOT)
            if self.acct_store_path:
                # restore the persisted hierarchy BEFORE any WAL replay
                # so recovered jobs can re-take QoS usage against it
                import os as _os

                from cranesched_tpu_torch.ctld.acct_store import (
                    AccountStore, attach_store)
                _os.makedirs(_os.path.dirname(self.acct_store_path)
                             or ".", exist_ok=True)
                attach_store(accounts, AccountStore(self.acct_store_path))
                # config-declared root users always keep ROOT: a stored
                # plain-user record must not demote the only admins and
                # lock operators out at boot (admin_level can only be
                # fixed BY an admin)
                for name in self.accounting_root_users:
                    rec = accounts.users.get(str(name))
                    if rec is None:
                        accounts.users[str(name)] = User(
                            name=str(name),
                            admin_level=AdminLevel.ROOT)
                    elif rec.admin_level < AdminLevel.ROOT:
                        rec.admin_level = AdminLevel.ROOT
        scheduler = JobScheduler(meta, config, submit_hook=hook,
                                 accounts=accounts, device=device)
        for lic in self.licenses:
            scheduler.licenses.configure(
                str(lic["name"]), int(lic.get("total", 0)),
                remote=bool(lic.get("remote", False)))
        return meta, scheduler


def load_submit_hook(path: str):
    """Load job_submit(spec) -> spec | None from a Python file (the
    reference embeds Lua for the same seam; here the operator's hook is
    plain Python)."""
    import importlib.util
    spec_obj = importlib.util.spec_from_file_location("crane_submit_hook",
                                                      path)
    if spec_obj is None or spec_obj.loader is None:
        raise ValueError(f"cannot load submit hook from {path!r} "
                         "(must be a Python file)")
    module = importlib.util.module_from_spec(spec_obj)
    spec_obj.loader.exec_module(module)
    hook = getattr(module, "job_submit", None)
    if hook is None:
        raise ValueError(f"{path} does not define job_submit(spec)")
    return hook


def make_node_event_script_hook(script: str):
    """Wrap an operator script as a node-event callable: one invocation
    per event with CRANE_EVENT / CRANE_NODE / CRANE_DETAIL /
    CRANE_EVENT_TIME in the env (the shell analog of the reference's
    NodeEventHook plugin RPC)."""
    import os
    import subprocess

    def hook(event: dict) -> None:
        env = dict(os.environ,
                   CRANE_EVENT=str(event.get("event", "")),
                   CRANE_NODE=str(event.get("node", "")),
                   CRANE_DETAIL=str(event.get("detail", "")),
                   CRANE_EVENT_TIME=str(event.get("time", "")))
        subprocess.run(["bash", "-c", script], env=env, timeout=60,
                       capture_output=True)

    return hook


def load_config(path: str) -> CraneConfig:
    with open(path, encoding="utf-8") as fh:
        raw = yaml.safe_load(fh) or {}

    nodes = []
    for entry in raw.get("Nodes", []):
        gres = {}
        for key, slots in (entry.get("gres") or {}).items():
            name, _, typ = str(key).partition(":")
            gres[(name, typ)] = int(slots)
        nodes.append(NodeConfig(
            names=parse_hostlist(str(entry["name"])),
            cpu=float(entry.get("cpu", 1)),
            mem_bytes=parse_mem(entry.get("memory", 0)),
            partitions=[str(p) for p in entry.get("partitions",
                                                  ["default"])],
            gres=gres))
    partitions = []
    for entry in raw.get("Partitions", []):
        partitions.append(PartitionConfig(
            name=str(entry["name"]),
            priority=int(entry.get("priority", 0)),
            allowed_accounts=entry.get("AllowedAccounts"),
            denied_accounts=entry.get("DeniedAccounts", [])))
    if not partitions:
        partitions = [PartitionConfig(name="default")]

    return CraneConfig(
        cluster_name=str(raw.get("ClusterName", "crane")),
        listen=str(raw.get("Listen", "127.0.0.1:50051")),
        wal_path=str(raw.get("Wal", "") or ""),
        archive_path=str(raw.get("Archive", "") or ""),
        acct_store_path=str(
            (raw.get("Accounting") or {}).get("Store", "") or ""),
        nodes=nodes,
        partitions=partitions,
        scheduler=raw.get("Scheduler", {}) or {},
        priority=raw.get("Priority", {}) or {},
        licenses=raw.get("Licenses", []) or [],
        submit_hook_path=str(raw.get("SubmitHook", "") or ""),
        accounting_root_users=list(
            (raw.get("Accounting") or {}).get("RootUsers", [])),
        auth_token_file=str(
            (raw.get("Auth") or {}).get("TokenFile", "") or ""),
        auth_admins=[str(a) for a in
                     (raw.get("Auth") or {}).get("Admins", ["root"])],
        node_event_hook_path=str(raw.get("NodeEventHook", "") or ""),
        tls=raw.get("Tls", {}) or {},
        license_sync=raw.get("LicenseSync", {}) or {},
        observability=raw.get("Observability", {}) or {},
        topology=raw.get("Topology", {}) or {},
        federation=raw.get("Federation", {}) or {})
