"""cranectld: the control-plane daemon of the port (port of
``cranesched_tpu/ctld_main.py``).

Mirrors the reference's CraneCtld bootstrap (reference:
src/CraneCtld/CraneCtld.cpp:1019-1279 — config parse, global init in
dependency order, recovery from the embedded DB, then serve):

    python -m cranesched_tpu_torch.ctld_main -c etc/config.yaml
    python -m cranesched_tpu_torch.ctld_main -c etc/config.yaml --sim
    python -m cranesched_tpu_torch.ctld_main -c etc/config.yaml --sim \\
        --device cpu
    python -m cranesched_tpu_torch.ctld_main -c standby.yaml \\
        --ha-standby --ha-peer LEADER_HOST:PORT

The scheduler runs on the CUDA card (``--device cuda``, the default),
acquired first within a time budget (``CRANE_ACQUIRE_TIMEOUT``); if the
card cannot be acquired the daemon exits non-zero with the diagnosis and
never carries on on the CPU.  ``--device cpu`` runs it on the CPU.

Without ``--sim`` the ctld drives the real node plane: ``craned_main``
processes register over gRPC (``CranedRegister``), and the dispatcher
(``rpc/dispatcher.py``) pushes each placement to them.  ``--sim``
attaches the in-process simulated node plane instead (every configured
node is immediately alive and runs jobs on the virtual completion
queue).

A ``Federation:`` block makes the daemon one shard of a federation
(``fed/``): its lease and migration plane and, with ``Limits:``, the
cluster-wide usage book attach before recovery; the server forwards
misrouted submits to their owner and pulls its peers' usage.  Every
shard runs its own scheduler on its own card (or on the device named).

``--ha-standby --ha-peer ADDR`` starts a hot standby of the leader at
ADDR: it takes the card like a leader, replicates the leader's snapshot
and WAL tail into its own WAL (its config names its own ``Wal:``), serves
queries and refuses mutations, runs no cycle, and promotes itself once
the leader's lease frees (``ha/follower.py``).

The first stdout line is the ``listening on port N`` banner: wrappers
parse the bound port out of it.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


def _stderr_event(type: str, severity: str, detail: str = "") -> None:
    """Event sink of the boot path, before a scheduler (and its event
    log) exists: one JSON line on stderr."""
    print("event: " + json.dumps({"type": type, "severity": severity,
                                  "detail": detail}),
          file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cranectld")
    ap.add_argument("--config", "-c", required=True)
    ap.add_argument("--sim", action="store_true",
                    help="simulated node plane (no real craneds)")
    ap.add_argument("--device", default="cuda",
                    help="the scheduler's device: cuda (the card, the "
                         "default) or cpu")
    ap.add_argument("--listen", default="",
                    help="override the config listen address")
    ap.add_argument("--cycle-interval", type=float, default=1.0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="Prometheus /metrics port (overrides config "
                         "Observability.MetricsPort; 0 = ephemeral)")
    ap.add_argument("--log-file", default="",
                    help="rotating log file (32 MiB x 5 by default)")
    ap.add_argument("--log-level", default="info")
    ap.add_argument("--ha-standby", action="store_true",
                    help="start as a hot standby: replicate from "
                         "--ha-peer, serve queries only, and promote "
                         "when the leader's lease frees")
    ap.add_argument("--ha-peer", default="",
                    help="the other ctld's address (the leader to "
                         "replicate from when --ha-standby; advertised "
                         "to redirected clients otherwise)")
    ap.add_argument("--snapshot-interval", type=float, default=60.0,
                    help="seconds between WAL snapshots (leader only; "
                         "0 disables)")
    args = ap.parse_args(argv)
    if args.ha_standby and not args.ha_peer:
        ap.error("--ha-standby requires --ha-peer")

    # bounded acquisition of the card BEFORE the first cycle can touch
    # it under the RPC lock; the event goes out first, then the daemon
    # stops: it never carries on on the CPU unless asked to.  A standby
    # takes the card here too, so a promotion never waits on it
    from cranesched_tpu_torch.parallel.acquire import ensure_device
    acquisition = ensure_device(args.device, event_sink=_stderr_event)
    if not acquisition.get("acquired", False):
        print(f"FATAL: cannot acquire the card — "
              f"{acquisition.get('diagnosis', '(no diagnosis)')} "
              f"(pass --device cpu to run on the CPU)",
              file=sys.stderr, flush=True)
        return 1

    from cranesched_tpu_torch.utils.logging import setup_logging
    log = setup_logging("ctld", args.log_file, args.log_level)
    log.info("cranectld starting (config=%s, device=%s)", args.config,
             args.device)

    from cranesched_tpu_torch.craned.sim import SimCluster
    from cranesched_tpu_torch.ctld.wal import WriteAheadLog
    from cranesched_tpu_torch.rpc.dispatcher import GrpcDispatcher
    from cranesched_tpu_torch.rpc.server import serve
    from cranesched_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    meta, scheduler = cfg.build(device=args.device)

    if cfg.acct_store_path and scheduler.accounts is not None:
        print(f"accounting store: {cfg.acct_store_path} "
              f"({len(scheduler.accounts.accounts)} accounts, "
              f"{len(scheduler.accounts.users)} users, "
              f"{len(scheduler.accounts.qos)} qos)", file=sys.stderr,
              flush=True)

    if cfg.archive_path:
        from cranesched_tpu_torch.ctld.archive import JobArchive
        os.makedirs(os.path.dirname(cfg.archive_path) or ".",
                    exist_ok=True)
        scheduler.attach_archive(JobArchive(cfg.archive_path))
        print(f"history archive: {cfg.archive_path} "
              f"({scheduler.archive.count()} jobs)", file=sys.stderr,
              flush=True)

    # federation plane BEFORE recovery: the replay must filter
    # committed migrations' jobs and rebuild imported node meta
    # (fed.prepare_recovery inside recover_from_snapshot), and the
    # UsageBook must exist before scheduler.recover backfills
    # note_submit/note_run for boot-restored jobs — a restarted leader
    # that published zero usage would let every peer's gate overshoot.
    shard_map = cfg.shard_map()
    shard_name = cfg.shard_name
    if shard_map is not None:
        # leases + live-migration WAL protocol ride on the scheduler
        # (fed/shard.py self-attaches as .fed), and Federation:
        # Limits: turns on the cluster-wide UsageBook
        from cranesched_tpu_torch.fed.shard import FedShardPlane
        FedShardPlane(scheduler, shard_name)
        limits = cfg.global_limits()
        if limits is not None:
            from cranesched_tpu_torch.fed.usage import (
                UsageBook,
                effective_publish_slack,
            )
            # PublishSlack = admissions a shard may run ahead of what
            # its slowest peer CONFIRMED pulling (the conservative
            # gate subtracts (shards-1)*slack from every global
            # limit); 8 absorbs a burst of submits inside one gossip
            # interval.  Clamped so a small global limit stays
            # satisfiable — unclamped, limit <= (shards-1)*slack
            # would deny every submit forever.
            asked = int((cfg.federation.get("Limits") or {})
                        .get("PublishSlack", 8))
            n_shards = len(shard_map.shards)
            slack, asked = effective_publish_slack(
                limits, n_shards, asked)
            if slack != asked:
                print(f"WARNING: PublishSlack={asked} leaves no "
                      f"admissible headroom under the configured "
                      f"global limits with {n_shards} shards — "
                      f"clamped to {slack}",
                      file=sys.stderr, flush=True)
            scheduler.global_usage = UsageBook(
                shard_name, limits,
                n_shards=n_shards,
                publish_slack=slack,
                seq_source=lambda: (scheduler.wal.durable_seq
                                    if scheduler.wal is not None
                                    else 0),
                peers=tuple(sorted(shard_map.shards)))
        print(f"federation shard {shard_name!r}: "
              f"{len(shard_map.shards)} shards, map epoch "
              f"{shard_map.epoch}"
              + (", global limits on" if limits is not None else ""),
              file=sys.stderr, flush=True)

    # recovery before serving (reference JobScheduler::Init).  A leader
    # takes the WAL-dir lease FIRST: a second ctld pointed at the same
    # WAL fails fast instead of corrupting the log.  A standby skips all
    # of this — its follower thread seeds from its own local
    # snapshot+WAL and only opens them for writing at promotion.
    lease = None
    if cfg.wal_path:
        # both roles write under the WAL dir (the standby keeps its
        # replicated WAL, snapshot, and observed epoch there)
        os.makedirs(os.path.dirname(cfg.wal_path) or ".", exist_ok=True)
    if cfg.wal_path and not args.ha_standby:
        from cranesched_tpu_torch.ha import LeaderLease
        from cranesched_tpu_torch.ha.snapshot import recover_from_snapshot
        from cranesched_tpu_torch.utils.filelock import FileLockHeld
        lease = LeaderLease(cfg.wal_path)
        try:
            epoch = lease.acquire()
        except FileLockHeld:
            print(f"FATAL: another ctld holds the lease on "
                  f"{cfg.wal_path} (is a leader already running?); "
                  f"start this one with --ha-standby to follow it",
                  file=sys.stderr, flush=True)
            return 1
        scheduler.fencing_epoch = epoch
        if args.sim:
            for node in meta.nodes.values():
                node.alive = True
        count, snap_seq = recover_from_snapshot(
            scheduler, WriteAheadLog, cfg.wal_path, now=time.time())
        # stderr: the first STDOUT line stays the "listening on port"
        # banner (wrappers parse the bound port out of it)
        if count:
            print(f"recovered {count} jobs from {cfg.wal_path}"
                  + (f" (snapshot @seq={snap_seq} + tail)"
                     if snap_seq else ""),
                  file=sys.stderr, flush=True)
        scheduler.wal = WriteAheadLog(cfg.wal_path)
        print(f"leader lease acquired (fencing epoch {epoch})",
              file=sys.stderr, flush=True)
        fed = getattr(scheduler, "fed", None)
        if fed is not None:
            # lease tombstoning + migrated-away node re-death, and any
            # begin with no commit/abort surfaces unresolved (the RPC
            # server's resolve loop settles it against the dest)
            fed.recover(time.time())
            unresolved = fed.recover_migrations(time.time())
            if unresolved:
                mids = ", ".join(r["mid"] for r in unresolved)
                print(f"WARNING: {len(unresolved)} unresolved "
                      f"migration(s) [{mids}] — partitions stay "
                      f"sealed until the destination's has_import "
                      f"answer settles them",
                      file=sys.stderr, flush=True)

    sim = None
    dispatcher = None
    tls = cfg.tls_config()
    if args.sim:
        for node in meta.nodes.values():
            node.alive = True
        sim = SimCluster(scheduler)
        sim.wire(scheduler)
    else:
        dispatcher = GrpcDispatcher(
            scheduler, tls=tls.for_client() if tls else None)
        dispatcher.wire(scheduler)

    if cfg.node_event_hook_path:
        from cranesched_tpu_torch.utils.config import (
            make_node_event_script_hook)
        scheduler.node_event_hook = make_node_event_script_hook(
            cfg.node_event_hook_path)

    auth = None
    if cfg.auth_token_file:
        from cranesched_tpu_torch.ctld.auth import AuthManager
        os.makedirs(os.path.dirname(cfg.auth_token_file) or ".",
                    exist_ok=True)
        auth = AuthManager(cfg.auth_token_file,
                           admins=tuple(cfg.auth_admins),
                           accounts=scheduler.accounts)
        print(f"auth enabled (token table {cfg.auth_token_file}; "
              f"root + craned tokens inside)", file=sys.stderr,
              flush=True)

    metrics_port = (args.metrics_port if args.metrics_port is not None
                    else cfg.metrics_port)
    address = args.listen or cfg.listen
    server, port = serve(scheduler, sim=sim, address=address,
                         cycle_interval=args.cycle_interval,
                         dispatcher=dispatcher, auth=auth, tls=tls,
                         metrics_port=metrics_port,
                         shard_name=shard_name, shard_map=shard_map,
                         standby=args.ha_standby,
                         peer_address=args.ha_peer)
    # the handlers go in before the banner: a SIGTERM sent once the
    # banner is read stops the daemon cleanly, whatever setup is left
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    print(f"cranectld [{cfg.cluster_name}] listening on port {port} "
          f"({'simulated' if args.sim else 'real'} node plane, "
          f"{len(meta.nodes)} nodes configured, "
          f"device {scheduler.device}"
          f"{', TLS' if tls else ''}"
          f"{', STANDBY of ' + args.ha_peer if args.ha_standby else ''}"
          ")", flush=True)
    if server.metrics_port is not None:
        print(f"metrics: http://0.0.0.0:{server.metrics_port}/metrics",
              flush=True)

    # HA plumbing needs the server lock, so it starts after serve()
    snapshotter = None
    follower = None
    if cfg.wal_path:
        from cranesched_tpu_torch import ha as _ha

        def _start_snapshotter():
            nonlocal snapshotter
            if args.snapshot_interval <= 0:
                return
            snapshotter = _ha.Snapshotter(
                scheduler, scheduler.wal, server._lock, cfg.wal_path,
                interval=args.snapshot_interval)
            snapshotter.start()

        if args.ha_standby:
            follower = _ha.HaFollower(
                server, args.ha_peer, cfg.wal_path,
                token=(auth.craned_token if auth is not None else ""),
                tls=tls.for_client() if tls else None,
                on_promote=lambda epoch: _start_snapshotter())
            server.ha_follower = follower
            follower.start()
            print(f"hot standby: replicating from {args.ha_peer}",
                  flush=True)
        else:
            _ha.ROLE_GAUGE.set(1)
            _start_snapshotter()

    syncer = None
    if cfg.license_sync.get("Program"):
        from cranesched_tpu_torch.ctld.licenses import LicenseSyncer
        syncer = LicenseSyncer(
            scheduler.licenses, str(cfg.license_sync["Program"]),
            interval=float(cfg.license_sync.get("Interval", 60)),
            lock=server._lock)
        syncer.sync_once()   # first observation before the first cycle
        syncer.start()
        print(f"license sync: {cfg.license_sync['Program']} "
              f"every {syncer.interval:g}s", flush=True)

    stop.wait()
    if syncer is not None:
        syncer.stop()
    if follower is not None:
        follower.stop()
    if snapshotter is not None:
        snapshotter.stop()
    server.stop()
    if lease is not None:
        lease.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
