"""cranectld: the control-plane daemon of the port (port of
``cranesched_tpu/ctld_main.py``).

Mirrors the reference's CraneCtld bootstrap (reference:
src/CraneCtld/CraneCtld.cpp:1019-1279 — config parse, global init in
dependency order, recovery from the embedded DB, then serve):

    python -m cranesched_tpu_torch.ctld_main -c etc/config.yaml
    python -m cranesched_tpu_torch.ctld_main -c etc/config.yaml --sim
    python -m cranesched_tpu_torch.ctld_main -c etc/config.yaml --sim \\
        --device cpu

The scheduler runs on the CUDA card (``--device cuda``, the default),
acquired first within a time budget (``CRANE_ACQUIRE_TIMEOUT``); if the
card cannot be acquired the daemon exits non-zero with the diagnosis and
never carries on on the CPU.  ``--device cpu`` runs it on the CPU.

Without ``--sim`` the ctld drives the real node plane: ``craned_main``
processes register over gRPC (``CranedRegister``), and the dispatcher
(``rpc/dispatcher.py``) pushes each placement to them.  ``--sim``
attaches the in-process simulated node plane instead (every configured
node is immediately alive and runs jobs on the virtual completion
queue).  What the port does not carry yet is refused by its ROADMAP.md
item: a hot standby (``--ha-standby``; A13) and a ``Federation:`` block
(A14).

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


def _refuse(what: str, item: str) -> int:
    print(f"FATAL: {what} is not in the port yet (ROADMAP.md {item})",
          file=sys.stderr, flush=True)
    return 2


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
                    help="start as a hot standby (ROADMAP.md A13)")
    ap.add_argument("--snapshot-interval", type=float, default=60.0,
                    help="seconds between WAL snapshots (0 disables)")
    args = ap.parse_args(argv)
    if args.ha_standby:
        return _refuse("a hot standby (--ha-standby)", "A13")

    # bounded acquisition of the card BEFORE the first cycle can touch
    # it under the RPC lock; the event goes out first, then the daemon
    # stops: it never carries on on the CPU unless asked to
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

    try:
        cfg = load_config(args.config)
        meta, scheduler = cfg.build(device=args.device)
    except NotImplementedError as exc:
        print(f"FATAL: {exc}", file=sys.stderr, flush=True)
        return 2

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

    # recovery before serving (reference JobScheduler::Init).  The
    # leader takes the WAL-dir lease FIRST: a second ctld pointed at the
    # same WAL fails fast instead of corrupting the log
    lease = None
    if cfg.wal_path:
        from cranesched_tpu_torch.ha import LeaderLease
        from cranesched_tpu_torch.ha.snapshot import recover_from_snapshot
        from cranesched_tpu_torch.utils.filelock import FileLockHeld
        os.makedirs(os.path.dirname(cfg.wal_path) or ".", exist_ok=True)
        lease = LeaderLease(cfg.wal_path)
        try:
            epoch = lease.acquire()
        except FileLockHeld:
            print(f"FATAL: another ctld holds the lease on "
                  f"{cfg.wal_path} (is a leader already running?)",
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
                         metrics_port=metrics_port)
    print(f"cranectld [{cfg.cluster_name}] listening on port {port} "
          f"({'simulated' if args.sim else 'real'} node plane, "
          f"{len(meta.nodes)} nodes configured, "
          f"device {scheduler.device}"
          f"{', TLS' if tls else ''})", flush=True)
    if server.metrics_port is not None:
        print(f"metrics: http://0.0.0.0:{server.metrics_port}/metrics",
              flush=True)

    # the snapshotter needs the server lock, so it starts after serve()
    snapshotter = None
    if cfg.wal_path:
        from cranesched_tpu_torch import ha as _ha
        _ha.ROLE_GAUGE.set(1)
        if args.snapshot_interval > 0:
            snapshotter = _ha.Snapshotter(
                scheduler, scheduler.wal, server._lock, cfg.wal_path,
                interval=args.snapshot_interval)
            snapshotter.start()

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

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    if syncer is not None:
        syncer.stop()
    if snapshotter is not None:
        snapshotter.stop()
    server.stop()
    if lease is not None:
        lease.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
