"""craned: the node daemon entry point (reference src/Craned/Core/
Craned.cpp bootstrap).

    python -m cranesched_tpu_torch.craned_main --name cn01 \\
        --ctld 127.0.0.1:50051 --cpu 16 --memory 64G

The port's copy of ``cranesched_tpu/craned_main.py``,
with the port's imports.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def _parse_gres(text: str) -> dict:
    """'gpu:a100:2,fpga::1' -> {"gpu:a100": 2, "fpga:": 1} (the JAX
    package's ``cli._parse_gres``; the daemon normalizes the keys)."""
    out = {}
    for part in text.split(","):
        bits = part.split(":")
        if len(bits) == 3:
            name, typ, count = bits
        elif len(bits) == 2:
            name, count = bits
            typ = ""
        else:
            raise SystemExit(f"crane: bad --gres {part!r} "
                             "(use name[:type]:count)")
        try:
            n = int(count)
        except ValueError:
            raise SystemExit(f"crane: bad --gres count {count!r}")
        if n < 1:
            raise SystemExit(f"crane: --gres count must be >= 1, "
                             f"got {n}")
        out[f"{name}:{typ}"] = n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="craned")
    ap.add_argument("--name", required=True)
    ap.add_argument("--ctld", required=True,
                    help="ctld address, or a comma-separated list for "
                         "an HA pair (rotates to the leader)")
    ap.add_argument("--cpu", type=float, default=8.0)
    ap.add_argument("--memory", default="16G")
    ap.add_argument("--partitions", default="default")
    ap.add_argument("--workdir", default="/tmp")
    ap.add_argument("--listen", default="127.0.0.1:0")
    ap.add_argument("--ping-interval", type=float, default=5.0)
    ap.add_argument("--cgroup-root", default="/sys/fs/cgroup")
    ap.add_argument("--health-program", default="")
    ap.add_argument("--health-interval", type=float, default=30.0)
    ap.add_argument("--gres", default="",
                    help="name[:type]:count, comma-separated")
    ap.add_argument("--gres-devices", default="",
                    help="device files backing GRES slots for the "
                         "kernel cgroup ACL: name[:type]=/dev/a;/dev/b"
                         " entries, comma-separated (reference "
                         "config.yaml Gres device files)")
    ap.add_argument("--token", default="",
                    help="cluster secret for auth-enabled ctlds "
                         "(the @craned entry in the token table)")
    ap.add_argument("--token-file", default="",
                    help="read the cluster secret's token from a file")
    ap.add_argument("--prolog", default="",
                    help="task prolog script (bash -c) run before "
                         "every step; failure fails the step and "
                         "drains this node")
    ap.add_argument("--epilog", default="",
                    help="task epilog script run after every step; "
                         "failure drains this node")
    ap.add_argument("--tls-ca", default="",
                    help="cluster CA cert: dial the ctld over TLS "
                         "(requires --tls-cert/--tls-key)")
    ap.add_argument("--tls-cert", default="",
                    help="this node's cert (serves the push surface "
                         "over TLS; presented to mTLS ctlds)")
    ap.add_argument("--tls-key", default="",
                    help="this node's key")
    ap.add_argument("--container-runtime", default=None,
                    help="OCI runtime CLI for container steps "
                         "(default: auto-detect podman/docker; "
                         "'' disables)")
    ap.add_argument("--tls-name",
                    default=os.environ.get("CRANE_TLS_NAME", "ctld"),
                    help="name the ctld's cert is issued under "
                         "(identity pin for the dial; default ctld)")
    ap.add_argument("--log-file", default="",
                    help="rotating log file (32 MiB x 5 by default)")
    ap.add_argument("--log-level", default="info")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="Prometheus /metrics port (0 = ephemeral; "
                         "unset = endpoint off)")
    args = ap.parse_args(argv)
    from cranesched_tpu_torch.utils.logging import setup_logging
    setup_logging("craned", args.log_file, args.log_level)
    if args.tls_ca and not (args.tls_cert and args.tls_key):
        ap.error("--tls-ca requires --tls-cert and --tls-key "
                 "(a CA-only craned would serve a plaintext push "
                 "surface no TLS ctld can dispatch to)")

    token = args.token
    if not token and args.token_file:
        with open(args.token_file, encoding="utf-8") as fh:
            token = fh.read().strip()

    from cranesched_tpu_torch.craned.daemon import CranedDaemon
    from cranesched_tpu_torch.utils.config import parse_mem
    from cranesched_tpu_torch.utils.pki import TlsConfig

    gres = _parse_gres(args.gres) if args.gres else {}
    gres_devices = {}
    for entry in filter(None, args.gres_devices.split(",")):
        key, _, paths = entry.partition("=")
        gres_devices[key.strip()] = [p for p in paths.split(";") if p]

    daemon = CranedDaemon(
        args.name, args.ctld, cpu=args.cpu,
        mem_bytes=parse_mem(args.memory),
        partitions=tuple(args.partitions.split(",")),
        workdir=args.workdir, ping_interval=args.ping_interval,
        cgroup_root=args.cgroup_root,
        health_program=args.health_program,
        health_interval=args.health_interval,
        gres=gres, gres_devices=gres_devices, token=token,
        prolog=args.prolog, epilog=args.epilog,
        tls=(TlsConfig(ca=args.tls_ca, cert=args.tls_cert,
                       key=args.tls_key)
             if args.tls_ca else None),
        tls_name=args.tls_name,
        container_runtime=args.container_runtime,
        # the well-known PAM socket path is host-wide: only a craned
        # deployed on the default workdir publishes it
        pam_alias=args.workdir == ap.get_default("workdir"),
        metrics_port=args.metrics_port)
    port = daemon.start(args.listen)
    print(f"craned {args.name} serving on port {port}, "
          f"registering with {args.ctld}", flush=True)
    if daemon.metrics_port is not None:
        print(f"metrics: http://0.0.0.0:{daemon.metrics_port}/metrics",
              flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
