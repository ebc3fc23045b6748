"""In-job coordination library: the PMIx client-side role (port of
``cranesched_tpu/coord.py``).

Job scripts (and multi-host frameworks bootstrapping inside crane
gangs) use this to reach the gang's rendezvous service — hosted by
the rank-0 supervisor and advertised via ``CRANE_RENDEZVOUS``
(reference: PMIx fences/modex, src/Utilities/Pmix/Pmix.h:44; the
fork-env role Pmix.h:54-57).

Python:

    from cranesched_tpu_torch import coord
    coord.fence("ready")                      # gang-wide barrier
    coord.put("rank0-addr", b"10.0.0.5:9999") # modex publish
    addr = coord.get("rank0-addr", timeout=60)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://{coord.coordinator()}",
        world_size=coord.nranks(), rank=coord.rank())

Shell (inside job scripts):

    python -m cranesched_tpu_torch.coord fence ready
    python -m cranesched_tpu_torch.coord put KEY VALUE
    python -m cranesched_tpu_torch.coord get KEY --timeout 60

``coordinator()`` solves the bootstrap port problem properly:
rank 0 binds a FREE port on its host and publishes it through the
modex, so the deterministic CRANE_RENDEZVOUS port is never reused for
the framework's own coordinator (hash-derived ports can collide
between live gangs — the modex-published port cannot).
"""

from __future__ import annotations

import os
import socket
import sys


def rank() -> int:
    return int(os.environ.get("CRANE_NODE_RANK", "0"))


def nranks() -> int:
    return int(os.environ.get("CRANE_NNODES", "1"))


def nodelist() -> str:
    return os.environ.get("CRANE_JOB_NODELIST", "")


def _client():
    from cranesched_tpu_torch.rpc.rendezvous import RendezvousClient
    address = os.environ.get("CRANE_RENDEZVOUS", "")
    if not address:
        raise RuntimeError(
            "no CRANE_RENDEZVOUS in the environment — not inside a "
            "multi-node crane step?")
    tls = None
    ca = os.environ.get("CRANE_RENDEZVOUS_CA", "")
    if ca:
        # TLS cluster: rank-0 serves the fence/modex with its node
        # cert; verify against the cluster CA so the gang token and
        # modex payloads never ride plaintext node-to-node
        from cranesched_tpu_torch.utils.pki import TlsConfig
        tls = TlsConfig(ca=ca)
    return RendezvousClient(
        address, token=os.environ.get("CRANE_RENDEZVOUS_TOKEN", ""),
        tls=tls)


def fence(name: str, data: bytes = b"",
          timeout: float = 300.0) -> list[bytes]:
    """Block until every gang member reaches the fence; returns the
    rank-ordered data contributions.  Single-node gangs return
    immediately (no service exists, none is needed)."""
    if nranks() <= 1:
        return [data]
    client = _client()
    try:
        return client.fence(name, rank(), nranks(), data=data,
                            timeout=timeout)
    finally:
        client.close()


def put(key: str, value: bytes) -> None:
    client = _client()
    try:
        client.put(key, value)
    finally:
        client.close()


def get(key: str, timeout: float = 60.0) -> bytes | None:
    client = _client()
    try:
        return client.get(key, timeout=timeout)
    finally:
        client.close()


def coordinator(timeout: float = 120.0, port: int = 0) -> str:
    """Coordinator address for ``torch.distributed``'s TCP store (or any
    torchrun-style bootstrap): rank 0 picks a port on its host and
    publishes it via the modex; everyone else reads it.

    With ``port=0`` rank 0 probes a free ephemeral port — the probe
    socket closes before the framework rebinds it, so a racing
    process can still steal it in that window (narrow, not zero).
    Deployments that manage ports should pass an explicit ``port``."""
    if nranks() <= 1:
        return "127.0.0.1:0"
    if rank() == 0:
        host = os.environ.get("CRANE_RENDEZVOUS", "").split(":")[0] \
            or socket.gethostname()
        if not port:
            with socket.socket() as s:
                s.setsockopt(socket.SOL_SOCKET,
                             socket.SO_REUSEADDR, 1)
                s.bind(("", 0))
                port = s.getsockname()[1]
        addr = f"{host}:{port}"
        put("crane/coordinator", addr.encode())
        return addr
    value = get("crane/coordinator", timeout=timeout)
    if value is None:
        raise RuntimeError("rank 0 never published the coordinator "
                           "address")
    return value.decode()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="crane-coord")
    sub = ap.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("fence")
    f.add_argument("name")
    f.add_argument("--data", default="")
    f.add_argument("--timeout", type=float, default=300.0)
    p = sub.add_parser("put")
    p.add_argument("key")
    p.add_argument("value")
    g = sub.add_parser("get")
    g.add_argument("key")
    g.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)
    if args.cmd == "fence":
        gathered = fence(args.name, data=args.data.encode(),
                         timeout=args.timeout)
        for i, item in enumerate(gathered):
            if item:
                print(f"{i}:{item.decode(errors='replace')}")
        return 0
    if args.cmd == "put":
        put(args.key, args.value.encode())
        return 0
    value = get(args.key, timeout=args.timeout)
    if value is None:
        return 1
    print(value.decode(errors="replace"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
