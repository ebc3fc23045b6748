"""Command-line tools: the user surface of the framework.

Mirrors the reference's Go CLI command set (reference docs/en/command/:
cbatch, cqueue, cinfo, ccancel, ccontrol, cacct — SURVEY.md §2.7) as
subcommands of one entry point:

    python -m cranesched_tpu_torch.cli cbatch --cpu 4 --mem 8G --time 3600
    python -m cranesched_tpu_torch.cli cqueue
    python -m cranesched_tpu_torch.cli cinfo
    python -m cranesched_tpu_torch.cli ccancel 42
    python -m cranesched_tpu_torch.cli ccontrol hold 42
    python -m cranesched_tpu_torch.cli cacct

The server address comes from --server or $CRANE_SERVER
(default 127.0.0.1:50051).

The port's copy of ``cranesched_tpu/cli.py``, with the port's imports.
It loads no torch: every module a command reaches (the client, the
CraneFored hub, the federated query client, the job trace's renderer,
the PKI) imports without it, so a command costs no torch start-up.
"""

from __future__ import annotations

import argparse
import os
import sys

from cranesched_tpu_torch.utils.gres import parse_gres as _parse_gres


def _parse_mem(text: str) -> int:
    units = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}
    text = text.strip().lower().removesuffix("b")
    if text and text[-1] in units:
        return int(float(text[:-1]) * units[text[-1]])
    return int(text)


def _parse_array(text: str):
    """'0-9', '0-9:2' (stride), '%N' run-limit suffix: '0-9%2'."""
    from cranesched_tpu_torch.rpc import crane_pb2 as pb
    limit = 0
    if "%" in text:
        text, lim = text.split("%", 1)
        limit = int(lim)
    stride = 1
    if ":" in text:
        text, st = text.split(":", 1)
        stride = int(st)
    if "-" in text:
        start, end = text.split("-", 1)
    else:
        start = end = text
    return pb.ArraySpec(start=int(start), end=int(end), stride=stride,
                        max_concurrent=limit)


def _parse_dependency(text: str):
    """'afterok:12', 'after:12+30' (delay), comma-separated."""
    from cranesched_tpu_torch.rpc import crane_pb2 as pb
    deps = []
    for part in text.split(","):
        typ, sep, ref = part.partition(":")
        if not sep or not ref:
            raise SystemExit(
                f"crane: invalid dependency {part!r} "
                "(expected TYPE:JOBID[+delay], e.g. afterok:12)")
        delay = 0.0
        if "+" in ref:
            ref, d = ref.split("+", 1)
            delay = float(d)
        try:
            job_id = int(ref)
        except ValueError:
            raise SystemExit(f"crane: invalid dependency job id {ref!r}")
        deps.append(pb.Dependency(job_id=job_id, type=typ,
                                  delay_seconds=delay))
    return deps


def _token(args) -> str:
    """--token > $CRANE_TOKEN > ~/.crane/token (empty = no auth)."""
    if getattr(args, "token", ""):
        return args.token
    env = os.environ.get("CRANE_TOKEN", "")
    if env:
        return env
    path = os.path.expanduser("~/.crane/token")
    try:
        with open(path, encoding="utf-8") as fh:
            return fh.read().strip()
    except OSError:
        return ""


def _tls(args):
    """--ca > $CRANE_CA > ~/.crane/ca.pem (absent = plaintext dial).

    The dial pins the server identity to the NAME the control-plane
    cert was issued under ($CRANE_TLS_NAME, default "ctld") — any
    other cluster-issued cert, loopback SANs and all, is refused.
    ``--cert``/``--key`` (or $CRANE_CERT/$CRANE_KEY, or
    ~/.crane/cert.pem+key.pem) present this user's cert for
    RequireClientCert (mTLS) clusters."""
    ca = getattr(args, "ca", "") or os.environ.get("CRANE_CA", "")
    if not ca:
        default = os.path.expanduser("~/.crane/ca.pem")
        if os.path.exists(default):
            ca = default
    if not ca:
        return None
    cert = (getattr(args, "cert", "")
            or os.environ.get("CRANE_CERT", ""))
    key = getattr(args, "key", "") or os.environ.get("CRANE_KEY", "")
    if bool(cert) != bool(key):
        raise SystemExit("crane: --cert/$CRANE_CERT and "
                         "--key/$CRANE_KEY go together")
    if not cert:
        dcert = os.path.expanduser("~/.crane/cert.pem")
        dkey = os.path.expanduser("~/.crane/key.pem")
        if os.path.exists(dcert) and os.path.exists(dkey):
            cert, key = dcert, dkey
    from cranesched_tpu_torch.utils.pki import TlsConfig
    return TlsConfig(
        ca=ca, cert=cert, key=key,
        override_authority=os.environ.get("CRANE_TLS_NAME", "ctld"))


def _client(args):
    # a comma-separated --server/$CRANE_SERVER is an HA pair: the
    # client follows the leader across failovers
    from cranesched_tpu_torch.rpc.client import make_client
    return make_client(args.server, token=_token(args), tls=_tls(args))


def cmd_ctoken(args) -> int:
    """Admin: issue (or revoke) a user's bearer token (the reference's
    SignUserCertificate / RevokeCert flow, AccountManager.h:171)."""
    client = _client(args)
    if args.revoke:
        reply = client.revoke_token(args.user)
        if reply.ok:
            print(f"tokens of {args.user} revoked")
            return 0
        print(f"ctoken: {reply.error}", file=sys.stderr)
        return 1
    reply = client.issue_token(args.user)
    if not reply.ok:
        print(f"ctoken: {reply.error}", file=sys.stderr)
        return 1
    if args.save:
        # per-user path: saving another user's token must never
        # clobber the CALLER's own ~/.crane/token (the _token fallback
        # would silently re-identify the admin as that user)
        path = os.path.expanduser(f"~/.crane/token.{args.user}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            fh.write(reply.token)
        print(f"token for {args.user} saved to {path} "
              f"(move to ~/.crane/token on {args.user}'s account)")
    else:
        print(reply.token)
    return 0


def _fmt_table(rows, headers) -> str:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              if rows else len(str(h)) for i, h in enumerate(headers)]
    out = ["  ".join(str(h).ljust(w) for h, w in zip(headers, widths))]
    for r in rows:
        out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


def cmd_cbatch(args) -> int:
    from cranesched_tpu_torch.rpc import crane_pb2 as pb
    spec = _build_spec(args)
    spec.held = args.hold
    spec.exclusive = args.exclusive
    spec.include_nodes.extend(
        args.nodelist.split(",") if args.nodelist else [])
    spec.exclude_nodes.extend(
        args.exclude.split(",") if args.exclude else [])
    spec.requeue_if_failed = args.requeue
    spec.deps_is_or = args.dependency_any
    spec.sim_runtime = args.sim_runtime or 0.0
    if args.ntasks:
        spec.ntasks = args.ntasks
        spec.ntasks_per_node_min = args.ntasks_per_node_min
        spec.ntasks_per_node_max = (args.ntasks_per_node_max
                                    or args.ntasks)
        spec.task_res.CopyFrom(pb.ResourceSpec(
            cpu=args.cpus_per_task,
            mem_bytes=_parse_mem(args.mem_per_task)))
    if args.array:
        spec.array.CopyFrom(_parse_array(args.array))
    if args.dependency:
        spec.dependencies.extend(_parse_dependency(args.dependency))
    client = _client(args)
    reply = client.submit(spec)
    if reply.job_id:
        print(f"Submitted batch job {reply.job_id}")
        return 0
    print(f"submit failed: {reply.error}", file=sys.stderr)
    return 1


def _build_spec(args):
    """Shared JobSpec construction for cbatch and crun."""
    from cranesched_tpu_torch.rpc import crane_pb2 as pb
    spec = pb.JobSpec(
        name=args.job_name, user=args.user,
        account=args.account, partition=args.partition,
        res=pb.ResourceSpec(cpu=args.cpu, mem_bytes=_parse_mem(args.mem),
                            memsw_bytes=_parse_mem(args.memsw or args.mem)),
        node_num=args.nodes, time_limit=args.time, qos=args.qos,
        reservation=args.reservation,
        script=getattr(args, "script", "") or "",
        output_path=getattr(args, "output", "") or "")
    if args.gres:
        for key, count in _parse_gres(args.gres).items():
            spec.res.gres[key] = count
    if getattr(args, "image", ""):
        spec.container_image = args.image
        spec.container_mounts.extend(getattr(args, "mount", []) or [])
    return spec


def cmd_calloc(args) -> int:
    """Allocate resources WITHOUT running anything (reference calloc):
    the allocation sits until `crun --jobid` steps run in it and `cfree`
    releases it (or the time limit expires)."""
    import time as _time
    spec = _build_spec(args)
    spec.alloc_only = True
    client = _client(args)
    reply = client.submit(spec)
    if not reply.job_id:
        print(f"calloc: submit failed: {reply.error}", file=sys.stderr)
        return 1
    job_id = reply.job_id
    deadline = _time.time() + args.wait
    while _time.time() < deadline:
        jobs = client.query_jobs(job_ids=[job_id]).jobs
        if jobs and jobs[0].status == "Running":
            print(f"Granted allocation {job_id} on "
                  f"{','.join(jobs[0].node_names)}")
            return 0
        if jobs and jobs[0].status not in ("Pending", "Running"):
            print(f"calloc: allocation {job_id} ended "
                  f"({jobs[0].status})", file=sys.stderr)
            return 1
        _time.sleep(args.poll)
    print(f"calloc: allocation {job_id} still pending after "
          f"{args.wait:.0f}s (it stays queued; ccancel {job_id} to "
          "drop it)", file=sys.stderr)
    return 1


def cmd_cfree(args) -> int:
    """Release a calloc allocation."""
    client = _client(args)
    reply = client.free_allocation(args.job_id)
    if reply.ok:
        print(f"Allocation {args.job_id} released")
        return 0
    print(f"cfree: {reply.error}", file=sys.stderr)
    return 1


def cmd_cstep(args) -> int:
    """List a job's steps (reference cqueue --steps)."""
    client = _client(args)
    reply = client.query_steps(args.job_id)
    rows = []
    for s in reply.steps:
        rows.append((f"{s.job_id}.{s.step_id}", s.name[:20], s.status,
                     s.exit_code,
                     ",".join(s.node_names) or "-"))
    print(_fmt_table(rows, ("STEPID", "NAME", "STATE", "EXIT",
                            "NODES")))
    return 0


def _stream_session(sess, cancel, status_poll=None) -> int:
    """Pump a StepIO session to this terminal: output chunks to
    stdout/stderr as they arrive, local stdin forwarded to the step,
    Ctrl-C -> cancel intent -> drain remaining output -> cancelled code.
    Output is structurally drained before the exit status arrives
    (reference CforedClient.h:60-63).

    ``status_poll`` (-> (terminal, exit_code) from the ctld) is the
    liveness fallback: if the job/step dies before any supervisor ever
    connects (dispatch failure, cancel while pending, node death), no
    stream will end the session — the watchdog aborts it with the
    recorded exit code instead of hanging forever."""
    import threading

    def watchdog():
        import time as _time
        grace_until = None
        while not sess.exited.wait(1.0):
            try:
                terminal, code = status_poll()
            except Exception:
                continue
            if not terminal:
                grace_until = None
                continue
            # terminal at ctld: give an in-flight exited chunk a
            # moment to land, then abort the wait
            if grace_until is None:
                grace_until = _time.monotonic() + 3.0
            elif _time.monotonic() > grace_until:
                sess.abort(code if code is not None else 1)
                return

    if status_poll is not None:
        threading.Thread(target=watchdog, daemon=True).start()

    def stdin_pump():
        try:
            while True:
                data = sys.stdin.buffer.readline()
                if not data:
                    sess.close_stdin()
                    return
                sess.send_stdin(data)
        except (OSError, ValueError):
            pass

    threading.Thread(target=stdin_pump, daemon=True).start()

    def drain():
        for name, data in sess.read():
            stream = sys.stdout if name == "out" else sys.stderr
            stream.buffer.write(data)
            stream.flush()

    try:
        drain()
    except KeyboardInterrupt:
        cancel()
        try:
            drain()
        except KeyboardInterrupt:
            pass  # second ^C: stop draining
        print("\ncrun: cancelled", file=sys.stderr)
        return sess.exit_code if sess.exit_code is not None else 130
    return sess.exit_code if sess.exit_code is not None else 1


def _run_step_in_alloc(args, client, cfored) -> int:
    """crun --jobid: an interactive STEP inside a live allocation,
    streaming over the embedded CraneFored service."""
    from cranesched_tpu_torch.rpc import crane_pb2 as pb
    # -N maps 1:1 onto the step's node span (0 = every allocation node);
    # the default -N 1 therefore means exactly one node, matching the
    # standalone crun semantics
    spec = pb.StepSpec(name=args.job_name, script=args.script,
                       node_num=args.nodes,
                       time_limit=args.time,
                       interactive_address=cfored.address,
                       interactive_token=cfored.secret,
                       pty=args.pty,
                       overlap=getattr(args, "overlap", False))
    if getattr(args, "x11", False):
        spec.x11 = True
        spec.x11_cookie = _x11_cookie()
    if getattr(args, "follow_step", None) is not None:
        spec.follow_step = args.follow_step
    if getattr(args, "image", ""):
        spec.container_image = args.image
        spec.container_mounts.extend(getattr(args, "mount", []) or [])
    if args.cpu or args.mem != "0":
        spec.res.CopyFrom(pb.ResourceSpec(
            cpu=args.cpu, mem_bytes=_parse_mem(args.mem)))
    reply = client.submit_step(args.jobid, spec)
    if reply.step_id < 0:
        print(f"crun: step rejected: {reply.error}", file=sys.stderr)
        return 1
    step_id = reply.step_id
    sess = cfored.expect(args.jobid, step_id)

    def status_poll():
        steps = [s for s in client.query_steps(args.jobid).steps
                 if s.step_id == step_id]
        if not steps:
            return True, 1
        s = steps[0]
        return s.status not in ("Pending", "Running"), s.exit_code

    return _stream_session(
        sess, cancel=lambda: client.cancel_step(args.jobid, step_id),
        status_poll=status_poll)


def cmd_ccon(args) -> int:
    """Container jobs (reference ccon, ContainerInstance): ``ccon run
    IMAGE SCRIPT`` submits a batch job whose step runs inside IMAGE on
    the node's OCI runtime, with the job's GRES/env crossing the
    boundary."""
    args.image = args.image_name
    spec = _build_spec(args)
    client = _client(args)
    reply = client.submit(spec)
    if reply.job_id:
        print(f"Submitted container job {reply.job_id} "
              f"({args.image_name})")
        return 0
    print(f"ccon: submit failed: {reply.error}", file=sys.stderr)
    return 1


def cmd_cattach(args) -> int:
    """Attach interactively to a RUNNING container step (reference
    cattach): runs ``$CRANE_CONTAINER_RUNTIME attach <name>`` as a new
    step inside the job's allocation, streaming through the embedded
    CraneFored hub — stdin/stdout reach the primary container."""
    from cranesched_tpu_torch.rpc.cfored import CforedServer
    client = _client(args)
    cfored = CforedServer()
    cfored.start(host_for_clients=args.bind_host)
    try:
        args.jobid = args.job_id
        args.script = (f'exec "$CRANE_CONTAINER_RUNTIME" attach '
                       f'crane-j{args.job_id}-s{args.step}')
        args.job_name = f"cattach-s{args.step}"
        args.nodes = 1
        args.time = 0
        args.cpu = 0.0
        args.mem = "0"
        args.pty = True
        args.overlap = True   # observation channel: holds no share
        args.image = ""       # the attach runs on the HOST runtime
        args.follow_step = args.step  # land on the container's node
        return _run_step_in_alloc(args, client, cfored)
    finally:
        cfored.stop()
        client.close()


def _x11_cookie() -> str:
    """The user's magic cookie for $DISPLAY (best effort — an open X
    server needs none)."""
    import shutil
    import subprocess as _sp
    display = os.environ.get("DISPLAY", "")
    if not display or shutil.which("xauth") is None:
        return ""
    try:
        out = _sp.run(["xauth", "list", display], capture_output=True,
                      text=True, timeout=10)
        line = out.stdout.strip().splitlines()
        return line[0] if line else ""
    except (OSError, _sp.SubprocessError):
        return ""


def cmd_crun(args) -> int:
    """Interactive run with REAL bidi streaming: the client hosts an
    embedded CraneFored service; the supervisor connects back and
    streams stdout/stderr while accepting stdin -- no shared storage
    (reference cfored protocol, Crane.proto:794-900,1679).  With
    ``--jobid`` the command becomes a STEP inside an existing calloc
    allocation (reference crun within calloc)."""
    from cranesched_tpu_torch.rpc.cfored import CforedServer
    client = _client(args)
    hub_tls = None
    if args.io_cert or args.io_key:
        if not (args.io_cert and args.io_key):
            # half a keypair must not silently downgrade to plaintext
            print("crun: --io-cert and --io-key go together",
                  file=sys.stderr)
            return 2
        base = _tls(args)
        if base is None:
            print("crun: --io-cert needs a cluster CA (--ca)",
                  file=sys.stderr)
            return 2
        import dataclasses as _dc
        hub_tls = _dc.replace(base, cert=args.io_cert, key=args.io_key,
                              override_authority="")
    cfored = CforedServer(tls=hub_tls)
    cfored.start(host_for_clients=args.bind_host)
    try:
        if args.jobid:
            return _run_step_in_alloc(args, client, cfored)
        spec = _build_spec(args)
        spec.interactive_address = cfored.address
        spec.interactive_token = cfored.secret
        spec.pty = args.pty
        if args.x11:
            spec.x11 = True
            spec.x11_cookie = _x11_cookie()
        reply = client.submit(spec)
        if not reply.job_id:
            print(f"crun: submit failed: {reply.error}",
                  file=sys.stderr)
            return 1
        job_id = reply.job_id
        sess = cfored.expect(job_id, 0)

        def status_poll():
            jobs = client.query_jobs(job_ids=[job_id],
                                     include_history=True).jobs
            if not jobs:
                return True, 1
            j = jobs[0]
            return (j.status not in ("Pending", "Running", "Suspended"),
                    j.exit_code)

        return _stream_session(sess,
                               cancel=lambda: client.cancel(job_id),
                               status_poll=status_poll)
    finally:
        cfored.stop()


def _fed_flags(p) -> None:
    """Bounded-staleness + fan-out flags shared by every read verb."""
    p.add_argument("--max-staleness", type=float, default=0.0,
                   metavar="SECONDS",
                   help="bounded-staleness read: a follower older than "
                        "this many seconds refuses and the query falls "
                        "through to the leader (0 = any replica)")
    p.add_argument("--federation", action="store_true",
                   help="fan the query out to every shard and label "
                        "rows with their shard of origin")


def _fed_connect(args):
    """Build the scatter-gather client for --federation commands, or
    None (with a diagnostic) when the cluster has no shard map."""
    from cranesched_tpu_torch.fed.query import FederatedClient
    fed = FederatedClient.connect(args.server, token=_token(args),
                                  tls=_tls(args))
    if fed is None:
        print("not a federated cluster (QueryShardMap returned no "
              "shards)", file=sys.stderr)
    return fed


def _fed_footer(res) -> None:
    """Per-shard provenance lines: which replica answered (and how
    durable its view was), and which shards failed to answer."""
    for shard, reply in res:
        seq = getattr(reply, "durable_seq", 0)
        print(f"# shard {shard}: durable_seq={seq}")
    for shard, err in sorted(res.errors.items()):
        print(f"# shard {shard}: UNAVAILABLE ({err})", file=sys.stderr)


def cmd_cqueue(args) -> int:
    from cranesched_tpu_torch.rpc.client import StreamResult
    if getattr(args, "federation", False):
        fed = _fed_connect(args)
        if fed is None:
            return 1
        res = fed.jobs(max_staleness=args.max_staleness,
                       user=args.user, partition=args.partition,
                       include_history=args.history, limit=args.limit,
                       after_job_id=args.after)
        rows = [(shard, j.job_id, j.name[:20], j.user, j.partition,
                 j.status, j.pending_reason or "-",
                 ",".join(j.node_names) or "-")
                for shard, reply in res for j in reply.jobs]
        print(_fmt_table(rows, ("SHARD", "JOBID", "NAME", "USER",
                                "PARTITION", "STATE", "REASON",
                                "NODES")))
        _fed_footer(res)
        fed.close()
        return 1 if res.errors else 0
    client = _client(args)
    rows = []
    res = StreamResult()
    # server-streaming: chunks arrive as they convert, so a 100k-job
    # queue neither builds one giant message nor stalls the cycle
    for j in client.query_jobs_stream(
            user=args.user, partition=args.partition,
            include_history=args.history, limit=args.limit,
            after_job_id=args.after, result=res,
            max_staleness=args.max_staleness):
        rows.append((j.job_id, j.name[:20], j.user, j.partition,
                     j.status, j.pending_reason or "-",
                     ",".join(j.node_names) or "-"))
    print(_fmt_table(rows, ("JOBID", "NAME", "USER", "PARTITION",
                            "STATE", "REASON", "NODES")))
    if res.truncated and rows:
        print(f"# limited to {args.limit}; continue with "
              f"--after {rows[-1][0]}")
    return 0


def _cinfo_topo(client) -> int:
    """Interconnect tree view from the QueryStats topology section."""
    import json as _json
    doc = _json.loads(client.query_stats().json)
    topo = doc.get("topology")
    if not topo:
        print("cinfo: no topology configured", file=sys.stderr)
        return 1
    levels = topo.get("levels") or []
    leaf = levels[0] if levels else {"groups": []}
    frag = leaf.get("fragmentation")
    frag_s = "-" if frag is None else f"{frag:.3f}"
    print(f"cluster  {topo.get('num_nodes')} nodes  "
          f"{topo.get('num_blocks')} blocks  frag={frag_s}")

    def _leaf_line(grp, indent):
        free = grp.get("free")
        free_s = "-" if free is None else str(free)
        print(f"{indent}├─ {grp['name']}  {grp['size']} nodes  "
              f"free={free_s}")

    if len(levels) > 1:
        for upper in levels[1]["groups"]:
            ufree = upper.get("free")
            print(f"└─ {levels[1]['name']} {upper['name']}  "
                  f"{upper['size']} nodes  "
                  f"free={'-' if ufree is None else ufree}")
            for grp in leaf["groups"]:
                if grp.get("parent") == upper["name"]:
                    _leaf_line(grp, "   ")
        orphans = [g for g in leaf["groups"] if g.get("parent") is None]
        if orphans:
            print("└─ (no switch)")
            for grp in orphans:
                _leaf_line(grp, "   ")
    else:
        for grp in leaf["groups"]:
            _leaf_line(grp, "")
    return 0


def cmd_cinfo(args) -> int:
    if getattr(args, "federation", False):
        fed = _fed_connect(args)
        if fed is None:
            return 1
        res = fed.cluster(max_staleness=args.max_staleness)
        # per-shard map epochs: a skew across the column is a live
        # migration mid-flip (the lagging shard re-learns on its next
        # stamped reply)
        epochs = fed.map_epochs()
        rows = [(shard, epochs.get(shard, "-"), n.name,
                 ",".join(n.partitions), n.state,
                 f"{n.cpu_avail:g}/{n.cpu_total:g}",
                 f"{n.mem_avail >> 30}G/{n.mem_total >> 30}G",
                 n.running_jobs)
                for shard, reply in res for n in reply.nodes]
        print(_fmt_table(rows, ("SHARD", "EPOCH", "NODE", "PARTITIONS",
                                "STATE", "CPU(A/T)", "MEM(A/T)",
                                "JOBS")))
        _fed_footer(res)
        fed.close()
        return 1 if res.errors else 0
    client = _client(args)
    if getattr(args, "topo", False):
        return _cinfo_topo(client)
    reply = client.query_cluster(max_staleness=args.max_staleness)
    rows = []
    for n in reply.nodes:
        rows.append((n.name, ",".join(n.partitions), n.state,
                     f"{n.cpu_avail:g}/{n.cpu_total:g}",
                     f"{n.mem_avail >> 30}G/{n.mem_total >> 30}G",
                     n.running_jobs))
    print(_fmt_table(rows, ("NODE", "PARTITIONS", "STATE", "CPU(A/T)",
                            "MEM(A/T)", "JOBS")))
    return 0


def cmd_cfed(args) -> int:
    """Federation admin (``cfed``): the routing map with per-shard map
    epochs, cluster-wide usage gossip, and live partition migration."""
    import json as _json
    fed = _fed_connect(args)
    if fed is None:
        return 1
    try:
        action = getattr(args, "fed_cmd", None) or "map"
        if action == "migrate":
            reply = fed.migrate(args.partition, args.dest)
            if not reply.ok:
                print(f"cfed migrate: {reply.error}", file=sys.stderr)
                return 1
            print(f"migrated {args.partition} -> {args.dest}  "
                  f"mid={reply.mid}  jobs={reply.jobs_moved}  "
                  f"map_epoch={reply.map_epoch}")
            return 0
        if action == "usage":
            res = fed.usage()
            rows = []
            for shard, reply in res:
                if not reply.ok:
                    print(f"# shard {shard}: {reply.error}",
                          file=sys.stderr)
                    continue
                doc = _json.loads(reply.payload)
                for kind, table in (("user", doc.get("user", {})),
                                    ("acct", doc.get("acct", {}))):
                    for name, c in sorted(table.items()):
                        rows.append((shard, kind, name,
                                     c.get("jobs", 0),
                                     c.get("submit_jobs", 0),
                                     reply.durable_seq))
            print(_fmt_table(rows, ("SHARD", "KIND", "NAME", "RUNNING",
                                    "SUBMITTED", "DURABLE_SEQ")))
            return 1 if res.errors else 0
        # default: the map, one row per shard, with its own epoch
        res = fed.shard_maps()
        rows = []
        for shard, reply in res:
            own = next((s for s in reply.shards if s.name == shard),
                       None)
            rows.append((shard, reply.map_epoch,
                         ",".join(own.partitions) if own else "-",
                         own.address if own else "-"))
        print(_fmt_table(rows, ("SHARD", "MAP_EPOCH", "PARTITIONS",
                                "ADDRESS")))
        for shard, err in sorted(res.errors.items()):
            print(f"# shard {shard}: UNAVAILABLE ({err})",
                  file=sys.stderr)
        return 1 if res.errors else 0
    except ValueError as exc:
        print(f"cfed: {exc}", file=sys.stderr)
        return 1
    finally:
        fed.close()


def cmd_ccancel(args) -> int:
    client = _client(args)
    rc = 0
    for job_id in args.job_ids:
        reply = client.cancel(job_id)
        if not reply.ok:
            print(f"ccancel {job_id}: {reply.error}", file=sys.stderr)
            rc = 1
    return rc


def cmd_crequeue(args) -> int:
    """Stop a running job and put it back in the queue (the reference's
    RequeueJob surface, Crane.proto:1407)."""
    client = _client(args)
    rc = 0
    for job_id in args.job_ids:
        reply = client.requeue(job_id)
        if not reply.ok:
            print(f"crequeue {job_id}: {reply.error}", file=sys.stderr)
            rc = 1
    return rc


def cmd_csummary(args) -> int:
    """Aggregated per-state job counts (the reference's
    QueryJobSummary, Crane.proto:1588) — one small reply instead of
    streaming the whole queue."""
    if getattr(args, "federation", False):
        fed = _fed_connect(args)
        if fed is None:
            return 1
        res = fed.summary(max_staleness=args.max_staleness,
                          user=args.user, partition=args.partition)
        counts: dict[str, int] = {}
        total = 0
        for _shard, reply in res:
            total += reply.total
            for s in reply.states:
                counts[s.status] = counts.get(s.status, 0) + s.count
        rows = [(st, counts[st]) for st in sorted(counts)]
        print(_fmt_table(rows, ("STATE", "COUNT")))
        print(f"# total {total} across "
              f"{len(res.replies)} shard(s)")
        _fed_footer(res)
        fed.close()
        return 1 if res.errors else 0
    client = _client(args)
    reply = client.query_job_summary(user=args.user,
                                     partition=args.partition,
                                     max_staleness=args.max_staleness)
    rows = [(s.status, s.count) for s in reply.states]
    print(_fmt_table(rows, ("STATE", "COUNT")))
    print(f"# total {reply.total}")
    return 0


def cmd_cnode(args) -> int:
    client = _client(args)
    reply = client.modify_node(args.node, args.action)
    if not reply.ok:
        print(f"cnode: {reply.error}", file=sys.stderr)
        return 1
    return 0


def _cstats_stalled(doc) -> str | None:
    """Client-side stall detection: the last completed cycle is older
    than a few cycle intervals of server wall clock (tick_mode servers
    only cycle on demand, so they never count as stalled)."""
    wd = doc.get("watchdog") or {}
    if wd.get("tick_mode") or not wd.get("last_cycle_walltime"):
        return None
    age = float(wd.get("now", 0.0)) - float(wd["last_cycle_walltime"])
    # an event-driven leader may legitimately sleep up to idle_sleep
    # between (skipped) cycles — don't call that a stall
    limit = max(3.0 * float(wd.get("cycle_interval", 1.0)),
                2.0 * float(wd.get("idle_sleep", 0.0)), 5.0)
    if age > limit:
        return (f"scheduler stalled: last completed cycle {age:.1f}s "
                f"ago (cycle interval {wd.get('cycle_interval')}s)")
    return None


def _slo_table_rows(tag: str, table) -> list:
    """One shard's (or the merged CLUSTER's) SLO table -> display rows
    under a leading SHARD column, same shape as the cqueue merge."""
    out = []
    for slo in table or ():
        for win, w in sorted(slo.get("windows", {}).items(),
                             key=lambda kv: int(kv[0])):
            out.append((
                tag, slo.get("name"),
                f"{slo.get('from')}->{slo.get('to')}",
                f"p{slo.get('p'):g}<={slo.get('target_seconds')}s",
                f"{int(win)}s", w.get("count"),
                round(float(w.get("observed", 0.0)), 4),
                w.get("burn_rate"),
                "BREACH" if w.get("breaching") else "ok"))
    return out


def cmd_cstats(args) -> int:
    import json as _json
    if getattr(args, "federation", False):
        fed = _fed_connect(args)
        if fed is None:
            return 1
        if getattr(args, "job", 0):
            # the owner shard is whichever one recorded the timeline —
            # fan the summary out and render EVERY hit: shards number
            # jobs independently, so one id can name different jobs on
            # different shards (a forwarded submit's waterfall lives on
            # the owner, not the shard the client happened to dial)
            res = fed.summary(max_staleness=args.max_staleness,
                              job_id=args.job)
            hits = 0
            for shard, reply in res:
                if reply.timeline_json:
                    from cranesched_tpu_torch.obs.jobtrace import \
                        render_waterfall
                    hits += 1
                    print(f"# shard {shard}")
                    for line in render_waterfall(
                            _json.loads(reply.timeline_json)):
                        print(line)
            fed.close()
            if not hits:
                print(f"no timeline recorded for job {args.job} on "
                      f"any shard", file=sys.stderr)
                return 1
            return 0
        res = fed.stats(max_staleness=args.max_staleness)
        shard_docs = {}
        for shard, reply in res:
            try:
                shard_docs[shard] = _json.loads(reply.json)
            except ValueError:
                res.errors[shard] = "unparseable stats reply"
        if getattr(args, "slo", False):
            # satellite fix (ISSUE 16): --federation used to dump the
            # raw per-shard JSON and silently drop --slo.  Now: each
            # shard's burn-rate rows shard-labeled like cqueue, plus
            # the exact CLUSTER merge (obs/fedobs.py) the storm drills
            # assert on.
            from cranesched_tpu_torch.obs.fedobs import merge_slo_tables
            tables = {s: d.get("slo") or [] for s, d in
                      shard_docs.items() if d.get("slo") is not None}
            if not any(tables.values()):
                print("no SLOs configured on any shard "
                      "(Observability: SLO: in the cluster YAML)",
                      file=sys.stderr)
                fed.close()
                return 1
            rows = []
            for shard in sorted(tables):
                rows.extend(_slo_table_rows(shard, tables[shard]))
            rows.extend(_slo_table_rows("CLUSTER",
                                        merge_slo_tables(tables)))
            print(_fmt_table(rows, ("SHARD", "SLO", "EDGE", "TARGET",
                                    "WINDOW", "COUNT", "OBSERVED",
                                    "BURN", "STATE")))
            _fed_footer(res)
            fed.close()
            return 1 if res.errors else 0
        prefix = getattr(args, "metrics", None)
        if prefix is not None:
            # cluster-wide scrape: counters/histograms summed across
            # shards, gauges kept per-shard under a shard= label
            from cranesched_tpu_torch.obs.fedobs import (
                merge_metric_snapshots)
            merged = merge_metric_snapshots(
                {s: d.get("metrics") or {} for s, d in
                 shard_docs.items()})
            rows = []
            for name, m in sorted(merged.items()):
                if not name.startswith(prefix):
                    continue
                for labels, v in sorted(m.get("values", {}).items()):
                    if isinstance(v, dict):
                        val = (f"count={v.get('count')} sum="
                               f"{round(float(v.get('sum', 0.0)), 6)}")
                    else:
                        val = v
                    rows.append((name + labels, m.get("type"), val))
            if not rows and prefix:
                print(f"no metric family starts with {prefix!r}",
                      file=sys.stderr)
                fed.close()
                return 1
            print(_fmt_table(rows, ("METRIC", "TYPE", "VALUE")))
            _fed_footer(res)
            fed.close()
            return 1 if res.errors else 0
        doc = dict(shard_docs)
        for shard, sub in doc.items():
            sub["_durable_seq"] = getattr(
                res.replies[shard], "durable_seq", 0)
        for shard, err in sorted(res.errors.items()):
            doc[shard] = {"_error": err}
        print(_json.dumps(doc))
        fed.close()
        return 1 if res.errors else 0
    client = _client(args)
    if getattr(args, "job", 0):
        # the timeline rides QueryJobSummary (standby-servable) — no
        # need to pull the full stats doc
        reply = client.query_job_summary(job_id=args.job)
        if not reply.timeline_json:
            print(f"no timeline recorded for job {args.job}",
                  file=sys.stderr)
            return 1
        from cranesched_tpu_torch.obs.jobtrace import render_waterfall
        for line in render_waterfall(_json.loads(reply.timeline_json)):
            print(line)
        return 0
    doc = _json.loads(client.query_stats(
        max_staleness=getattr(args, "max_staleness", 0.0)).json)
    stalled = _cstats_stalled(doc)
    if stalled:
        print(f"WARNING: {stalled}", file=sys.stderr)
    if doc.get("cycle_crashes_total"):
        crash = (doc.get("last_crash") or {})
        print(f"WARNING: {doc['cycle_crashes_total']} scheduler cycle "
              f"crash(es); last at t={crash.get('time')}",
              file=sys.stderr)
    if getattr(args, "ha", False):
        h = doc.get("ha") or {}
        rows = [("role", h.get("role", "leader")),
                ("fencing_epoch", h.get("fencing_epoch", 0)),
                ("wal_seq", h.get("wal_seq", 0)),
                ("replication_lag", h.get("replication_lag", 0)),
                ("failovers_total", h.get("failovers_total", 0)),
                ("peer", h.get("peer") or "-")]
        print(_fmt_table(rows, ("HA", "VALUE")))
        return 0
    if getattr(args, "cycles", False):
        rows = [(t.get("now"), t.get("solver"),
                 # MESH: solve span as procs x local devices ("1x8" =
                 # single process over 8 chips); "-" for host solvers
                 t.get("mesh", "-"),
                 t.get("queue_depth"),
                 t.get("candidates"), t.get("placed"),
                 t.get("backfilled"), t.get("preempted"),
                 # SKIP: coalesced short-circuit count (+ reason);
                 # DIRTY: jobs/nodes patched since the last cycle
                 (f"{t.get('skips')}:{t.get('skip_reason')}"
                  if t.get("skips") else "-"),
                 (f"{t.get('dirty_jobs')}/{t.get('dirty_nodes')}"
                  if t.get("dirty_jobs") is not None else "-"),
                 t.get("prelude_ms"), t.get("solve_ms"),
                 t.get("commit_ms"), t.get("dispatch_ms"),
                 t.get("lock_held_ms"), t.get("total_ms"),
                 t.get("wal_fsyncs"), t.get("topo_frag", "-"))
                for t in doc.get("cycle_trace", [])]
        print(_fmt_table(rows, (
            "NOW", "SOLVER", "MESH", "QUEUE", "CAND", "PLACED",
            "BACKFILL", "PREEMPT", "SKIP", "DIRTY", "PRELUDE_MS",
            "SOLVE_MS", "COMMIT_MS", "DISPATCH_MS", "LOCK_MS",
            "TOTAL_MS", "FSYNC", "FRAG")))
        return 0
    if getattr(args, "spans", False):
        # the newest cycle's span tree: where its time went, phase by
        # phase, and what no phase names (the root's self time)
        rows = [t for t in doc.get("cycle_trace") or () if t.get("spans")]
        if not rows:
            print("no cycle spans recorded", file=sys.stderr)
            return 1
        from cranesched_tpu_torch.obs.trace import render_span_tree
        for line in render_span_tree(rows[-1]):
            print(line)
        return 0
    if getattr(args, "slo", False):
        rows = []
        for slo in doc.get("slo") or ():
            for win, w in sorted(slo.get("windows", {}).items(),
                                 key=lambda kv: int(kv[0])):
                rows.append((
                    slo.get("name"),
                    f"{slo.get('from')}->{slo.get('to')}",
                    f"p{slo.get('p'):g}<={slo.get('target_seconds')}s",
                    f"{int(win)}s", w.get("count"),
                    round(float(w.get("observed", 0.0)), 4),
                    w.get("burn_rate"),
                    "BREACH" if w.get("breaching") else "ok"))
        if not rows:
            print("no SLOs configured (Observability: SLO: in the "
                  "cluster YAML)", file=sys.stderr)
            return 1
        print(_fmt_table(rows, ("SLO", "EDGE", "TARGET", "WINDOW",
                                "COUNT", "OBSERVED", "BURN", "STATE")))
        return 0
    prefix = getattr(args, "metrics", None)
    if prefix is not None:
        rows = []
        for name, m in sorted((doc.get("metrics") or {}).items()):
            if not name.startswith(prefix):
                continue
            for labels, v in sorted(m.get("values", {}).items()):
                if isinstance(v, dict):   # histogram series
                    val = (f"count={v.get('count')} "
                           f"sum={round(float(v.get('sum', 0.0)), 6)}")
                else:
                    val = v
                rows.append((name + labels, m.get("type"), val))
        if not rows and prefix:
            print(f"no metric family starts with {prefix!r}",
                  file=sys.stderr)
            return 1
        print(_fmt_table(rows, ("METRIC", "TYPE", "VALUE")))
        return 0
    print(_json.dumps(doc))
    return 0


def cmd_cevents(args) -> int:
    """Structured cluster-event ring (standby-servable): node flaps,
    fencing rejections, watchdog crashes, failovers, SLO breaches,
    preemptions, requeues, steady-state recompiles."""
    if getattr(args, "federation", False):
        fed = _fed_connect(args)
        if fed is None:
            return 1
        res = fed.events(severity=args.severity, since=args.since,
                         after_seq=args.after, limit=args.limit,
                         type=args.type,
                         max_staleness=args.max_staleness)
        rows = []
        for shard, reply in res:
            rows.extend(
                (f"{e.time:.3f}", shard, e.seq, e.severity.upper(),
                 e.type, e.node or "-", e.job_id or "-",
                 e.detail or "-")
                for e in reply.events)
        rows.sort(key=lambda r: float(r[0]))
        if rows:
            print(_fmt_table(rows, ("TIME", "SHARD", "SEQ", "SEV",
                                    "TYPE", "NODE", "JOB", "DETAIL")))
        else:
            print("no matching events", file=sys.stderr)
        _fed_footer(res)
        fed.close()
        return 1 if (res.errors or not rows) else 0
    client = _client(args)
    reply = client.query_events(severity=args.severity,
                                since=args.since,
                                after_seq=args.after,
                                limit=args.limit,
                                type=args.type,
                                max_staleness=args.max_staleness)
    if not reply.events:
        print("no matching events", file=sys.stderr)
        return 1
    rows = [(e.seq, f"{e.time:.3f}", e.severity.upper(), e.type,
             e.node or "-", e.job_id or "-", e.detail or "-")
            for e in reply.events]
    print(_fmt_table(rows, ("SEQ", "TIME", "SEV", "TYPE", "NODE",
                            "JOB", "DETAIL")))
    return 0


def cmd_cexplain(args) -> int:
    """Why is this job not running?  First-failing-gate decomposition
    of the scheduler's feasibility pipeline for one pending job."""
    import json as _json
    client = _client(args)
    reply = client.query_job_summary(job_id=args.job_id)
    if not reply.explain_json:
        print(f"no explanation for job {args.job_id}", file=sys.stderr)
        return 1
    doc = _json.loads(reply.explain_json)
    if args.json:
        print(_json.dumps(doc, indent=2))
        return 0
    head = f"job {doc['job_id']}"
    if doc.get("state"):
        head += f" [{doc['state']}]"
    if doc.get("reason"):
        head += f" pending_reason={doc['reason']}"
    print(head)
    print(f"  blocked at: {doc.get('gate') or '-'}"
          + (f" — {doc['detail']}" if doc.get("detail") else ""))
    checks = doc.get("checks") or ()
    if checks:
        rows = [("PASS" if c["ok"] else ">>>", c["gate"],
                 c.get("detail") or "-") for c in checks]
        print(_fmt_table(rows, ("", "GATE", "DETAIL")))
    return 0


def cmd_cprofile(args) -> int:
    """Arm an on-demand torch.profiler capture spanning the next N
    scheduling cycles; the trace lands under profiles/ on the leader."""
    client = _client(args)
    reply = client.capture_profile(cycles=args.cycles, dir=args.dir)
    if not reply.ok:
        print(f"cprofile: {reply.error}", file=sys.stderr)
        return 1
    print(f"profiling armed for {args.cycles} cycle(s) -> {reply.dir}")
    return 0


def _render_flight(fl: dict, tail: int = 32) -> list[str]:
    """Flight-recorder report -> display lines: recent phase timeline,
    then the last stall's ring tail + all-thread stacks."""
    out = []
    phases = (fl.get("phases") or [])[-tail:]
    if phases:
        t0 = phases[0].get("t", 0.0)
        rows = [(f"{p.get('t', 0.0) - t0:+9.3f}s", p.get("phase"),
                 p.get("detail") or "-") for p in phases]
        out.append(_fmt_table(rows, ("T", "PHASE", "DETAIL")))
    else:
        out.append("(no phase stamps recorded)")
    out.append(f"# stalls_total={fl.get('stalls_total', 0)} "
               f"armed={fl.get('armed', False)} "
               f"self_time_s={fl.get('self_time_s', 0.0)}")
    stall = fl.get("last_stall")
    if stall:
        out.append(f"LAST STALL label={stall.get('label')!r} "
                   f"t={stall.get('time')}")
        for p in stall.get("phases") or ():
            out.append(f"  phase {p.get('phase')} t={p.get('t')} "
                       f"{p.get('detail', '')}")
        for thread, frames in sorted(
                (stall.get("stacks") or {}).items()):
            out.append(f"  -- thread {thread}")
            for frame in frames:
                for ln in frame.splitlines():
                    out.append("    " + ln)
    return out


def cmd_cflight(args) -> int:
    """Stall forensics viewer: the flight recorder's recent cycle-phase
    timeline plus the last stall's all-thread stack capture — from a
    live ctld, every shard of a federation, or a BENCH_*.json probe
    diagnosis (``--file``)."""
    import json as _json
    if getattr(args, "file", ""):
        with open(args.file, encoding="utf-8") as fh:
            doc = _json.load(fh)
        # accept the probe dict itself, a bench.py output doc, or the
        # committed BENCH_rNN.json wrapper ({"parsed": <bench doc>})
        acq = doc if isinstance(doc, dict) else {}
        for path in (("device_acquisition",),
                     ("detail", "device_acquisition"),
                     ("parsed", "detail", "device_acquisition")):
            node = doc
            for key in path:
                node = node.get(key) if isinstance(node, dict) else None
            if node:
                acq = node
                break
        phases = acq.get("phases") or []
        print(f"probe acquired={acq.get('acquired', '?')} "
              f"phases={'->'.join(str(p) for p in phases) or '(none)'}")
        # the handshake's heartbeat stamps: where the wall-clock went
        # inside acquisition (the gap after the LAST stamp is the
        # wedged phase on a timeout)
        stamps = acq.get("phase_stamps") or []
        if stamps:
            t0 = float(stamps[0].get("t") or 0.0)
            for s in stamps:
                print(f"  stamp {str(s.get('phase')):<14} "
                      f"+{float(s.get('t') or 0.0) - t0:.3f}s")
        if acq.get("diagnosis"):
            print(f"diagnosis: {acq['diagnosis']}")
        if acq.get("stacks"):
            print("-- harvested probe stacks --")
            print(acq["stacks"])
        return 0 if acq.get("acquired") else 1
    if getattr(args, "federation", False):
        fed = _fed_connect(args)
        if fed is None:
            return 1
        res = fed.stats(max_staleness=args.max_staleness)
        rc = 1 if res.errors else 0
        for shard, reply in res:
            try:
                fl = _json.loads(reply.json).get("flight") or {}
            except ValueError:
                res.errors[shard] = "unparseable stats reply"
                rc = 1
                continue
            print(f"== shard {shard} ==")
            for line in _render_flight(fl, tail=args.tail):
                print(line)
            if fl.get("last_stall"):
                rc = max(rc, 2)
        _fed_footer(res)
        fed.close()
        return rc
    client = _client(args)
    doc = _json.loads(client.query_stats(
        max_staleness=getattr(args, "max_staleness", 0.0)).json)
    fl = doc.get("flight") or {}
    for line in _render_flight(fl, tail=args.tail):
        print(line)
    # a recorded stall is the signal the operator came for: nonzero
    # exit so drills can assert "no stalls" without parsing the text
    return 2 if fl.get("last_stall") else 0


def cmd_ccontrol(args) -> int:
    client = _client(args)
    if args.action in ("hold", "release"):
        reply = client.hold(args.job_id, held=args.action == "hold")
    elif args.action == "suspend":
        reply = client.suspend(args.job_id)
    elif args.action == "resume":
        reply = client.resume(args.job_id)
    elif args.action == "modify":
        # ccontrol modify JOBID time_limit=7200 priority=50
        # partition=gpu  (reference ModifyJob / ccontrol update)
        kw = {}
        for kv in args.fields:
            key, sep, value = kv.partition("=")
            if not sep or key not in ("time_limit", "priority",
                                      "partition"):
                print(f"ccontrol: bad field {kv!r} (use time_limit=, "
                      "priority=, partition=)", file=sys.stderr)
                return 2
            try:
                kw[key] = (value if key == "partition"
                           else float(value) if key == "time_limit"
                           else int(value))
            except ValueError:
                print(f"ccontrol: bad value in {kv!r} "
                      f"({key} must be a number)", file=sys.stderr)
                return 2
        if not kw:
            print("ccontrol: modify needs at least one key=value",
                  file=sys.stderr)
            return 2
        reply = client.modify_job(args.job_id, **kw)
    else:
        print(f"unknown action {args.action}", file=sys.stderr)
        return 2
    if not reply.ok:
        print(f"ccontrol: {reply.error}", file=sys.stderr)
        return 1
    return 0


def cmd_cacct(args) -> int:
    from cranesched_tpu_torch.rpc.client import StreamResult
    client = _client(args)
    rows = []
    res = StreamResult()
    last_id = 0
    for j in client.query_jobs_stream(user=args.user,
                                      include_history=True,
                                      limit=args.limit,
                                      after_job_id=args.after,
                                      result=res):
        # the cursor advances over EVERY streamed id — the live-job
        # filter below must not hide pages (a limit full of running
        # jobs would otherwise read as "no history")
        last_id = j.job_id
        if j.status in ("Pending", "Running", "Suspended"):
            continue
        wall = (j.end_time - j.start_time
                if j.end_time and j.start_time else 0.0)
        rows.append((j.job_id, j.name[:20], j.user, j.status,
                     j.exit_code, f"{wall:.0f}s"))
    print(_fmt_table(rows, ("JOBID", "NAME", "USER", "STATE",
                            "EXIT", "WALL")))
    if res.truncated and last_id:
        print(f"# limited to {args.limit}; continue with "
              f"--after {last_id}")
    return 0


def cmd_ceff(args) -> int:
    """Job efficiency report (reference ceff via
    PluginQueryService::QueryJobEfficiency, Crane.proto:1615-1617):
    allocated vs consumed CPU and memory from the per-step usage
    samples the supervisors reported."""
    client = _client(args)
    jobs = client.query_jobs(job_ids=[args.job_id],
                             include_history=True).jobs
    if not jobs:
        print(f"ceff: no such job {args.job_id}", file=sys.stderr)
        return 1
    j = jobs[0]
    wall = (j.end_time - j.start_time
            if j.end_time and j.start_time else 0.0)
    steps = client.query_steps(args.job_id).steps
    print(f"Job {j.job_id} ({j.name}) user={j.user} state={j.status}")
    print(f"  nodes: {','.join(j.node_names) or '-'}")
    print(f"  wall time: {wall:.1f}s")
    print(f"  cpu used: {j.cpu_seconds:.1f} core-seconds")
    # allocated core-seconds: per-node cpu share x nodes x wall
    # (cpu_total from the cluster query is not needed — the job info
    # itself doesn't carry the request, so derive from usage when
    # possible and report what is known)
    if wall > 0 and j.cpu_seconds > 0:
        n_nodes = max(len(j.node_names), 1)
        print(f"  cpu efficiency: "
              f"{100.0 * j.cpu_seconds / (wall * n_nodes):.1f}% "
              f"(vs {n_nodes} node-cores-seconds; multiply by the "
              f"per-node core count for absolute efficiency)")
    if j.max_rss_bytes:
        print(f"  peak RSS: {j.max_rss_bytes / (1 << 20):.1f} MiB")
    for s in steps:
        if s.cpu_seconds or s.max_rss_bytes:
            print(f"  step {s.step_id}: cpu={s.cpu_seconds:.1f}s "
                  f"rss={s.max_rss_bytes / (1 << 20):.1f}MiB "
                  f"({s.status})")
    return 0


def cmd_cacctmgr(args) -> int:
    import json as _json
    client = _client(args)
    payload = {}
    for kv in args.set or []:
        key, _, value = kv.partition("=")
        if not _:
            print(f"cacctmgr: bad --set {kv!r} (use key=value)",
                  file=sys.stderr)
            return 2
        try:
            payload[key] = _json.loads(value)
        except _json.JSONDecodeError:
            payload[key] = value
    if args.name:
        payload.setdefault("name", args.name)
    reply = client.acct_mgr(args.actor, args.action, payload)
    if not reply.ok:
        print(f"cacctmgr: {reply.error}", file=sys.stderr)
        return 1
    if reply.json:
        print(_json.dumps(_json.loads(reply.json), indent=2))
    return 0


def cmd_cresv(args) -> int:
    client = _client(args)
    if args.action == "create":
        if not args.nodelist:
            print("cresv create: --nodelist is required",
                  file=sys.stderr)
            return 2
        if args.end <= args.start:
            print("cresv create: --end must be after --start",
                  file=sys.stderr)
            return 2
        reply = client.create_reservation(
            args.resv_name, args.partition, args.nodelist.split(","),
            args.start, args.end,
            allowed_accounts=(args.accounts.split(",")
                              if args.accounts else ()))
    else:
        reply = client.delete_reservation(args.resv_name)
    if not reply.ok:
        print(f"cresv: {reply.error}", file=sys.stderr)
        return 1
    return 0


def cmd_cpki(args) -> int:
    """Cluster PKI admin (the VaultClient role, VaultClient.h:39):
    ``cpki init`` creates the cluster CA; ``cpki issue NAME`` signs an
    endpoint cert with SANs for its hostnames/IPs."""
    from cranesched_tpu_torch.utils import pki
    if args.action == "init":
        ca, key = pki.create_ca(args.dir)
        print(f"cluster CA created: {ca}\nCA key (keep private): {key}")
        print("distribute ca.pem to clients (~/.crane/ca.pem) and "
              "craneds (--tls-ca)")
        return 0
    if not args.name:
        print("cpki issue requires a NAME", file=sys.stderr)
        return 2
    ca = os.path.join(args.dir, "ca.pem")
    ca_key = os.path.join(args.dir, "ca.key")
    if not (os.path.exists(ca_key) and os.path.exists(ca)):
        print(f"no CA at {args.dir} (run cpki init first)",
              file=sys.stderr)
        return 2
    dns = tuple(d for d in args.dns.split(",") if d)
    ips = tuple(i for i in args.ip.split(",") if i)
    cert, key = pki.issue_cert(args.dir, args.name, ca, ca_key,
                               dns=dns, ips=ips)
    print(f"issued: {cert}\nkey: {key}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(prog="crane")
    top.add_argument("--server",
                     default=os.environ.get("CRANE_SERVER",
                                            "127.0.0.1:50051"),
                     help="ctld address, or a comma-separated HA pair "
                          "(the client follows the leader)")
    top.add_argument("--token", default="",
                     help="bearer token (default: $CRANE_TOKEN or "
                          "~/.crane/token)")
    top.add_argument("--ca", default="",
                     help="cluster CA cert for TLS (default: $CRANE_CA "
                          "or ~/.crane/ca.pem if present)")
    top.add_argument("--cert", default="",
                     help="client cert for mTLS clusters (default: "
                          "$CRANE_CERT or ~/.crane/cert.pem)")
    top.add_argument("--key", default="",
                     help="client key for mTLS clusters (default: "
                          "$CRANE_KEY or ~/.crane/key.pem)")
    sub = top.add_subparsers(dest="command", required=True)

    p = sub.add_parser("cbatch", help="submit a batch job")
    p.add_argument("--job-name", "-J", default="job")
    p.add_argument("--user", default=os.environ.get("USER", "user"))
    p.add_argument("--account", "-A", default="default")
    p.add_argument("--partition", "-p", default="default")
    p.add_argument("--cpu", "-c", type=float, default=1.0)
    p.add_argument("--mem", default="0")
    p.add_argument("--memsw", default="")
    p.add_argument("--nodes", "-N", type=int, default=1)
    p.add_argument("--gres", default="",
                   help="name[:type]:count, comma-separated")
    p.add_argument("--time", "-t", type=int, default=3600)
    p.add_argument("--qos", "-q", default="")
    p.add_argument("--hold", action="store_true")
    p.add_argument("--exclusive", action="store_true")
    p.add_argument("--reservation", default="")
    p.add_argument("--nodelist", "-w", default="")
    p.add_argument("--exclude", "-x", default="")
    p.add_argument("--requeue", action="store_true")
    p.add_argument("--array", "-a", default="")
    p.add_argument("--dependency", "-d", default="")
    p.add_argument("--dependency-any", action="store_true")
    p.add_argument("--ntasks", "-n", type=int, default=0)
    p.add_argument("--ntasks-per-node-min", type=int, default=1)
    p.add_argument("--ntasks-per-node-max", type=int, default=0)
    p.add_argument("--cpus-per-task", type=float, default=1.0)
    p.add_argument("--mem-per-task", default="0")
    p.add_argument("--sim-runtime", type=float, default=0.0)
    p.add_argument("--script", default="",
                   help="batch script (bash -c) for real node planes")
    p.add_argument("--output", "-o", default="",
                   help="output file pattern (%%j = job id)")
    p.add_argument("--image", default="",
                   help="run the batch step inside this OCI image")
    p.add_argument("--mount", action="append", default=[],
                   help="host:ctr[:ro] bind for --image (repeatable)")
    p.set_defaults(func=cmd_cbatch)

    p = sub.add_parser("crun", help="run a command and stream output")
    p.add_argument("script", help="command to run (bash -c)")
    p.add_argument("--job-name", "-J", default="crun")
    p.add_argument("--user", default=os.environ.get("USER", "user"))
    p.add_argument("--account", "-A", default="default")
    p.add_argument("--partition", "-p", default="default")
    p.add_argument("--cpu", "-c", type=float, default=1.0)
    p.add_argument("--mem", default="0")
    p.add_argument("--memsw", default="")
    p.add_argument("--nodes", "-N", type=int, default=1)
    p.add_argument("--gres", default="")
    p.add_argument("--time", "-t", type=int, default=3600)
    p.add_argument("--qos", "-q", default="")
    p.add_argument("--reservation", default="")
    p.add_argument("--jobid", type=int, default=0,
                   help="run as a STEP inside this calloc allocation")
    p.add_argument("--pty", action="store_true",
                   help="run the command on a pseudo-terminal")
    p.add_argument("--bind-host", default="127.0.0.1",
                   help="address craneds use to reach this client's "
                        "I/O stream (set to a routable IP/hostname on "
                        "multi-host clusters)")
    p.add_argument("--io-cert", default="",
                   help="serve the I/O stream over TLS with this cert "
                        "(issue one with cpki issue <user>; on "
                        "multi-host clusters issue it with "
                        "--ip <bind-host> so supervisors can verify "
                        "the advertised address)")
    p.add_argument("--io-key", default="",
                   help="key for --io-cert")
    p.add_argument("--image", default="",
                   help="run the command inside this OCI image "
                        "(node's podman/docker)")
    p.add_argument("--mount", action="append", default=[],
                   help="host:ctr[:ro] bind for --image (repeatable)")
    p.add_argument("--overlap", action="store_true",
                   help="hold no share of the allocation "
                        "(observation steps)")
    p.add_argument("--x11", action="store_true",
                   help="forward X11: the step gets a DISPLAY relayed "
                        "to this client's X server")
    p.set_defaults(func=cmd_crun)

    p = sub.add_parser("ccon", help="container jobs (ccon run IMAGE "
                                    "SCRIPT)")
    ccon_sub = p.add_subparsers(dest="ccon_action", required=True)
    pr = ccon_sub.add_parser("run", help="submit a container batch job")
    pr.add_argument("image_name", metavar="IMAGE")
    pr.add_argument("script", help="command run inside the container "
                                   "(bash -c)")
    pr.add_argument("--job-name", "-J", default="ccon")
    pr.add_argument("--user", default=os.environ.get("USER", "user"))
    pr.add_argument("--account", "-A", default="default")
    pr.add_argument("--partition", "-p", default="default")
    pr.add_argument("--cpu", "-c", type=float, default=1.0)
    pr.add_argument("--mem", default="0")
    pr.add_argument("--memsw", default="")
    pr.add_argument("--nodes", "-N", type=int, default=1)
    pr.add_argument("--gres", default="")
    pr.add_argument("--time", "-t", type=int, default=3600)
    pr.add_argument("--qos", "-q", default="")
    pr.add_argument("--reservation", default="")
    pr.add_argument("--mount", action="append", default=[],
                    help="host:ctr[:ro] bind mount (repeatable)")
    pr.add_argument("--output", "-o", default="",
                    help="output file pattern (%%j = job id)")
    pr.set_defaults(func=cmd_ccon)

    p = sub.add_parser("cattach",
                       help="attach to a running container step")
    p.add_argument("job_id", type=int)
    p.add_argument("--step", type=int, default=0,
                   help="step whose container to attach (default 0)")
    p.add_argument("--bind-host", default="127.0.0.1")
    p.set_defaults(func=cmd_cattach)

    p = sub.add_parser("calloc",
                       help="allocate resources (steps run via "
                            "crun --jobid; release with cfree)")
    p.add_argument("--job-name", "-J", default="calloc")
    p.add_argument("--user", default=os.environ.get("USER", "user"))
    p.add_argument("--account", "-A", default="default")
    p.add_argument("--partition", "-p", default="default")
    p.add_argument("--cpu", "-c", type=float, default=1.0)
    p.add_argument("--mem", default="0")
    p.add_argument("--memsw", default="")
    p.add_argument("--nodes", "-N", type=int, default=1)
    p.add_argument("--gres", default="")
    p.add_argument("--time", "-t", type=int, default=3600)
    p.add_argument("--qos", "-q", default="")
    p.add_argument("--reservation", default="")
    p.add_argument("--wait", type=float, default=30.0,
                   help="seconds to wait for the allocation to start")
    p.add_argument("--poll", type=float, default=0.3)
    p.set_defaults(func=cmd_calloc)

    p = sub.add_parser("cfree", help="release a calloc allocation")
    p.add_argument("job_id", type=int)
    p.set_defaults(func=cmd_cfree)

    p = sub.add_parser("ctoken",
                       help="issue/revoke user tokens (admin)")
    p.add_argument("user")
    p.add_argument("--revoke", action="store_true")
    p.add_argument("--save", action="store_true",
                   help="write the issued token to ~/.crane/token.<user>")
    p.set_defaults(func=cmd_ctoken)

    p = sub.add_parser("cstep", help="list a job's steps")
    p.add_argument("job_id", type=int)
    p.set_defaults(func=cmd_cstep)

    p = sub.add_parser("cqueue", help="show the job queue")
    p.add_argument("--user", "-u", default="")
    p.add_argument("--partition", "-p", default="")
    p.add_argument("--history", action="store_true")
    p.add_argument("--limit", "-L", type=int, default=0,
                   help="page size (0 = everything)")
    p.add_argument("--after", type=int, default=0,
                   help="resume after this job id (keyset cursor)")
    _fed_flags(p)
    p.set_defaults(func=cmd_cqueue)

    p = sub.add_parser("cinfo", help="show cluster nodes")
    p.add_argument("--topo", action="store_true",
                   help="render the interconnect topology tree "
                        "(blocks/switches, free nodes, fragmentation)")
    _fed_flags(p)
    p.set_defaults(func=cmd_cinfo)

    p = sub.add_parser("cfed",
                       help="federation admin: shard map + map epochs, "
                            "usage gossip, live partition migration")
    fed_sub = p.add_subparsers(dest="fed_cmd")
    pm = fed_sub.add_parser("map", help="routing table with per-shard "
                                        "map epochs (the default)")
    pm.set_defaults(func=cmd_cfed)
    pu = fed_sub.add_parser("usage",
                            help="cluster-wide usage gossip summaries")
    pu.set_defaults(func=cmd_cfed)
    pg = fed_sub.add_parser(
        "migrate",
        help="live-migrate a partition to another shard (drains, "
             "hands off pending+running jobs, flips the map epoch)")
    pg.add_argument("partition")
    pg.add_argument("dest")
    pg.set_defaults(func=cmd_cfed)
    p.set_defaults(func=cmd_cfed)

    p = sub.add_parser("ccancel", help="cancel jobs")
    p.add_argument("job_ids", nargs="+", type=int)
    p.set_defaults(func=cmd_ccancel)

    p = sub.add_parser("ccontrol",
                       help="hold/release/suspend/resume/modify")
    p.add_argument("action",
                   choices=["hold", "release", "suspend", "resume",
                            "modify"])
    p.add_argument("job_id", type=int)
    p.add_argument("fields", nargs="*", metavar="key=value",
                   help="modify only: time_limit=SECONDS "
                        "priority=N partition=NAME")
    p.set_defaults(func=cmd_ccontrol)

    p = sub.add_parser("cacct", help="show accounting history")
    p.add_argument("--user", "-u", default="")
    p.add_argument("--limit", "-L", type=int, default=0,
                   help="page size (0 = everything)")
    p.add_argument("--after", type=int, default=0,
                   help="resume after this job id (keyset cursor)")
    p.set_defaults(func=cmd_cacct)

    p = sub.add_parser("ceff", help="job efficiency (cpu/memory)")
    p.add_argument("job_id", type=int)
    p.set_defaults(func=cmd_ceff)

    p = sub.add_parser("cnode", help="node control (drain/resume/...)")
    p.add_argument("action",
                   choices=["drain", "resume", "poweroff", "wake"])
    p.add_argument("node")
    p.set_defaults(func=cmd_cnode)

    p = sub.add_parser("cstats", help="scheduler cycle statistics")
    p.add_argument("--cycles", action="store_true",
                   help="print the last-N cycle trace ring as a table")
    p.add_argument("--spans", action="store_true",
                   help="print the newest cycle's span tree: each span's "
                        "start, duration and self time in ms")
    p.add_argument("--metrics", nargs="?", const="", default=None,
                   metavar="PREFIX",
                   help="print the metric registry snapshot as a table; "
                        "optional PREFIX keeps only metric families "
                        "whose name starts with it")
    p.add_argument("--ha", action="store_true",
                   help="print HA role / fencing epoch / replication "
                        "lag as a table")
    p.add_argument("--job", type=int, default=0, metavar="JOB_ID",
                   help="print the job's lifecycle timeline as an "
                        "ASCII waterfall (per-job tracing)")
    p.add_argument("--slo", action="store_true",
                   help="print the live SLO table (per-window "
                        "percentile + burn rate)")
    _fed_flags(p)
    p.set_defaults(func=cmd_cstats)

    p = sub.add_parser("cevents",
                       help="structured cluster events (flaps, fencing, "
                            "breaches, ...)")
    p.add_argument("--severity", "-s", default="",
                   choices=["", "debug", "info", "warning", "error",
                            "critical"],
                   help="minimum severity to show")
    p.add_argument("--since", type=float, default=0.0,
                   help="only events at/after this epoch time")
    p.add_argument("--after", type=int, default=0, metavar="SEQ",
                   help="only events with seq > SEQ (cursor)")
    p.add_argument("--type", "-t", default="",
                   help="exact event type (e.g. node_flap, slo_breach)")
    p.add_argument("--limit", "-L", type=int, default=0,
                   help="newest N matches (0 = all)")
    _fed_flags(p)
    p.set_defaults(func=cmd_cevents)

    p = sub.add_parser("cexplain",
                       help="why is this job pending? first failing "
                            "feasibility gate")
    p.add_argument("job_id", type=int)
    p.add_argument("--json", action="store_true",
                   help="print the raw decomposition document")
    p.set_defaults(func=cmd_cexplain)

    p = sub.add_parser("cprofile",
                       help="capture a torch.profiler trace of the next "
                            "N scheduling cycles")
    p.add_argument("--cycles", "-n", type=int, default=3)
    p.add_argument("--dir", default="",
                   help="output directory (default profiles/capture-*)")
    p.set_defaults(func=cmd_cprofile)

    p = sub.add_parser("cflight",
                       help="stall forensics: recent cycle-phase "
                            "timeline + the last stall's thread stacks")
    p.add_argument("--tail", type=int, default=32, metavar="N",
                   help="phase stamps to show (newest N)")
    p.add_argument("--file", default="", metavar="PATH",
                   help="render a BENCH_*.json probe diagnosis instead "
                        "of querying a server")
    _fed_flags(p)
    p.set_defaults(func=cmd_cflight)

    p = sub.add_parser("crequeue",
                       help="stop running jobs and requeue them")
    p.add_argument("job_ids", nargs="+", type=int)
    p.set_defaults(func=cmd_crequeue)

    p = sub.add_parser("csummary",
                       help="per-state job counts (cheap aggregate)")
    p.add_argument("--user", "-u", default="")
    p.add_argument("--partition", "-p", default="")
    _fed_flags(p)
    p.set_defaults(func=cmd_csummary)

    p = sub.add_parser("cacctmgr", help="accounts/users/QoS admin")
    p.add_argument("action",
                   choices=["add_qos", "add_account", "add_user",
                            "block_user", "block_account",
                            "set_admin_level", "show"])
    p.add_argument("name", nargs="?", default="")
    p.add_argument("--actor", default=os.environ.get("USER", "root"))
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="payload fields (JSON values accepted)")
    p.set_defaults(func=cmd_cacctmgr)

    p = sub.add_parser("cpki",
                       help="cluster PKI: init the CA / issue certs")
    p.add_argument("action", choices=["init", "issue"])
    p.add_argument("name", nargs="?", default="",
                   help="endpoint name for issue (e.g. ctld, cn01)")
    p.add_argument("--dir", default=os.path.expanduser("~/.crane/pki"),
                   help="PKI directory (CA + issued certs)")
    p.add_argument("--dns", default="",
                   help="extra DNS SANs, comma-separated")
    p.add_argument("--ip", default="",
                   help="extra IP SANs, comma-separated")
    p.set_defaults(func=cmd_cpki)

    p = sub.add_parser("cresv", help="manage reservations")
    p.add_argument("action", choices=["create", "delete"])
    p.add_argument("resv_name")
    p.add_argument("--partition", "-p", default="default")
    p.add_argument("--nodelist", "-w", default="")
    p.add_argument("--start", type=float, default=0.0)
    p.add_argument("--end", type=float, default=0.0)
    p.add_argument("--accounts", default="")
    p.set_defaults(func=cmd_cresv)

    return top


def main(argv=None) -> int:
    import grpc
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except grpc.RpcError as exc:
        code = exc.code().name if hasattr(exc, "code") else "RPC_ERROR"
        print(f"crane: cannot reach ctld at {args.server} ({code})",
              file=sys.stderr)
        return 3


if __name__ == "__main__":
    sys.exit(main())
