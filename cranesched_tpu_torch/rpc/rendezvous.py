"""Gang rendezvous service: fences + key-value modex (port of
``cranesched_tpu/rpc/rendezvous.py``).

The PMIx-server role (reference: src/Utilities/Pmix/Pmix.h:44 —
embedded PMIx server per supervisor; ring/tree fence collectives
PmixCollRing.h:53 / ReverseTree.cpp; direct modex PmixDModex.{h,cpp}),
redesigned as a single per-gang coordinator: the rank-0 supervisor of
a multi-node step hosts this service, every member (rank 0 included)
reaches it at ``CRANE_RENDEZVOUS``.  One coordinator instead of a
ring/tree server mesh is the torchrun bootstrap model — the heavy
collectives ride the interconnect under the framework (NCCL); the
host side only needs wire-up, barriers, and small KV exchange.

Capabilities:

* ``Fence`` — a named barrier over ``nranks`` participants with
  optional data contribution; releases everyone with the rank-ordered
  contributions (PMIx fence with data collection).  Re-usable: each
  completion opens a new epoch of the same name.
* ``Put``/``Get`` — the modex: publish once, read from any rank,
  blocking reads with timeout (direct-modex semantics).

A per-gang bearer token (``CRANE_RENDEZVOUS_TOKEN``) gates every call:
anyone who can reach the port could otherwise skew a barrier or
poison the modex.

Epochs: the coordinator carries an incarnation number.  A
member still retrying against a restarted coordinator — or lagging a
step behind the rest of the gang after a partial failure — gets a
typed ``stale epoch`` rejection instead of silently contributing to
the wrong barrier round (the rank-skew corruption mode: rank A's step
N+1 contribution satisfying rank B's step N fence).  Fence state is
keyed per ``(fence_id, epoch)``; epoch 0 means "no check" for
pre-epoch clients.
"""

from __future__ import annotations

import threading
from concurrent import futures

import grpc

from cranesched_tpu_torch.rpc import crane_pb2 as pb

RDZV_SERVICE = "cranesched.CraneRendezvous"


class _FenceState:
    def __init__(self, nranks: int):
        self.nranks = nranks
        self.data: dict[int, bytes] = {}
        self.done = threading.Event()
        self.error = ""


class RendezvousServer:
    """Hosts CraneRendezvous (in the rank-0 supervisor).

    ``nranks`` sizes the worker pool: every waiting Fence handler
    parks one worker, so a pool smaller than the gang would deadlock
    the barrier (the final ranks' RPCs queue behind the parked ones
    and the fence times out at N_pool/N arrived)."""

    def __init__(self, token: str = "", nranks: int = 0, tls=None,
                 epoch: int = 0):
        self.token = token
        self.nranks = nranks
        # coordinator incarnation: a restarted coordinator comes back
        # with a higher epoch so members of the previous incarnation
        # fail fast (stale epoch) instead of skewing fresh barriers
        self.epoch = epoch
        # utils.pki.TlsConfig (the hosting node's cluster cert): when
        # set, the service serves TLS so the per-gang bearer token and
        # modex/fence payloads never ride plaintext node-to-node in
        # TLS-enabled clusters (members dial with the cluster CA via
        # CRANE_RENDEZVOUS_CA)
        self.tls = tls
        self._kv: dict[str, bytes] = {}
        self._kv_cond = threading.Condition()
        self._fences: dict[tuple[str, int], _FenceState] = {}
        self._lock = threading.Lock()
        self._server: grpc.Server | None = None
        self.port = 0

    # ---- handlers ----

    def _check(self, context) -> None:
        if not self.token:
            return
        meta = dict(context.invocation_metadata() or ())
        if meta.get("crane-rdzv-token") != self.token:
            context.abort(grpc.StatusCode.PERMISSION_DENIED,
                          "bad rendezvous token")

    def _stale(self, req_epoch: int) -> str:
        """Non-empty error when ``req_epoch`` belongs to a previous
        coordinator incarnation (0 on either side disables the check
        for pre-epoch clients/servers)."""
        if self.epoch and req_epoch and req_epoch != self.epoch:
            return (f"stale epoch {req_epoch} (coordinator at "
                    f"incarnation {self.epoch})")
        return ""

    def Put(self, request, context):
        self._check(context)
        stale = self._stale(request.epoch)
        if stale:
            return pb.OkReply(ok=False, error=stale)
        with self._kv_cond:
            self._kv[request.key] = request.value
            self._kv_cond.notify_all()
        return pb.OkReply(ok=True)

    def Get(self, request, context):
        self._check(context)
        deadline = request.timeout or 0.0
        with self._kv_cond:
            if request.key not in self._kv and deadline > 0:
                self._kv_cond.wait_for(
                    lambda: request.key in self._kv, timeout=deadline)
            if request.key in self._kv:
                return pb.RdzvGetReply(ok=True,
                                       value=self._kv[request.key])
        return pb.RdzvGetReply(ok=False)

    def Fence(self, request, context):
        self._check(context)
        stale = self._stale(request.epoch)
        if stale:
            return pb.RdzvFenceReply(ok=False, error=stale,
                                     epoch=self.epoch)
        if request.nranks < 1 or request.rank >= request.nranks:
            return pb.RdzvFenceReply(
                ok=False, error=f"bad rank {request.rank}/"
                                f"{request.nranks}",
                epoch=self.epoch)
        fkey = (request.fence_id, request.epoch)
        with self._lock:
            st = self._fences.get(fkey)
            if st is None or st.done.is_set():
                # fresh round of this fence name (within this epoch)
                st = self._fences[fkey] = _FenceState(
                    request.nranks)
            if st.nranks != request.nranks:
                st.error = (f"nranks mismatch: {st.nranks} vs "
                            f"{request.nranks}")
                st.done.set()
            elif request.rank in st.data:
                return pb.RdzvFenceReply(
                    ok=False, error=f"duplicate rank {request.rank} "
                                    "in fence",
                    epoch=self.epoch)
            else:
                st.data[request.rank] = request.data
                if len(st.data) == st.nranks:
                    st.done.set()
        if not st.done.wait(timeout=request.timeout or 300.0):
            with self._lock:
                if not st.done.is_set():
                    # withdraw the contribution so THIS rank can retry
                    # the same fence (leaving it would wedge the epoch
                    # on 'duplicate rank' forever)
                    arrived = len(st.data)
                    st.data.pop(request.rank, None)
                    return pb.RdzvFenceReply(
                        ok=False,
                        error=f"fence timeout ({arrived}/"
                              f"{st.nranks} arrived)",
                        epoch=self.epoch)
            # completed at the buzzer: fall through to the result
        if st.error:
            return pb.RdzvFenceReply(ok=False, error=st.error,
                                     epoch=self.epoch)
        return pb.RdzvFenceReply(
            ok=True, data=[st.data[r] for r in range(st.nranks)],
            epoch=self.epoch)

    # ---- lifecycle ----

    _RPCS = {
        "Put": (pb.RdzvPutRequest, pb.OkReply),
        "Get": (pb.RdzvGetRequest, pb.RdzvGetReply),
        "Fence": (pb.RdzvFenceRequest, pb.RdzvFenceReply),
    }

    def start(self, address: str = "0.0.0.0:0") -> int:
        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                getattr(self, name),
                request_deserializer=req.FromString,
                response_serializer=reply.SerializeToString)
            for name, (req, reply) in self._RPCS.items()
        }
        # enough workers that the FULL gang can park in Fence while
        # Put/Get still make progress
        workers = max(16, 2 * self.nranks + 8)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=workers))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(RDZV_SERVICE,
                                                  handlers),))
        if self.tls is not None:
            from cranesched_tpu_torch.utils.pki import server_credentials
            self.port = self._server.add_secure_port(
                address, server_credentials(self.tls))
        else:
            self.port = self._server.add_insecure_port(address)
        if not self.port:
            # grpc returns 0 on bind failure instead of raising; a
            # silent no-listener server would strand the gang with
            # bare UNAVAILABLEs
            self._server.stop(grace=0)
            self._server = None
            raise OSError(f"rendezvous bind failed on {address}")
        self._server.start()
        return self.port

    def stop(self) -> None:
        # release every parked fence first: a handler blocked in
        # done.wait() sits on a NON-daemon gRPC worker thread and
        # would pin process exit until its timeout
        with self._lock:
            for st in self._fences.values():
                if not st.done.is_set():
                    st.error = "rendezvous server shutting down"
                    st.done.set()
        if self._server is not None:
            self._server.stop(grace=0.2)


class RendezvousClient:
    """Member-side stub (used by cranesched_tpu_torch.coord) — the shared
    GrpcStub plumbing with the gang-token header.

    Every call waits for the channel within its deadline: a member's
    script can reach ``coord fence`` before the rank-0 supervisor has
    bound this service, and a call that failed at once there would fail
    the member though its caller gave it a timeout (ROADMAP.md C4; the
    JAX package's client fails at once)."""

    def __init__(self, address: str, token: str = "", tls=None,
                 epoch: int = 0):
        from cranesched_tpu_torch.rpc.stub import GrpcStub
        self._stub = GrpcStub(address, RDZV_SERVICE, token=token,
                              token_key="crane-rdzv-token", tls=tls)
        # default incarnation stamped on every call (0 = no-check);
        # per-call override via the epoch= kwarg
        self.epoch = epoch

    def put(self, key: str, value: bytes,
            epoch: int | None = None) -> None:
        reply = self._stub.call(
            "Put", pb.RdzvPutRequest(
                key=key, value=value,
                epoch=self.epoch if epoch is None else epoch),
            pb.OkReply, wait_for_ready=True)
        if not reply.ok:
            raise RuntimeError(f"put {key!r} rejected: {reply.error}")

    def get(self, key: str, timeout: float = 0.0) -> bytes | None:
        reply = self._stub.call(
            "Get", pb.RdzvGetRequest(key=key, timeout=timeout),
            pb.RdzvGetReply, timeout=timeout + 30.0, wait_for_ready=True)
        return reply.value if reply.ok else None

    def fence(self, fence_id: str, rank: int, nranks: int,
              data: bytes = b"", timeout: float = 300.0,
              epoch: int | None = None) -> list[bytes]:
        reply = self._stub.call(
            "Fence",
            pb.RdzvFenceRequest(
                fence_id=fence_id, rank=rank, nranks=nranks, data=data,
                timeout=timeout,
                epoch=self.epoch if epoch is None else epoch),
            pb.RdzvFenceReply, timeout=timeout + 30.0,
            wait_for_ready=True)
        if not reply.ok:
            raise RuntimeError(f"fence {fence_id!r} failed: "
                               f"{reply.error}")
        return list(reply.data)

    def close(self) -> None:
        self._stub.close()
