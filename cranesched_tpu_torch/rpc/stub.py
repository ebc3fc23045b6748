"""Generic unary-unary gRPC stub with a lazy per-method cache — the
single transport plumbing shared by the CLI/ctld client and the
ctld->craned dispatcher.  Plaintext by default; pass a
``utils.pki.TlsConfig`` to dial TLS (with a client cert when the peer
requires mTLS)."""

from __future__ import annotations

import grpc


class GrpcStub:
    def __init__(self, address: str, service: str, timeout: float = 30.0,
                 token: str = "", tls=None,
                 token_key: str = "crane-token"):
        self.address = address
        self.service = service
        self.timeout = timeout
        # bearer token attached as metadata on every call (verified by
        # the ctld's AuthManager; empty = unauthenticated).  token_key
        # lets other services on this plumbing use their own header
        # (e.g. the rendezvous service's per-gang secret)
        self.token = token
        self.token_key = token_key
        if tls is not None:
            from cranesched_tpu_torch.utils.pki import secure_channel
            self._channel = secure_channel(address, tls)
        else:
            self._channel = grpc.insecure_channel(address)
        self._stubs = {}

    def call(self, name, request, reply_cls, timeout: float | None = None,
             metadata=(), wait_for_ready: bool = False):
        """``metadata``: extra (key, value) pairs appended after the
        auth token — e.g. the dispatcher's crane-trace context.
        ``wait_for_ready``: wait within the deadline for a peer that is
        not listening yet instead of failing at once (UNAVAILABLE)."""
        stub = self._stubs.get(name)
        if stub is None:
            stub = self._channel.unary_unary(
                f"/{self.service}/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=reply_cls.FromString)
            self._stubs[name] = stub
        md = (((self.token_key, self.token),) if self.token else ())
        md = md + tuple(metadata)
        return stub(request, timeout=timeout or self.timeout,
                    metadata=md or None, wait_for_ready=wait_for_ready)

    # server streams drain large result sets across many scheduler
    # cycles — the unary timeout (30 s) would abort them mid-stream
    STREAM_TIMEOUT = 600.0

    def call_stream(self, name, request, reply_cls):
        """Server-streaming call: yields reply messages."""
        stub = self._stubs.get(("stream", name))
        if stub is None:
            stub = self._channel.unary_stream(
                f"/{self.service}/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=reply_cls.FromString)
            self._stubs[("stream", name)] = stub
        metadata = (((self.token_key, self.token),) if self.token
                    else None)
        return stub(request, timeout=self.STREAM_TIMEOUT,
                    metadata=metadata)

    def close(self) -> None:
        self._channel.close()
