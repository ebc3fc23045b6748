"""gRPC server interceptor feeding the obs metrics registry.

One interceptor instance per daemon process (ctld's CtldServer and the
craned daemon's supervisor-facing server both install it): per-method
request count, latency histogram, and error count under the
``crane_rpc_*`` names.  Errors are exceptions escaping the handler —
application-level ``ok=False`` replies are successes at this layer, the
same line Prometheus draws between transport and application errors.
"""

from __future__ import annotations

import time

import grpc

from cranesched_tpu_torch.obs import REGISTRY


class MetricsInterceptor(grpc.ServerInterceptor):
    def __init__(self, registry=None, plane: str = "ctld"):
        reg = registry or REGISTRY
        self.plane = plane
        self._requests = reg.counter(
            "crane_rpc_requests_total", "RPCs served (label method)")
        self._errors = reg.counter(
            "crane_rpc_errors_total",
            "RPCs whose handler raised (label method)")
        self._latency = reg.histogram(
            "crane_rpc_latency_seconds",
            "RPC handler wall time (label method)")

    def _observe(self, method: str, fn, request, context):
        t0 = time.perf_counter()
        try:
            return fn(request, context)
        except Exception:
            self._errors.inc(method=method, plane=self.plane)
            raise
        finally:
            self._requests.inc(method=method, plane=self.plane)
            self._latency.observe(time.perf_counter() - t0,
                                  method=method, plane=self.plane)

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        method = handler_call_details.method.rsplit("/", 1)[-1]
        if handler.unary_unary is not None:
            inner = handler.unary_unary

            def unary(request, context, _inner=inner, _m=method):
                return self._observe(_m, _inner, request, context)

            return grpc.unary_unary_rpc_method_handler(
                unary,
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        if handler.unary_stream is not None:
            inner = handler.unary_stream

            def stream(request, context, _inner=inner, _m=method):
                # time to full drain: the latency a streaming client
                # actually experiences, not just first-byte
                t0 = time.perf_counter()
                try:
                    yield from _inner(request, context)
                except Exception:
                    self._errors.inc(method=_m, plane=self.plane)
                    raise
                finally:
                    self._requests.inc(method=_m, plane=self.plane)
                    self._latency.observe(time.perf_counter() - t0,
                                          method=_m, plane=self.plane)

            return grpc.unary_stream_rpc_method_handler(
                stream,
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        return handler
