"""gRPC control fabric of the port (``cranesched_tpu/rpc/``): the ctld
service, its client, and the wire schema.

``crane_pb2`` is a byte-identical copy of the JAX package's generated
module (protos/crane.proto): both register ``crane.proto`` in protobuf's
default descriptor pool, and a copy that differed by one byte of the
descriptor would conflict there in a process that imports both packages.
The service glue is hand-written in ``server``/``client``.

The server (which pulls the scheduler and torch) is imported lazily so a
process that only needs the client starts fast.
"""

from cranesched_tpu_torch.rpc import crane_pb2
from cranesched_tpu_torch.rpc.client import CtldClient

__all__ = ["CtldClient", "CtldServer", "crane_pb2", "serve"]


def __getattr__(name):
    if name in ("CtldServer", "serve"):
        from cranesched_tpu_torch.rpc import server
        return getattr(server, name)
    raise AttributeError(name)
