"""Mesh layer of the port (port of ``cranesched_tpu/parallel/``):

- :mod:`sharded` -- the node axis of the cluster tensors split into one
  slab per shard of a device mesh, with the per-job candidate merge
  across shards;
- :mod:`distributed` -- node slabs across processes, merged through a
  rendezvous fence once a step;
- :mod:`acquire` -- the bounded acquisition of the card.
"""

# Lazy exports, as in the JAX package: parallel.acquire must stay
# importable without pulling the solvers (and torch's device stack) in.
_SHARDED = ("make_node_mesh", "shard_cluster_state",
            "solve_greedy_sharded", "solve_greedy_sharded_classes")
_DISTRIBUTED = ("bootstrap_process_mesh", "ProcessMesh",
                "solve_greedy_sharded_classes_mp")
_ACQUIRE = ("acquire_device", "ensure_device", "preflight_report")

__all__ = [*_SHARDED, *_DISTRIBUTED, *_ACQUIRE]


def __getattr__(name):
    import importlib
    if name in _SHARDED:
        mod = importlib.import_module("cranesched_tpu_torch.parallel.sharded")
    elif name in _DISTRIBUTED:
        mod = importlib.import_module(
            "cranesched_tpu_torch.parallel.distributed")
    elif name in _ACQUIRE:
        mod = importlib.import_module("cranesched_tpu_torch.parallel.acquire")
    else:
        raise AttributeError(name)
    return getattr(mod, name)
