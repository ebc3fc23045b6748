"""Interconnect-topology subsystem (port of ``cranesched_tpu/topo/``).

``topo.model`` describes the cluster's interconnect as a small tree of
node groups (sub-tori or Slurm topology.conf-style switch blocks);
``topo.place`` is the best-fit-block gang solve that keeps multi-node
jobs inside one block whenever possible.
"""

from cranesched_tpu_torch.topo.model import Topology, topology_doc
from cranesched_tpu_torch.topo.place import (
    TopoInfo,
    solve_greedy_topo,
    solve_greedy_topo_permuted,
)

__all__ = ["Topology", "topology_doc", "TopoInfo", "solve_greedy_topo",
           "solve_greedy_topo_permuted"]
