"""Interconnect topology model (port of ``cranesched_tpu/topo/model.py``).

A ``Topology`` is a small tree over the node registry: the leaf level
partitions nodes into *blocks* (a TPU sub-slice / an ICI domain / the
nodes under one leaf switch), and optional upper levels group blocks
under switches.  Two construction paths:

* ``Topology.from_torus(shape, slice_shape)`` — a TPU v4-style 3D torus
  carved into aligned sub-tori (Jouppi et al., ISCA 2023): node id i is
  the row-major coordinate of the torus, and its block is the aligned
  ``slice_shape`` sub-torus containing it.
* explicit blocks/switches from the YAML ``Topology:`` section
  (``Topology.from_config``), mirroring Slurm's topology.conf
  SwitchName/Nodes lines.

Everything the solver needs is precomputed as flat arrays so the device
solve stays shape-static:

* ``block_of_node``  int32 [N], -1 = not in any block (never grouped)
* per level ``(group_of_node [N], group_sizes [G])`` — leaf first, each
  upper level's group ids composed through the parent maps
* ``perm`` / ``inv_perm`` — the **block-major node permutation**: a
  stable sort of node ids by block id.  Feeding the permuted node axis
  to the existing first-fit backends makes their left-to-right walk
  locality-aware with zero kernel changes (nodes of a block are
  contiguous, so cheapest/first picks cluster inside blocks).

Host (numpy) arrays are authoritative; torch twins are built on demand
for an explicit device (``levels(device)``, ``perm_tensor(device)``,
``inv_perm_tensor(device)``) and cached per device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Topology:
    """Static interconnect description over node ids ``0..N-1``.

    ``upper_levels`` is a sequence of ``(level_name, group_names,
    parent_of_prev_group int32)`` triples ordered bottom-up: the first
    entry maps leaf blocks to its groups, the next maps those groups up,
    and so on.  ``-1`` parents propagate (an ungrouped block stays
    ungrouped at every upper level).
    """

    def __init__(self, num_nodes: int, block_of_node,
                 block_names: Sequence[str],
                 upper_levels: Sequence[tuple] = (),
                 coords: Optional[np.ndarray] = None,
                 leaf_name: str = "block"):
        block_of_node = np.asarray(block_of_node, np.int32)
        if block_of_node.shape != (num_nodes,):
            raise ValueError(
                f"block_of_node shape {block_of_node.shape} != ({num_nodes},)")
        self.num_nodes = int(num_nodes)
        self.block_of_node = block_of_node
        self.block_names = [str(n) for n in block_names]
        self.num_blocks = len(self.block_names)
        if int(block_of_node.max(initial=-1)) >= self.num_blocks:
            raise ValueError("block_of_node references an unnamed block")
        self.leaf_name = str(leaf_name)
        self.coords = None if coords is None else np.asarray(coords, np.int32)
        self.upper_levels = [
            (str(name), [str(g) for g in gnames],
             np.asarray(parent, np.int32))
            for name, gnames, parent in upper_levels]
        for _, gnames, parent in self.upper_levels:
            if int(parent.max(initial=-1)) >= len(gnames):
                raise ValueError("parent map references an unnamed group")
        self.block_sizes = np.bincount(
            block_of_node[block_of_node >= 0],
            minlength=self.num_blocks).astype(np.int32)
        # block-major permutation: stable by block id, ungrouped nodes
        # (bin B) last; within a block, node-id order is preserved
        bins = np.where(block_of_node >= 0, block_of_node, self.num_blocks)
        self.perm = np.argsort(bins, kind="stable").astype(np.int32)
        self.inv_perm = np.empty_like(self.perm)
        self.inv_perm[self.perm] = np.arange(num_nodes, dtype=np.int32)
        self._levels_np = None
        self._twins: dict = {}

    # ---- constructors ----

    @classmethod
    def from_torus(cls, shape: Sequence[int], slice_shape: Sequence[int],
                   name_prefix: str = "slice") -> "Topology":
        """Torus of ``shape`` carved into aligned ``slice_shape`` blocks.

        Node id = row-major coordinate; every dimension of ``shape``
        must be divisible by the matching ``slice_shape`` dimension so
        the sub-tori tile the torus exactly.
        """
        shape = [int(d) for d in shape]
        slice_shape = [int(s) for s in slice_shape]
        if len(shape) != len(slice_shape) or not shape:
            raise ValueError(
                f"torus shape {shape} and slice {slice_shape} must have "
                "the same (nonzero) rank")
        for d, s in zip(shape, slice_shape):
            if d <= 0 or s <= 0 or d % s:
                raise ValueError(
                    f"slice shape {slice_shape} does not tile torus {shape}")
        n = int(np.prod(shape))
        coords = np.stack(
            np.unravel_index(np.arange(n), shape), axis=1).astype(np.int32)
        grid = [d // s for d, s in zip(shape, slice_shape)]
        bcoords = coords // np.asarray(slice_shape, np.int32)
        block = np.ravel_multi_index(
            tuple(bcoords.T), grid).astype(np.int32)
        names = [
            name_prefix + "-" + "x".join(
                str(int(c)) for c in np.unravel_index(b, grid))
            for b in range(int(np.prod(grid)))]
        return cls(n, block, names, coords=coords)

    @classmethod
    def uniform_blocks(cls, num_nodes: int, block_size: int,
                       name_prefix: str = "block") -> "Topology":
        """Contiguous-id blocks of equal size (bench/replay generator)."""
        if block_size <= 0 or num_nodes % block_size:
            raise ValueError(
                f"block size {block_size} does not divide {num_nodes}")
        block = (np.arange(num_nodes) // block_size).astype(np.int32)
        names = [f"{name_prefix}{b}"
                 for b in range(num_nodes // block_size)]
        return cls(num_nodes, block, names)

    @classmethod
    def from_config(cls, spec: dict, name_to_id=None,
                    num_nodes: Optional[int] = None) -> "Topology":
        """Build from the YAML ``Topology:`` section.

        Torus shorthand::

            Topology:
              Torus: [8, 8, 8]
              Slice: [4, 4, 4]

        Explicit tree (Slurm topology.conf style)::

            Topology:
              Blocks:
                - name: b0
                  nodes: tpu[00000-00003]
              Switches:
                - name: sw0
                  blocks: [b0, b1]
        """
        if "Torus" in spec:
            slice_shape = spec.get("Slice") or spec.get("SliceShape")
            if not slice_shape:
                raise ValueError("Topology.Torus requires Slice: [x, y, z]")
            topo = cls.from_torus(spec["Torus"], slice_shape)
            if num_nodes is not None and topo.num_nodes != num_nodes:
                raise ValueError(
                    f"Torus {spec['Torus']} covers {topo.num_nodes} nodes "
                    f"but the cluster registers {num_nodes}")
            return topo
        blocks = spec.get("Blocks")
        if not blocks:
            raise ValueError("Topology: needs either Torus: or Blocks:")
        if num_nodes is None:
            raise ValueError("explicit Blocks: need the registry size")
        from cranesched_tpu_torch.utils.hostlist import parse_hostlist
        name_to_id = name_to_id or {}
        block_of_node = np.full(num_nodes, -1, np.int32)
        names: list[str] = []
        for entry in blocks:
            bid = len(names)
            names.append(str(entry["name"]))
            for host in parse_hostlist(str(entry["nodes"])):
                nid = name_to_id.get(host)
                if nid is None:
                    raise ValueError(
                        f"Topology block {entry['name']!r}: unknown node "
                        f"{host!r}")
                if block_of_node[nid] >= 0:
                    raise ValueError(
                        f"node {host!r} listed in two topology blocks")
                block_of_node[nid] = bid
        uppers = []
        if spec.get("Switches"):
            parent = np.full(len(names), -1, np.int32)
            gnames: list[str] = []
            bindex = {nm: i for i, nm in enumerate(names)}
            for entry in spec["Switches"]:
                gid = len(gnames)
                gnames.append(str(entry["name"]))
                for b in entry.get("blocks", ()):
                    if str(b) not in bindex:
                        raise ValueError(
                            f"switch {entry['name']!r}: unknown block "
                            f"{b!r}")
                    if parent[bindex[str(b)]] >= 0:
                        raise ValueError(
                            f"block {b!r} listed under two switches")
                    parent[bindex[str(b)]] = gid
            uppers.append(("switch", gnames, parent))
        return cls(num_nodes, block_of_node, names, upper_levels=uppers)

    # ---- derived level arrays ----

    @property
    def levels_np(self):
        """Leaf-first ``[(name, group_of_node [N], sizes [G], names)]``."""
        if self._levels_np is None:
            out = [(self.leaf_name, self.block_of_node, self.block_sizes,
                    self.block_names)]
            gon = self.block_of_node
            for name, gnames, parent in self.upper_levels:
                gon = np.where(gon >= 0, parent[np.maximum(gon, 0)],
                               np.int32(-1)).astype(np.int32)
                sizes = np.bincount(
                    gon[gon >= 0], minlength=len(gnames)).astype(np.int32)
                out.append((name, gon, sizes, list(gnames)))
            self._levels_np = out
        return self._levels_np

    def _twin(self, device):
        dev = torch.device(device)
        twin = self._twins.get(dev)
        if twin is None:
            twin = self._twins[dev] = {
                "levels": tuple(
                    (torch.from_numpy(gon).to(dev),
                     torch.from_numpy(sizes).to(dev))
                    for _, gon, sizes, _ in self.levels_np),
                "perm": torch.from_numpy(self.perm).to(dev),
                "inv_perm": torch.from_numpy(self.inv_perm).to(dev),
            }
        return twin

    def levels(self, device):
        """``levels_np`` on ``device`` in ``solve_greedy_topo`` form: the
        leaf-first tuple of ``(group_of_node int32[N], sizes int32[G])``."""
        return self._twin(device)["levels"]

    def perm_tensor(self, device) -> torch.Tensor:
        """``perm`` as int32 on ``device``."""
        return self._twin(device)["perm"]

    def inv_perm_tensor(self, device) -> torch.Tensor:
        """``inv_perm`` as int32 on ``device``."""
        return self._twin(device)["inv_perm"]

    def block_masks(self) -> np.ndarray:
        """Boolean block-membership matrix ``[B, N]``."""
        return (self.block_of_node[None, :]
                == np.arange(self.num_blocks, dtype=np.int32)[:, None])

    def block_path(self, node_id: int) -> tuple:
        """Top-down group-name path for a node, e.g. (switch, block)."""
        b = int(self.block_of_node[node_id])
        if b < 0:
            return ()
        path = [self.block_names[b]]
        g = b
        for _, gnames, parent in self.upper_levels:
            g = int(parent[g])
            if g < 0:
                break
            path.append(gnames[g])
        return tuple(reversed(path))

    # ---- telemetry ----

    def fragmentation(self, free_mask) -> list[tuple[str, float]]:
        """Per-level free-capacity fragmentation, leaf first.

        ``1 - largest_free_group / total_free`` — 0.0 means all free
        nodes sit in one group (a gang up to that size fits locally),
        1.0-ish means the free pool is dust.  Free nodes outside any
        group count toward the total (they do fragment gang capacity)
        but never toward a group's share.  Defined as 0.0 when nothing
        is free (an empty pool is not fragmented, just full).
        """
        free_mask = np.asarray(free_mask, bool)
        total_free = int(free_mask.sum())
        out = []
        for name, gon, sizes, _ in self.levels_np:
            if total_free == 0:
                out.append((name, 0.0))
                continue
            per = np.bincount(gon[free_mask & (gon >= 0)],
                              minlength=max(len(sizes), 1))
            largest = int(per.max(initial=0))
            out.append((name, round(1.0 - largest / total_free, 6)))
        return out


def topology_doc(topo: Topology, free_mask=None) -> dict:
    """JSON section for QueryStats (feeds ``cinfo --topo``)."""
    parent_names = None
    if topo.upper_levels:
        _, gnames, parent = topo.upper_levels[0]
        parent_names = [gnames[p] if p >= 0 else None for p in parent]
    frags = (dict(topo.fragmentation(free_mask))
             if free_mask is not None else {})
    doc = {"num_nodes": topo.num_nodes, "num_blocks": topo.num_blocks,
           "levels": []}
    for li, (name, gon, sizes, names) in enumerate(topo.levels_np):
        groups = []
        for g in range(len(names)):
            entry = {"name": names[g], "size": int(sizes[g])}
            if free_mask is not None:
                entry["free"] = int(
                    np.asarray(free_mask, bool)[gon == g].sum())
            if li == 0 and parent_names is not None:
                entry["parent"] = parent_names[g]
            groups.append(entry)
        doc["levels"].append({"name": name,
                              "fragmentation": frags.get(name),
                              "groups": groups})
    return doc
