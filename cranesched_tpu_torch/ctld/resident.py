"""Device-resident ClusterState across scheduling cycles (port of
``cranesched_tpu/ctld/resident.py``).

The immediate-fit solve keeps its ClusterState tensors on the device
between cycles and ships only ``(dirty_idx, dirty_rows)``:

- **Dirty tracking** piggybacks on MetaContainer's ``_touch_node`` hook
  (``dirty_listeners``).  Rows the solver subtracted on device but the
  host then rejected at commit are fed back through ``mark_diverged``.
- **Ownership discipline**: ``acquire()`` hands the state to the solve
  and forgets it; the solve updates the tensors IN PLACE (the port's
  counterpart of buffer donation) and the scheduler gives the state back
  via ``adopt()``.  Nothing else holds the state between the two.
- **Invalidation contract**: the caller passes a ``key`` (solver label,
  node count, resource dims, mask-table generation).  Any mismatch drops
  the resident state and the next acquire pays one full rebuild.
- **Double buffering**: ``stage()`` runs right after commit and copies
  the *next* cycle's patch rows from pinned host buffers with
  ``non_blocking`` copies on a side CUDA stream, recording an event;
  ``acquire()`` makes the current stream wait on that event and consumes
  the staged rows only if nothing moved since (same ``meta_epoch`` and
  row set).  On the CPU ``stage()`` copies synchronously.

The cost seed is time-dependent — it changes for every node every cycle
— so the ``[N]`` int32 cost ledger always ships full.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from cranesched_tpu_torch.models.solver import (
    make_cluster_state,
    patch_cluster_state,
    refresh_cost_ledger,
)

# dirty-row counts are bucketed to powers of two (floor 16), capped at N
_ROW_FLOOR = 16


def _bucket(n: int, floor: int = _ROW_FLOOR) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def padded_rows(dirty: int, num_nodes: int) -> int:
    """Padded patch length: power-of-two bucketed (floor 16), capped at
    the node count (a pad larger than N would ship more than a full
    rebuild)."""
    return min(_bucket(dirty), max(num_nodes, 1))


def patch_row_bytes(num_dims: int) -> int:
    """Host→device bytes for one patched row: int32 index + int32
    avail[R] + int32 total[R] + bool alive."""
    return 4 + 4 * num_dims + 4 * num_dims + 1


def full_state_bytes(num_nodes: int, num_dims: int) -> int:
    """Host→device bytes for a full rebuild (avail+total int32 [N,R],
    alive bool [N], cost int32 [N])."""
    return num_nodes * (8 * num_dims + 1) + 4 * num_nodes


class ResidentClusterState:
    """Owns the cross-cycle device ClusterState for one scheduler."""

    def __init__(self, meta, device: torch.device, enabled: bool = True):
        self.meta = meta
        self.device = device
        self.enabled = enabled
        self._state = None
        self._key = None
        self._pending: set[int] = set()
        self._diverged: set[int] = set()
        # (meta_epoch, rowset, idx, avail, total, alive, ready_event)
        self._staged = None
        self._pinned = None
        self._copy_stream = None
        # telemetry (persistent; the per-cycle mode is consumed by the
        # scheduler via pop_cycle_mode)
        self.full_rebuilds = 0
        self.patch_cycles = 0
        self.ledger_cycles = 0
        self.staged_hits = 0
        self.last_h2d_rows = 0
        self.last_h2d_bytes = 0
        self.last_overlap = False
        self._cycle_mode: str | None = None
        if enabled:
            meta.dirty_listeners.append(self._note_dirty)

    # ---- dirty feeds ----

    def _note_dirty(self, node_id: int) -> None:
        self._pending.add(node_id)

    def mark_diverged(self, node_ids: Iterable[int]) -> None:
        """Commit rejected solver placements on these nodes: the device
        subtracted resources the host never allocated, and no host
        mutation will ever dirty the row.  Force-patch them next cycle."""
        if self.enabled and self._state is not None:
            self._diverged.update(int(i) for i in node_ids)

    def invalidate(self) -> None:
        """Drop the resident state; the next acquire() fully rebuilds."""
        self._state = None
        self._key = None
        self._staged = None
        self._pending.clear()
        self._diverged.clear()

    # ---- cycle protocol ----

    def acquire(self, avail, total, alive, cost0, key):
        """Hand a current device ClusterState to this cycle's solve.

        Ownership transfers to the caller, who must give the state back
        via adopt().  Returns ``(state, mode)`` with mode "rebuild",
        "patch", or "ledger" (empty delta: only the [N] cost ledger
        shipped)."""
        state, self._state = self._state, None
        n, r = np.shape(avail)
        if state is None or key != self._key:
            self.invalidate()
            self._key = key
            state = make_cluster_state(avail, total, alive, cost0,
                                       device=self.device)
            self.full_rebuilds += 1
            self._cycle_mode = "rebuild"
            self.last_h2d_rows = n
            self.last_h2d_bytes = full_state_bytes(n, r)
            self.last_overlap = False
            return state, "rebuild"

        rows = frozenset(self._pending | self._diverged)
        staged, self._staged = self._staged, None
        if not rows:
            state = refresh_cost_ledger(state, cost0)
            self.patch_cycles += 1
            self.ledger_cycles += 1
            self.staged_hits += 1
            self._cycle_mode = "ledger"
            self.last_overlap = True
            self.last_h2d_rows = 0
            self.last_h2d_bytes = 4 * n
            return state, "ledger"
        if (staged is not None and staged[0] == self.meta.meta_epoch
                and staged[1] == rows):
            # overlap hit: the delta was copied at the end of the
            # previous cycle and nothing moved since
            _, _, idx, av, tot, al, ready = staged
            if ready is not None:
                torch.cuda.current_stream(self.device).wait_event(ready)
            self.staged_hits += 1
            self.last_overlap = True
        else:
            idx, av, tot, al = self._gather_live(rows, n, r)
            self.last_overlap = False
        state = patch_cluster_state(state, idx, av, tot, al, cost0)
        # only retire the rows this patch covered; concurrent dirties
        # that land after the frozenset copy stay pending for next tick
        self._pending -= rows
        self._diverged -= rows
        self.patch_cycles += 1
        self._cycle_mode = "patch"
        self.last_h2d_rows = len(rows)
        self.last_h2d_bytes = (padded_rows(len(rows), n)
                               * patch_row_bytes(r) + 4 * n)
        return state, "patch"

    def adopt(self, new_state) -> None:
        """Take ownership of the solve's (post-placement) state; it
        becomes the resident state for the next cycle."""
        if self.enabled:
            self._state = new_state

    def stage(self) -> None:
        """Post-commit: copy the rows dirtied by this cycle's commit to
        the device ahead of the next acquire().  On CUDA the copies run
        from pinned buffers on a side stream and overlap the dispatch
        drain and the next prelude.  No-op when the resident path is
        idle."""
        if not self.enabled or self._state is None:
            return
        rows = frozenset(self._pending | self._diverged)
        if not rows:
            self._staged = None
            return
        n = len(self.meta.nodes)
        r = self.meta.layout.num_dims
        host = self._gather_live(rows, n, r)
        if self.device.type != "cuda":
            dev = tuple(torch.from_numpy(a).to(self.device) for a in host)
            self._staged = (self.meta.meta_epoch, rows, *dev, None)
            return
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        pinned = [torch.from_numpy(a).pin_memory() for a in host]
        # the side stream must not overtake work already queued on the
        # current stream that reads the previous staged rows
        self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy_stream):
            dev = tuple(p.to(self.device, non_blocking=True)
                        for p in pinned)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        # the tensors are used on the current stream after the wait in
        # acquire(); tell the caching allocator so it does not reuse
        # their memory early
        main = torch.cuda.current_stream(self.device)
        for t in dev:
            t.record_stream(main)
        self._pinned = pinned   # host sources outlive the async copy
        self._staged = (self.meta.meta_epoch, rows, *dev, ready)

    # ---- helpers ----

    def _gather_live(self, rows, n, r):
        """Padded (idx, avail, total, alive) read straight from the live
        ledger (meta.nodes).  Pad index = n, dropped by the patch."""
        p = padded_rows(len(rows), n)
        idx = np.full(p, n, np.int32)
        av = np.zeros((p, r), np.int32)
        tot = np.zeros((p, r), np.int32)
        al = np.zeros(p, bool)
        nodes = self.meta.nodes
        for k, i in enumerate(sorted(rows)):
            node = nodes[i]
            idx[k] = i
            av[k] = node.avail
            tot[k] = node.total
            al[k] = node.schedulable
        return idx, av, tot, al

    def pop_cycle_mode(self) -> str | None:
        """Mode of the acquire() this cycle performed, if any."""
        mode, self._cycle_mode = self._cycle_mode, None
        return mode

    def overlap_share(self) -> float:
        """Share of patch cycles whose delta upload was pre-staged."""
        return self.staged_hits / self.patch_cycles if self.patch_cycles else 0.0
