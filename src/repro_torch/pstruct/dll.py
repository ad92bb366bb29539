"""Partly-persistent doubly linked list (paper §IV-C), the port of
``repro.pstruct.dll``.

Array-backed (indices as pointers) so operations vectorize over batches.
Layout, per node row of int64 words:

* partly persistent: one 64 B row = DATA (7 words) + NEXT.  PREV is
  volatile only.  Appending a node flushes 1 line.
* fully persistent: one 128 B row = DATA + NEXT + PREV + pad.  Appending
  flushes 2 lines, plus the successor's prev line on links.

Volatile redundancy (all DERIVABLE), on the arena's device: the PREV
tensor and the order ring (the list order materialized for O(1) batched
head pops).  TAIL lives in the header row; the free-slot list is a host
list, since allocation is a host decision.

Each operation reads the header row to the host once and writes it back
once; the header properties (``head``, ``count``) cost one device sync
each.

Reconstruction (paper §IV-C3): rank the persisted NEXT chain with the
shared ``chain_order`` primitive (contraction list ranking at this size,
on the card's kernels), then PREV by one scatter, TAIL = last, free slots
= complement of the live ids below the fresh-water mark.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import reconstruct as rec
from repro_torch.core.arena import Arena, not_ported
from repro_torch.core.recovery import chain_method, chain_order
from repro_torch.core.writeset import host_rows

NULL = -1
DATA_WORDS = 7

# header slots
H_FLAG, H_HEAD, H_COUNT, H_TAIL, H_FREE_HEAD, H_FRESH = range(6)


class DoublyLinkedList:
    """mode: "partly" | "full"."""

    def __init__(self, arena: Arena, capacity: int, mode: str = "partly",
                 name: str = "dll", chain_method: str = "auto",
                 snapshot: Optional[bool] = None):
        if mode not in ("partly", "full"):
            raise ValueError(f"unknown mode {mode!r}")
        if snapshot:
            raise not_ported("order snapshots")
        self.mode = mode
        self.capacity = capacity
        self.chain_method = chain_method
        self.arena = arena
        row = 8 if mode == "partly" else 16
        self.nodes = arena.regions.get(f"{name}.nodes") or arena.region(
            f"{name}.nodes", np.int64, (capacity, row))
        self.header = arena.regions.get(f"{name}.header") or arena.region(
            f"{name}.header", np.int64, (1, 8))
        dev = arena.device
        self.prev = torch.full((capacity,), NULL, dtype=torch.int64,
                               device=dev)
        self._free: list = []
        self._ring = torch.empty(capacity * 2, dtype=torch.int64, device=dev)
        self._r0 = 0
        self._r1 = 0

    @staticmethod
    def layout(capacity: int, mode: str = "partly", name: str = "dll",
               snapshot: Optional[bool] = None):
        if snapshot:
            raise not_ported("order snapshots")
        row = 8 if mode == "partly" else 16
        return {f"{name}.nodes": (np.int64, (capacity, row)),
                f"{name}.header": (np.int64, (1, 8))}

    # ------------- views -------------
    def _next_col(self) -> torch.Tensor:
        return self.nodes.vol[:, DATA_WORDS]

    @property
    def head(self) -> int:
        return int(self.header.vol[0, H_HEAD])

    @property
    def count(self) -> int:
        return int(self.header.vol[0, H_COUNT])

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int64, device=self.arena.device)

    # ------------- allocation -------------
    def _alloc(self, m: int, hv: np.ndarray) -> np.ndarray:
        ids = []
        take = min(len(self._free), m)
        if take:
            ids.extend(self._free[-take:])
            del self._free[-take:]
        fresh_needed = m - take
        fresh0 = int(hv[H_FRESH])
        if fresh_needed:
            if fresh0 + fresh_needed > self.capacity:
                raise MemoryError("dll arena exhausted")
            ids.extend(range(fresh0, fresh0 + fresh_needed))
            hv[H_FRESH] = fresh0 + fresh_needed
        return np.asarray(ids, np.int64)

    # ------------- operations -------------
    def append_batch(self, values) -> torch.Tensor:
        """Append m nodes at the tail.  values: (m, 7) int64.  Returns the
        new ids (int64 tensor on the arena's device)."""
        with self.arena.epoch():
            return self._append_batch(values)

    def _append_batch(self, values) -> torch.Tensor:
        values = self._dev(values)
        m = values.shape[0]
        hv = self.header.read_row(0)
        fresh0 = int(hv[H_FRESH])
        ids_h = self._alloc(m, hv)
        ids = self._dev(ids_h)
        vol = self.nodes.vol
        vol[ids, :DATA_WORDS] = values
        # chain: old_tail -> ids[0] -> ids[1] ... -> NULL
        vol[ids[:-1], DATA_WORDS] = ids[1:]
        vol[ids[-1], DATA_WORDS] = NULL
        self.prev[ids[1:]] = ids[:-1]
        old_tail = int(hv[H_TAIL]) if hv[H_COUNT] > 0 else NULL
        first = int(ids_h[0])
        if old_tail != NULL:
            vol[old_tail, DATA_WORDS] = first
            self.prev[first] = old_tail
        else:
            hv[H_HEAD] = first
            self.prev[first] = NULL
        hv[H_TAIL] = ids_h[-1]
        hv[H_COUNT] += m
        hv[H_FLAG] = 1
        if self.mode == "full":
            vol[ids[1:], DATA_WORDS + 1] = ids[:-1]
            vol[first, DATA_WORDS + 1] = old_tail
        # ring
        if self._r1 + m > self._ring.shape[0]:
            self._compact_ring()
        self._ring[self._r1:self._r1 + m] = ids
        self._r1 += m
        self.header.write_row(0, hv)
        # ---- mark dirty (flushed once at epoch close) ----
        new = ids_h[ids_h >= fresh0]
        if new.size:
            self.nodes.mark_rows(new, fresh=True)
        reused = ids_h[ids_h < fresh0]
        dirty = reused if old_tail == NULL \
            else np.concatenate([[old_tail], reused])
        if dirty.size:
            self.nodes.mark_rows(dirty)
        self.header.mark_rows(np.array([0]))
        return ids

    def pop_front_batch(self, m: int) -> torch.Tensor:
        """Remove the m oldest nodes (LRU eviction).  Returns their ids."""
        with self.arena.epoch():
            return self._pop_front_batch(m)

    def _pop_front_batch(self, m: int) -> torch.Tensor:
        hv = self.header.read_row(0)
        m = min(m, int(hv[H_COUNT]))
        if m == 0:
            return self._dev(np.empty(0, np.int64))
        ids = self._ring_pop(m)
        new_head = int(self.nodes.vol[ids[-1], DATA_WORDS])
        hv[H_HEAD] = new_head
        hv[H_COUNT] -= m
        if new_head == NULL:
            hv[H_TAIL] = NULL
        else:
            self.prev[new_head] = NULL
        self._free.extend(ids.tolist())
        self.header.write_row(0, hv)
        # partly: only the header changes persistently (the popped rows are
        # unreachable from HEAD, so their bytes are dead).
        if self.mode == "full" and new_head != NULL:
            # fully persistent must clear new_head's prev line
            self.nodes.vol[new_head, DATA_WORDS + 1] = NULL
            self.nodes.mark_rows(np.array([new_head]))
        self.header.mark_rows(np.array([0]))
        return ids

    def delete_batch(self, ids) -> None:
        """Unlink an arbitrary batch of node ids (vectorized rounds: each
        round unlinks ids whose predecessor is not itself being deleted),
        all rounds in one epoch."""
        with self.arena.epoch():
            self._delete_batch(host_rows(ids))

    def _delete_batch(self, ids: np.ndarray) -> None:
        # a Python set, iterated exactly as the reference iterates it: the
        # round order decides the free-list order, which decides which rows
        # later appends rewrite
        pending = set(ids.tolist())
        hv = self.header.read_row(0)
        vol = self.nodes.vol
        while pending:
            arr = self._dev(np.fromiter(pending, np.int64, len(pending)))
            ready = ~torch.isin(self.prev[arr], arr)
            batch = arr[ready]
            if batch.numel() == 0:   # adjacent chain; peel one end
                batch = arr[:1]
            nxt = vol[batch, DATA_WORDS]
            prv = self.prev[batch]
            # within a round each node has a DISTINCT predecessor and
            # successor, so the scatters are conflict-free
            link = prv != NULL
            vol[prv[link], DATA_WORDS] = nxt[link]
            has_nx = nxt != NULL
            self.prev[nxt[has_nx]] = prv[has_nx]
            if self.mode == "full":
                vol[nxt[has_nx], DATA_WORDS + 1] = prv[has_nx]
            nxt_h, prv_h = nxt.cpu().numpy(), prv.cpu().numpy()
            for i in np.nonzero(prv_h == NULL)[0]:
                hv[H_HEAD] = nxt_h[i]
            for i in np.nonzero(nxt_h == NULL)[0]:
                hv[H_TAIL] = prv_h[i]
            dirty = [prv_h[prv_h != NULL]]
            if self.mode == "full":
                dirty.append(nxt_h[nxt_h != NULL])
            dirty = np.concatenate(dirty)
            batch_l = batch.tolist()
            hv[H_COUNT] -= len(batch_l)
            self._free.extend(batch_l)
            pending.difference_update(batch_l)
            if dirty.size:
                self.nodes.mark_rows(dirty)
        self.header.write_row(0, hv)
        self.header.mark_rows(np.array([0]))
        self._ring_invalidate(self._dev(ids))

    # ------------- ring helpers -------------
    def _compact_ring(self) -> None:
        live = self._ring[self._r0:self._r1].clone()
        self._ring[:live.shape[0]] = live
        self._r0, self._r1 = 0, live.shape[0]

    def _ring_pop(self, m: int) -> torch.Tensor:
        """The m oldest live ids; the front advances past the m-th one
        (and every NULL hole before it)."""
        window = self._ring[self._r0:self._r1]
        at = torch.nonzero(window >= 0).squeeze(1)[:m]
        out = window[at]
        self._r0 += int(at[-1]) + 1
        return out

    def _ring_invalidate(self, ids: torch.Tensor) -> None:
        window = self._ring[self._r0:self._r1]
        window[torch.isin(window, ids)] = NULL

    # ------------- traversal -------------
    def to_list(self) -> torch.Tensor:
        """List order from NEXT via the shared chain_order primitive."""
        return chain_order(self._next_col(), self.head, self.count,
                           method=self.chain_method)

    def order(self) -> torch.Tensor:
        """List order from the volatile ring (no chain traversal)."""
        window = self._ring[self._r0:self._r1]
        return window[window != NULL].clone()

    # ------------- crash / reconstruction -------------
    def reconstruct(self) -> None:
        """Reload the regions and rebuild all volatile redundancy from the
        persistent fields (paper §IV-C3)."""
        self.header.load()
        self.nodes.load()
        rec.get("pstruct.dll")(self)


@rec.register("pstruct.dll")
def _reconstruct_dll(d: DoublyLinkedList) -> dict:
    """Pure rebuild of the DLL's volatile redundancy from its (loaded)
    persistent fields: PREV by one scatter off the chain order, TAIL =
    last, free slots = complement, order ring = chain order."""
    hv = d.header.read_row(0)
    dev = d.arena.device
    if hv[H_FLAG] != 1:
        # flag bit unset: nothing was ever flushed — recover as empty
        hv[:] = 0
        hv[H_HEAD] = NULL
        hv[H_TAIL] = NULL
    count = int(hv[H_COUNT])
    head = int(hv[H_HEAD])
    d.prev = torch.full((d.capacity,), NULL, dtype=torch.int64, device=dev)
    if count == 0:
        hv[H_TAIL] = NULL
        hv[H_FRESH] = 0
        d._free = []
        d._r0 = d._r1 = 0
        d.header.write_row(0, hv)
        return {"mode": d.mode, "count": 0}
    # The committed COUNT bounds the walk: rows appended by a torn epoch
    # (data flushed, header not) stay unreachable.
    method = d.chain_method
    order = chain_order(d._next_col(), head, count, method=method)
    d.prev[order[1:]] = order[:-1]
    hv[H_TAIL] = int(order[-1])
    live = torch.zeros(d.capacity, dtype=torch.bool, device=dev)
    live[order] = True
    # fresh-water mark: everything at/above the max live id is fresh
    fresh = int(order.max()) + 1
    hv[H_FRESH] = fresh
    d._free = torch.nonzero(~live[:fresh]).squeeze(1).tolist()
    d._ring = torch.empty(d.capacity * 2, dtype=torch.int64, device=dev)
    d._ring[:count] = order
    d._r0, d._r1 = 0, count
    if d.mode == "full":
        # pure-reconstructor PREV rebuild stays UNMARKED (derivable)
        d.nodes.vol[order[1:], DATA_WORDS + 1] = order[:-1]
        d.nodes.vol[order[:1], DATA_WORDS + 1] = NULL
    d.header.write_row(0, hv)
    return {"mode": d.mode, "count": count,
            "chain": chain_method(d.capacity, count, method)}
