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

Order snapshots (DESIGN.md §10, on unless ``snapshot=False`` or
``REPRO_SNAPSHOT=0``): a persisted mirror of the order ring
(``snapring``) and a 4-slot record ring (``snaprec``), written by a
snapshot provider at every drain.  Recovery seeds the order from the
newest committed record plus a walk of the suffix appended after it, and
adopts it only when ``chain_order``'s verify pass proves it IS the chain.
The dirty-slot mask is a bool tensor on the arena's device, so marking a
slot costs no sync; each emit finds the dirty slots with one
``nonzero``.

Every access to the node rows goes through the region's accessors
(``read_at``, ``read_one``, ``read_col``, ``write_at``), in the reference's
calls and order: on a resident region they are views and indexed writes of
the volatile tensor, and on a paged arena (DESIGN.md §12) they route
through the block cache, so its counters follow the reference's.  Recovery
on a paged arena adopts a snapshot after verifying only the candidate
rows' NEXT words (``_gather_verify``), and walks the suffix one
``read_one`` at a time; ``.data`` and ``.next`` spill a paged region, as in
the reference.

Salvage (DESIGN.md §13, ``recover(salvage=True)`` on an integrity arena):
the node rows failing their checksums terminate the chain, and the list
recovers as the longest committed prefix whose every node verifies.  The
reference walks that prefix one pointer at a time on the host; here the
committed NEXT column goes to the device once and ``salvage_prefix``
ranks it with the chain kernels.  Quarantined rows stay out of the free
list, so no later append resurrects them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import reconstruct as rec
from repro_torch.core.arena import (SNAP_SLOTS, SNAP_WORDS, Arena,
                                    CorruptLineError, FlushStats,
                                    newest_committed, snap_record_pack,
                                    snap_records, snapshot_enabled)
from repro_torch.core.recovery import (ChainSnapshot, chain_method,
                                       chain_order, salvage_prefix)
from repro_torch.core.writeset import host_rows

NULL = -1
DATA_WORDS = 7

# Sharded-arena routing (DESIGN.md §7): node rows stripe block-cyclically in
# segments of 64, so a batch's flush fans out across the shard files while
# rows within a segment still coalesce lines.
SHARD_SEG = 64

# header slots
H_FLAG, H_HEAD, H_COUNT, H_TAIL, H_FREE_HEAD, H_FRESH = range(6)


class DoublyLinkedList:
    """mode: "partly" | "full"."""

    def __init__(self, arena: Arena, capacity: int, mode: str = "partly",
                 name: str = "dll", chain_method: str = "auto",
                 snapshot: Optional[bool] = None):
        if mode not in ("partly", "full"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.capacity = capacity
        self.chain_method = chain_method
        self.arena = arena
        row = 8 if mode == "partly" else 16
        self.nodes = arena.regions.get(f"{name}.nodes") or arena.region(
            f"{name}.nodes", np.int64, (capacity, row),
            router=("seg", SHARD_SEG))
        self.header = arena.regions.get(f"{name}.header") or arena.region(
            f"{name}.header", np.int64, (1, 8))
        dev = arena.device
        self.prev = torch.full((capacity,), NULL, dtype=torch.int64,
                               device=dev)
        self._free: list = []
        self._ring = torch.empty(capacity * 2, dtype=torch.int64, device=dev)
        self._r0 = 0
        self._r1 = 0
        # order snapshots; OFF when the layout was finalized without the
        # snapshot regions (an older image, or REPRO_SNAPSHOT=0 at
        # creation), as in the reference
        snap_on = snapshot_enabled(snapshot)
        self.snapring = arena.regions.get(f"{name}.snapring")
        self.snaprec = arena.regions.get(f"{name}.snaprec")
        if snap_on and self.snapring is None and not arena._layout_final:
            self.snapring = arena.region(f"{name}.snapring", np.int64,
                                         (capacity * 2,),
                                         router=("seg", SHARD_SEG))
            self.snaprec = arena.region(f"{name}.snaprec", np.int64,
                                        (SNAP_SLOTS, SNAP_WORDS))
        self.snapshot = snap_on and self.snapring is not None
        if self.snapshot:
            self._snap_dirty = torch.zeros(capacity * 2, dtype=torch.bool,
                                           device=dev)
            self._snap_seq = 0
            self._snap_resync = True   # first drain mirrors the window
            self._snap_last = None     # (r0, r1, count) at the last emit
            arena.add_snapshot_provider(self._snap_emit)

    @staticmethod
    def layout(capacity: int, mode: str = "partly", name: str = "dll",
               snapshot: Optional[bool] = None):
        row = 8 if mode == "partly" else 16
        out = {f"{name}.nodes": (np.int64, (capacity, row),
                                 ("seg", SHARD_SEG)),
               f"{name}.header": (np.int64, (1, 8))}
        if snapshot_enabled(snapshot):
            out[f"{name}.snapring"] = (np.int64, (capacity * 2,),
                                       ("seg", SHARD_SEG))
            out[f"{name}.snaprec"] = (np.int64, (SNAP_SLOTS, SNAP_WORDS))
        return out

    # ------------- views -------------
    @property
    def data(self) -> torch.Tensor:
        """DATA words of every node row, a (capacity, 7) view of the
        volatile tensor (on a paged arena this SPILLS the region)."""
        return self.nodes.vol[:, :DATA_WORDS]

    @property
    def next(self) -> torch.Tensor:
        """The NEXT column, a (capacity,) view of the volatile tensor (on a
        paged arena this SPILLS the region)."""
        return self.nodes.vol[:, DATA_WORDS]

    def data_rows(self, ids) -> torch.Tensor:
        """DATA words of the given node ids, (len(ids), 7) on the arena's
        device."""
        return self.nodes.read_at(ids, slice(0, DATA_WORDS))

    def _next_col(self) -> torch.Tensor:
        """The NEXT column for a full chain walk: a paged region reads it
        through the block cache; a resident one returns the live view."""
        return self.nodes.read_col(DATA_WORDS)

    @property
    def head(self) -> int:
        return int(self.header.vol[0, H_HEAD])

    @property
    def tail(self) -> int:
        return int(self.header.vol[0, H_TAIL])

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
        nodes = self.nodes
        # a paged region books its accesses on the host ids
        at = ids_h if nodes.is_paged else ids
        nodes.write_at(at, slice(0, DATA_WORDS), values)
        # chain: old_tail -> ids[0] -> ids[1] ... -> NULL
        nodes.write_at(at[:-1], DATA_WORDS, ids[1:])
        nodes.write_at(at[-1:], DATA_WORDS, NULL)
        self.prev[ids[1:]] = ids[:-1]
        old_tail = int(hv[H_TAIL]) if hv[H_COUNT] > 0 else NULL
        first = int(ids_h[0])
        if old_tail != NULL:
            nodes.write_at(old_tail, DATA_WORDS, first)
            self.prev[first] = old_tail
        else:
            hv[H_HEAD] = first
            self.prev[first] = NULL
        hv[H_TAIL] = ids_h[-1]
        hv[H_COUNT] += m
        hv[H_FLAG] = 1
        if self.mode == "full":
            nodes.write_at(at[1:], DATA_WORDS + 1, ids[:-1])
            nodes.write_at(first, DATA_WORDS + 1, old_tail)
        # ring
        if self._r1 + m > self._ring.shape[0]:
            self._compact_ring()
        self._ring[self._r1:self._r1 + m] = ids
        self._r1 += m
        if self.snapshot:
            self._snap_dirty[self._r1 - m:self._r1] = True
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
        new_head = self.nodes.read_one(ids[-1], DATA_WORDS)
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
            self.nodes.write_at(new_head, DATA_WORDS + 1, NULL)
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
        nodes = self.nodes
        while pending:
            arr = self._dev(np.fromiter(pending, np.int64, len(pending)))
            ready = ~torch.isin(self.prev[arr], arr)
            batch = arr[ready]
            if batch.numel() == 0:   # adjacent chain; peel one end
                batch = arr[:1]
            nxt = nodes.read_at(batch, DATA_WORDS)
            prv = self.prev[batch]
            # within a round each node has a DISTINCT predecessor and
            # successor, so the scatters are conflict-free
            link = prv != NULL
            nodes.write_at(prv[link], DATA_WORDS, nxt[link])
            has_nx = nxt != NULL
            self.prev[nxt[has_nx]] = prv[has_nx]
            if self.mode == "full":
                nodes.write_at(nxt[has_nx], DATA_WORDS + 1, prv[has_nx])
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
        if self.snapshot:
            # every slot moved: the persisted mirror diverges wholesale
            self._snap_resync = True

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
        hit = torch.isin(window, ids)
        window[hit] = NULL
        if self.snapshot:
            self._snap_dirty[self._r0:self._r1] |= hit

    # ------------- traversal -------------
    def to_list(self) -> torch.Tensor:
        """List order from NEXT via the shared chain_order primitive."""
        return chain_order(self._next_col(), self.head, self.count,
                           method=self.chain_method)

    def order(self) -> torch.Tensor:
        """List order from the volatile ring (no chain traversal)."""
        window = self._ring[self._r0:self._r1]
        return window[window != NULL].clone()

    # ------------- incremental order snapshots (DESIGN.md §10) -------
    def _snap_emit(self):
        """Snapshot provider: mirror the ring slots dirtied since the last
        emit and seal one record line naming the window, the count and
        the generation the next commit seals.  Idempotent: nothing newly
        dirty and an unchanged window emit nothing."""
        out = []
        if self._snap_resync:
            self._snap_dirty.zero_()
            self._snap_dirty[self._r0:self._r1] = True
            self._snap_resync = False
        dirty = torch.nonzero(self._snap_dirty).squeeze(1)
        count = int(self.header.vol[0, H_COUNT])
        state = (self._r0, self._r1, count)
        if not dirty.numel() and state == self._snap_last:
            return out
        self._snap_last = state
        if dirty.numel():
            self.snapring.vol[dirty] = self._ring[dirty]
            out.append((self.snapring, dirty))
            self._snap_dirty.zero_()
        seq = self._snap_seq
        self._snap_seq += 1
        slot = seq % SNAP_SLOTS
        self.snaprec.write_row(slot, snap_record_pack(
            self.arena.generation + 1, seq, self._r0, self._r1, count))
        out.append((self.snaprec, np.asarray([slot], np.int64)))
        return out

    # ------------- crash / reconstruction -------------
    def reconstruct(self) -> None:
        """Reload the regions and rebuild all volatile redundancy from the
        persistent fields (paper §IV-C3)."""
        self.header.load()
        self.nodes.load()
        if self.snapshot:
            self.snapring.load()
            self.snaprec.load()
        rec.get("pstruct.dll")(self)

    def flush_stats(self) -> FlushStats:
        return self.arena.stats


def _snap_resume(d: DoublyLinkedList) -> None:
    """Provider state after recovery: resume the record sequence past
    every intact slot and re-mirror the whole window at the next drain
    (the rebuilt ring starts at slot 0)."""
    recs = snap_records(d.snaprec)
    d._snap_seq = (max(r[1] for r in recs) + 1) if recs else 0
    d._snap_dirty.zero_()
    d._snap_resync = True
    d._snap_last = None


def _snap_candidate(d: DoublyLinkedList, count: int
                    ) -> Optional[ChainSnapshot]:
    """Candidate order from the newest committed record: the persisted
    window's live slots, plus a walk along NEXT past the snapshot tail
    (the appends the record predates), minus any front overhang (pops
    since the record).  Every failure returns None; chain_order's verify
    pass is what makes adoption safe.

    The reference walks the suffix one ``int(nxt[cur])`` at a time; on
    the card that would be one device sync per hop, and after a torn
    newest record the suffix can be a whole batch.  The loaded NEXT
    column is copied to the host once and walked there instead.  A paged
    region walks it one ``read_one`` at a time, as the reference's paged
    walk does, faulting only the blocks it steps on."""
    best = newest_committed(d.snaprec)
    if best is None:
        return None
    _, _, r0, r1, _, _ = best
    if not (0 <= r0 <= r1 <= d.snapring.shape[0]):
        return None
    window = d.snapring.vol[r0:r1]
    base = window[window != NULL]
    if base.numel() == 0 or bool(((base < 0) | (base >= d.capacity)).any()):
        return None
    if getattr(d.nodes, "paged_active", False):
        def read_next(cur: int) -> int:
            return d.nodes.read_one(cur, DATA_WORDS)
    else:
        nxt = d._next_col().cpu().numpy()

        def read_next(cur: int) -> int:
            return int(nxt[cur])
    suffix = []
    cur = int(base[-1])
    while len(suffix) < count:
        nx = read_next(cur)
        if nx < 0 or nx >= d.capacity:
            break
        suffix.append(nx)
        cur = nx
    cand = torch.cat([base, d._dev(suffix)]) if suffix else base
    if cand.numel() < count:
        return None
    return ChainSnapshot(cand[cand.numel() - count:], replayed=len(suffix))


def _gather_verify(nodes, head: int, count: int, cand: torch.Tensor,
                   n: int) -> bool:
    """``chain_order``'s snapshot verify, gathering the NEXT words of only
    the candidate rows through the block cache: on a paged arena the
    verify that makes adoption safe faults the working set, not the whole
    column."""
    if count is None or cand.numel() != count:
        return False
    if int(cand[0]) != int(head):
        return False
    if bool(((cand < 0) | (cand >= n)).any()):
        return False
    if count > 1 and not torch.equal(
            nodes.read_at(cand[:-1], DATA_WORDS), cand[1:]):
        return False
    return True


def _salvage_bad_rows(arena, region) -> np.ndarray:
    """Rows of a structure's primary region failing their sidecar
    checksums (empty when the arena carries no integrity layer): the
    salvage probe every reconstructor shares."""
    if not arena.integrity:
        return np.empty(0, np.int64)
    return arena.verify_region(region)


def _image_col(region, col: int, dev) -> torch.Tensor:
    """Column ``col`` of a region's committed persistent image (with the
    authoritative shadow bank's rows) as an int64 tensor on ``dev`` (one
    host-to-device copy)."""
    return torch.from_numpy(np.ascontiguousarray(
        region.arena._pimage(region, copy=False)[:, col]).astype(
            np.int64)).to(dev)


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
        if d.snapshot:
            _snap_resume(d)
        return {"mode": d.mode, "count": 0}
    # The committed COUNT bounds the walk: rows appended by a torn epoch
    # (data flushed, header not) stay unreachable.  It also bounds the
    # snapshot verify (the host primitive's semantics), so a torn epoch
    # that linked the last committed node onward still adopts.
    method = d.chain_method
    salvage = d.arena._salvage
    bad = _salvage_bad_rows(d.arena, d.nodes) if salvage \
        else np.empty(0, np.int64)
    dropped = 0
    snap = None
    if bad.size:
        # salvage: corrupt rows terminate the chain; the list is the
        # longest committed prefix whose every node verifies, ranked over
        # the committed image's NEXT column
        bad_t = torch.from_numpy(bad).to(dev)
        order = salvage_prefix(_image_col(d.nodes, DATA_WORDS, dev), head,
                               count, bad_t, method=method)
        dropped = count - int(order.shape[0])
        if order.numel() == 0:
            hv[:] = 0
            hv[H_HEAD] = NULL
            hv[H_TAIL] = NULL
            d._free = []
            d._r0 = d._r1 = 0
            d.header.write_row(0, hv)
            if d.snapshot:
                _snap_resume(d)
            return {"mode": d.mode, "count": 0, "quarantined": True,
                    "quarantined_rows": dropped}
        count = int(order.shape[0])
        hv[H_COUNT] = count
    else:
        snap = _snap_candidate(d, count) if d.snapshot else None
        if getattr(d.nodes, "paged_active", False) and snap is not None \
                and _gather_verify(d.nodes, head, count, snap.candidate,
                                   d.capacity):
            # the paged fast path: adopt the verified snapshot without
            # reading the whole NEXT column
            snap.outcome = "snapshot"
            order = snap.candidate.to(torch.int64).clone()
        else:
            try:
                order = chain_order(d._next_col(), head, count,
                                    method=method, snapshot=snap)
            except (RuntimeError, ValueError) as e:
                if salvage:
                    # a structurally impossible chain (cycle, short walk)
                    # with no sidecar to localize it: the whole structure
                    # is untrusted
                    raise CorruptLineError(
                        d.nodes.name, np.empty(0, np.int64),
                        detail=f"chain rebuild: {e}") from e
                raise
    d.prev[order[1:]] = order[:-1]
    hv[H_TAIL] = int(order[-1])
    live = torch.zeros(d.capacity, dtype=torch.bool, device=dev)
    live[order] = True
    # quarantined rows are neither live nor reusable: kept out of the free
    # list, no later insert resurrects the rot
    if bad.size:
        live[torch.from_numpy(bad[bad < d.capacity]).to(dev)] = True
    # fresh-water mark: everything at/above the max live id is fresh
    fresh = int(order.max()) + 1
    hv[H_FRESH] = fresh
    d._free = torch.nonzero(~live[:fresh]).squeeze(1).tolist()
    d._ring = torch.empty(d.capacity * 2, dtype=torch.int64, device=dev)
    d._ring[:count] = order
    d._r0, d._r1 = 0, count
    if d.mode == "full":
        # pure-reconstructor PREV rebuild stays UNMARKED (derivable); on a
        # paged arena these rows pin their blocks until a later drain
        d.nodes.write_at(order[1:], DATA_WORDS + 1, order[:-1])
        d.nodes.write_at(order[:1], DATA_WORDS + 1, NULL)
    d.header.write_row(0, hv)
    detail = {"mode": d.mode, "count": count,
              "chain": chain_method(d.capacity, count, method)}
    if dropped:
        detail.update(degraded=True, quarantined_rows=dropped,
                      chain="salvage")
    if d.snapshot:
        # "snapshot" (seeded, suffix-only walk) or the fallback rank the
        # verify pass forced; replayed = rows walked
        if snap is not None:
            detail["chain"] = snap.outcome
        detail["replayed"] = snap.replayed if snap is not None \
            and snap.outcome == "snapshot" else count
        _snap_resume(d)
    return detail


def order_from_next(nxt, head: int, count: int) -> torch.Tensor:
    """The reference's alias for the shared primitive (core.recovery)."""
    return chain_order(torch.as_tensor(nxt, dtype=torch.int64), head, count)
