"""Paged regions and the block cache (DESIGN.md §12), the port of
``repro.core.paging``.

A resident region keeps one full-shape volatile tensor on the arena's
device.  A paged region keeps a DEVICE BLOCK POOL instead: one growable
tensor of ``slots x block_rows`` rows in the region's dtype, of which each
resident block holds one slot, faulted in on demand through the arena's
LRU ``BlockCache``.  The cache's bookkeeping stays on the host, as the
reference keeps it: the LRU order over ``(region, block)``, the counters
(``faults``, ``hits``, ``evictions``, ``spills``, ``over_budget``,
``resident_bytes``, ``peak_resident_bytes``), the per-row dirty bits (1 B
a row), and each region's block table (block id -> slot), with a host
list of free slots.

* A FAULT assembles the block on the host from its authoritative
  persistent bytes: the home rows with the authoritative shadow bank's
  rows over them, then the in-flight target bank's (newer wins), and
  verifies it against its sidecar checksums (``CorruptLineError`` BEFORE
  admission).  Every block one accessor call misses is staged in one
  pinned buffer, sent up in ONE upload and seated by ONE ``scatter_rows_``
  launch into the pool's ``(slots, block_rows * rowbytes)`` byte view
  (``_BlockPool.fault_batches`` counts those batches).  A failed upload or
  launch raises; nothing falls back to a resident copy.
* A CLEAN block is pure cache: eviction frees its slot.  A DIRTY block
  (rows written by an accessor and not yet drained) is PINNED; the epoch
  drain is its write-back (``_note_flushed``), in both commit modes.
* Blocks are admitted one at a time in the reference's order, and each
  admission may evict to the budget, so every counter follows the
  reference's sequence of accessor calls.  The device slots of blocks
  evicted inside one call (or one drain) are released only after that
  call has read or written them (``BlockCache.holding``): a slot is never
  reused while a gather still reads it.
* A read touching more blocks than the cache holds (a whole column,
  ``read_col``, among them) goes in chunks of at most the cache's
  capacity, each chunk's slots released after its gather, so the pool
  stays within about twice the budget whatever the region's size.
* ``crash`` disarms the pool: reads see zeros until ``load``/``reopen``
  re-arms it.  A consumer of the full ``.vol`` tensor triggers a one-shot
  SPILL (counted in ``BlockCache.spills``): the region materializes on the
  device and leaves paged mode until the next load.

The write set's drain gathers a paged region's rows from its pool by
translated index, through the same one grouped ``pack_rows`` launch as
resident regions (``WriteSet.gather``): the cache bookkeeping of the drain
runs first, region by region in the reference's order
(``drain_positions``), faulting any block that is not resident.
"""
from __future__ import annotations

import contextlib
import heapq
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.arena import (CorruptLineError, Region, ShardedRegion,
                                    sidecar_checksums)
from repro_torch.core.writeset import host_rows
from repro_torch.kernels.pack_flush import scatter_rows_

__all__ = ["BlockCache", "PagedRegion", "PagedShardedRegion",
           "drain_positions"]


class BlockCache:
    """Per-arena LRU over (region, block id) with dirty-block pinning, the
    reference's bookkeeping exactly.

    ``cache_blocks * block_bytes`` is the residency budget; admission past
    it evicts clean unpinned blocks from the LRU end.  When every resident
    block is pinned the cache stays over budget (counted in
    ``over_budget``) rather than drop unflushed rows.  All block operations
    run under one reentrant lock.

    The victim search differs in its data structure only: each admission
    and hit stamps the block with a rising sequence number (the LRU order
    of the reference's ``OrderedDict``, kept per region in a numpy array),
    and a heap over the unpinned blocks' stamps yields the least recently
    used unpinned block, which is the one the reference's scan from the
    LRU end finds; pinned blocks leave the heap, and re-enter it when the
    drain unpins them.  With thousands of pinned blocks the reference's
    scan costs a pass over them per admission, and a run of hits is
    booked in one vectorized step.

    Besides the reference's counters it keeps the device side's own:
    ``pool_bytes`` (the regions' pools now) and ``peak_pool_bytes``."""

    def __init__(self, block_bytes: int = 4096, cache_blocks: int = 1024):
        self.block_bytes = int(block_bytes)
        self.cache_blocks = int(cache_blocks)
        self.capacity_bytes = self.block_bytes * self.cache_blocks
        self.lock = threading.RLock()
        self._lru: Dict = {}                       # (name, bid) -> region
        self._seq = 0
        # (stamp, name, bid) of the unpinned resident blocks; built at the
        # first eviction, kept up to date after it
        self._heap: Optional[List] = None
        self.faults = 0
        self.hits = 0
        self.evictions = 0
        self.spills = 0
        self.over_budget = 0
        self.resident_bytes = 0
        self.peak_resident_bytes = 0
        self.pool_bytes = 0
        self.peak_pool_bytes = 0
        # slots of blocks dropped while a call holds the pools: released
        # when the outermost hold ends
        self._hold = 0
        self._held: List = []

    # All methods assume self.lock is held by the calling accessor.
    def hit_many(self, region, bids: np.ndarray) -> None:
        """Hits on the resident blocks ``bids``, in order."""
        k = bids.size
        self.hits += k
        region._stamps[bids] = np.arange(self._seq + 1, self._seq + 1 + k)
        self._seq += k
        if self._heap is not None:
            self.push_many(region, bids[region._pins[bids] == 0])

    def admit(self, region, bid: int, nbytes: int) -> None:
        self.faults += 1
        key = (region.name, bid)
        self._lru[key] = region
        self._seq += 1
        region._stamps[bid] = self._seq
        if not region._block_pinned(bid):
            self._push(region, bid)
        self.resident_bytes += nbytes
        # the peak includes the admit-then-evict transient
        if self.resident_bytes > self.peak_resident_bytes:
            self.peak_resident_bytes = self.resident_bytes
        self._evict_to_budget(protect=key)

    def forget(self, region, bid: int, nbytes: int) -> None:
        self._lru.pop((region.name, bid), None)
        self.resident_bytes -= nbytes

    def _push(self, region, bid: int) -> None:
        """A resident block is (again) unpinned at its current stamp."""
        if self._heap is None:
            return
        heapq.heappush(self._heap, (int(region._stamps[bid]), region.name,
                                    bid))
        self._compact()

    def push_many(self, region, bids: np.ndarray) -> None:
        """``_push`` of each of the resident blocks ``bids``."""
        if self._heap is None or bids.size == 0:
            return
        heap, name, push = self._heap, region.name, heapq.heappush
        for st, bid in zip(region._stamps[bids].tolist(), bids.tolist()):
            push(heap, (st, name, bid))
        self._compact()

    def _compact(self, force: bool = False) -> None:
        if force or len(self._heap) > 4 * len(self._lru) + 64:
            # drop the stale entries
            self._heap = [(int(r._stamps[b]), name, b)
                          for (name, b), r in self._lru.items()
                          if not r._block_pinned(b)]
            heapq.heapify(self._heap)

    def _evict_to_budget(self, protect=None) -> None:
        # `protect` is the block being admitted right now: its caller is
        # about to read or write it
        if self.resident_bytes > self.capacity_bytes and self._heap is None:
            self._compact(force=True)
        while self.resident_bytes > self.capacity_bytes:
            victim, kept = None, []
            while self._heap:
                entry = heapq.heappop(self._heap)
                seq, name, bid = entry
                key = (name, bid)
                region = self._lru.get(key)
                if region is None or region._stamps[bid] != seq:
                    continue                   # stale: used since, or gone
                if region._block_pinned(bid):
                    continue                   # re-pushed when unpinned
                if key == protect:
                    kept.append(entry)
                    continue
                victim = (region, bid)
                break
            for entry in kept:
                heapq.heappush(self._heap, entry)
            if victim is None:
                self.over_budget += 1
                return
            victim[0]._drop_block(victim[1])
            self.evictions += 1

    def drop_clean(self) -> int:
        """Evict EVERY clean unpinned block (the memory-pressure hook);
        returns the number of blocks dropped."""
        with self.lock:
            victims = [(region, bid)
                       for (name, bid), region in self._lru.items()
                       if not region._block_pinned(bid)]
            for region, bid in victims:
                region._drop_block(bid)
                self.evictions += 1
            return len(victims)

    def reset_peak(self) -> None:
        """Re-anchor both peaks to the current residency (phase-scoped
        peak measurement)."""
        with self.lock:
            self.peak_resident_bytes = self.resident_bytes
            self.peak_pool_bytes = self.pool_bytes

    # -- the device side ------------------------------------------------
    @contextlib.contextmanager
    def holding(self):
        """Defer the release of every slot dropped inside the block until
        the outermost hold ends: the call's gathers may still read it."""
        with self.lock:
            self._hold += 1
            try:
                yield self
            finally:
                self._hold -= 1
                if self._hold == 0:
                    held, self._held = self._held, []
                    for region, slot, gen in held:
                        if gen == region._gen:
                            region._free.append(slot)

    def _pool_delta(self, nbytes: int) -> None:
        self.pool_bytes += nbytes
        if self.pool_bytes > self.peak_pool_bytes:
            self.peak_pool_bytes = self.pool_bytes


def _sorted_unique(x: np.ndarray) -> np.ndarray:
    """``np.unique(x)``, without its sort when ``x`` already is."""
    if x.size < 2 or (x[1:] > x[:-1]).all():
        return x
    return np.unique(x)


def _runs(x: np.ndarray):
    """The distinct values of the sorted ``x`` and how often each occurs."""
    head = np.flatnonzero(np.concatenate(([True], x[1:] != x[:-1])))
    return x[head], np.diff(np.append(head, x.size))


class _BlockPool:
    """The demand-faulted block pool PagedRegion and PagedShardedRegion
    share.  Subclasses provide ``_assemble_rows(rows)`` and
    ``_integ_ref_rows(rows)`` (the authoritative fault reads of sorted
    global rows), ``_masked_rows(rows)`` (which rows a shadow bank remaps)
    and ``_synth(lo, hi)`` (the media read stall of one block)."""

    is_paged = True
    # fault batches seated (one scatter_rows_ launch each), summed over
    # every pool: a run sets it to 0 and compares it with the launches
    fault_batches = 0

    def _init_vol(self) -> None:
        self._cache: BlockCache = self.arena.cache
        self._block_rows = max(1, self._cache.block_bytes //
                               max(self.rowbytes, 1))
        self._n_blocks = -(-self.shape[0] // self._block_rows)
        # the block table: each block's pool slot (-1: not resident), and
        # its last use (the cache's LRU stamp)
        self._slot_of = np.full(self._n_blocks, -1, np.int64)
        self._stamps = np.zeros(self._n_blocks, np.int64)
        self._gone: set = set()                  # evicted in this _touch
        # one dirty bit per ROW; a set bit's block is resident.  _pins
        # counts each block's set bits, so a pin check is O(1)
        self._dirty_rows = np.zeros(self.shape[0], bool)
        self._pins = np.zeros(self._n_blocks, np.int64)
        self._spill: Optional[torch.Tensor] = None
        # crash() disarms faulting: reads see zeros until load()
        self._armed = True
        self._pool: Optional[torch.Tensor] = None
        self._slots = 0
        self._free: List[int] = []
        self._staged: List = []                  # (slot, host block)
        self._admitted: List[int] = []           # the last _touch's faults
        self._gen = 0                            # bumped by every reset

    # -- pool state --------------------------------------------------------
    @property
    def paged_active(self) -> bool:
        """False once a full-``.vol`` consumer forced a spill."""
        return self._spill is None

    @property
    def total_blocks(self) -> int:
        return self._n_blocks

    @property
    def vol(self) -> torch.Tensor:
        # the full tensor: the fallback for unconverted consumers, which
        # materializes once and leaves paged mode
        if self._spill is None:
            self._materialize_spill()
        return self._spill

    @vol.setter
    def vol(self, value) -> None:
        self._spill = value

    def _block_nbytes(self, bid: int) -> int:
        lo = bid * self._block_rows
        return (min(lo + self._block_rows, self.shape[0]) - lo) \
            * self.rowbytes

    def _reset_blocks(self, armed: bool = True) -> None:
        with self._cache.lock:
            self._drop_all()
            self._spill = None
            self._armed = armed

    def _drop_all(self) -> None:
        for bid in np.flatnonzero(self._slot_of >= 0).tolist():
            self._cache.forget(self, bid, self._block_nbytes(bid))
        self._slot_of[:] = -1
        self._dirty_rows[:] = False
        self._pins[:] = 0
        self._staged = []
        self._free = []
        if self._pool is not None:
            self._cache._pool_delta(-self._pool_nbytes())
        self._pool = None
        self._slots = 0
        self._gen += 1

    def _block_pinned(self, bid: int) -> bool:
        return self._pins[bid] > 0

    def _pin(self, rows: np.ndarray) -> None:
        """Set the dirty bits of ``rows``."""
        new = rows[~self._dirty_rows[rows]]
        if new.size == 0:
            return
        new = _sorted_unique(new)
        self._dirty_rows[new] = True
        bids, cnt = _runs(new // self._block_rows)
        self._pins[bids] += cnt

    def _unpin(self, rows: np.ndarray) -> None:
        """Clear the dirty bits of ``rows``; a resident block left with
        none becomes evictable."""
        old = rows[self._dirty_rows[rows]]
        if old.size == 0:
            return
        old = _sorted_unique(old)
        self._dirty_rows[old] = False
        bids, cnt = _runs(old // self._block_rows)
        self._pins[bids] -= cnt
        if self._cache._heap is not None:
            freed = bids[self._pins[bids] == 0]
            self._cache.push_many(self, freed[self._slot_of[freed] >= 0])

    def _drop_block(self, bid: int) -> None:
        slot = int(self._slot_of[bid])
        if slot < 0:
            return
        self._slot_of[bid] = -1
        self._gone.add(bid)
        self._cache.forget(self, bid, self._block_nbytes(bid))
        if self._cache._hold:
            self._cache._held.append((self, slot, self._gen))
        else:
            self._free.append(slot)

    # -- the device pool ---------------------------------------------------
    def _pool_nbytes(self) -> int:
        return self._slots * self._block_rows * self.rowbytes

    def _take_slot(self) -> int:
        if not self._free:
            self._grow()
        return self._free.pop()

    def _grow(self) -> None:
        """Double the pool (up to twice the cache's budget in blocks, then
        past it only as far as pinned blocks force), keeping every slot's
        rows."""
        old = self._slots
        cap = 2 * max(1, self._cache.cache_blocks)
        new = min(max(2 * old, 64), max(cap, old + 1)) if old < cap \
            else 2 * old
        new = max(new, old + 1)
        br = self._block_rows
        pool = torch.empty((new * br,) + self.shape[1:], dtype=self.tdtype,
                           device=self.arena.device)
        if self._pool is not None:
            pool[:old * br] = self._pool
            self._cache._pool_delta(-self._pool_nbytes())
        self._pool = pool
        self._slots = new
        self._cache._pool_delta(self._pool_nbytes())
        # lowest slots first
        self._free = list(range(new - 1, old - 1, -1)) + self._free

    def _pool_rows(self) -> torch.Tensor:
        """The pool as (slots * block_rows, words): a grouped gather's
        source."""
        return self._pool.view(self._slots * self._block_rows, -1)

    def _seat(self) -> None:
        """Seat every block staged since the last seat: one pinned buffer
        (the slots' ids, then each block's bytes, a partial or disarmed
        block zero-padded), ONE upload, ONE ``scatter_rows_`` launch."""
        staged, self._staged = self._staged, []
        if not staged:
            return
        k = len(staged)
        width = self._block_rows * self.rowbytes
        head = -(-4 * k // 16) * 16
        dev = self.arena.device
        if dev.type == "cpu":
            buf = torch.zeros(head + k * width, dtype=torch.uint8)
        else:
            buf = torch.empty(head + k * width, dtype=torch.uint8,
                              pin_memory=True)
        host = buf.numpy()
        host[:head].view(np.int32)[:k] = [slot for slot, _ in staged]
        blocks = host[head:].reshape(k, width)
        for i, (_, blk) in enumerate(staged):
            if blk is None:
                blocks[i] = 0
                continue
            raw = np.ascontiguousarray(blk).reshape(-1).view(np.uint8)
            blocks[i, :raw.size] = raw
            if raw.size < width:
                blocks[i, raw.size:] = 0
        up = buf if dev.type == "cpu" else buf.to(dev, non_blocking=True)
        dst = self._pool.view(-1).view(torch.uint8).view(self._slots, width)
        scatter_rows_(dst, up[head:].view(k, width),
                      up[:head].view(torch.int32)[:k])
        _BlockPool.fault_batches += 1

    # -- bookkeeping ---------------------------------------------------------
    def _pre_assemble(self, bids: np.ndarray):
        """Host assembly and verification of the blocks ``bids`` (sorted)
        in one vectorized pass: ``{bid: (block, bad rows or None)}``."""
        br, n = self._block_rows, self.shape[0]
        lo = bids * br
        hi = np.minimum(lo + br, n)
        sizes = hi - lo
        rows = np.repeat(lo - np.concatenate(([0], np.cumsum(sizes)[:-1])),
                         sizes) + np.arange(int(sizes.sum()))
        data = self._assemble_rows(rows)
        bad = None
        sc = self._integ
        if sc is not None:
            ref = self._integ_ref_rows(rows)
            ck = sidecar_checksums(data, sc.shape[1])
            bad = ((ref != 0) & (ck != ref)).any(axis=1)
        out, pos = {}, 0
        for b, m in zip(bids.tolist(), sizes.tolist()):
            badrows = None
            if bad is not None and bad[pos:pos + m].any():
                badrows = rows[pos:pos + m][bad[pos:pos + m]]
            out[b] = (data[pos:pos + m], badrows)
            pos += m
        return out

    def _touch(self, bids: np.ndarray) -> np.ndarray:
        """The reference's ``_get_block`` for each of the sorted unique
        ``bids`` in order (a hit, or a fault that assembles, verifies,
        stages and admits the block); returns each block's slot.  A run of
        hits is booked in one step.  The caller holds the cache's lock and
        a hold, and seats afterwards."""
        n = bids.size
        slots = self._slot_of[bids]
        self._admitted = []
        self._gone = set()
        misses = np.flatnonzero(slots < 0)
        pre = self._pre_assemble(bids[misses]) \
            if self._armed and misses.size else None
        i, m = 0, 0
        try:
            while i < n:
                while m < misses.size and misses[m] < i:
                    m += 1
                j = int(misses[m]) if m < misses.size else n
                if j > i and self._gone:
                    # a block this call's faults evicted is a miss now
                    hit = np.flatnonzero(np.isin(bids[i:j],
                                                 list(self._gone)))
                    if hit.size:
                        j = i + int(hit[0])
                if j > i:
                    run = bids[i:j]
                    slots[i:j] = self._slot_of[run]
                    self._cache.hit_many(self, run)
                    i = j
                    if i == n:
                        break
                slots[i] = self._fault(int(bids[i]), pre)
                i += 1
        except CorruptLineError:
            self._seat()
            raise
        return slots

    def _fault(self, bid: int, pre) -> int:
        """Assemble (or take from ``pre``), verify, stage and admit one
        block; returns its slot."""
        blk = None
        if self._armed:
            got = pre.get(bid) if pre is not None else None
            if got is None:                # evicted earlier in this call
                got = self._pre_assemble(np.asarray([bid]))[bid]
            blk, badrows = got
            lo = bid * self._block_rows
            self._synth(lo, lo + blk.shape[0])
            if badrows is not None:
                # rejected BEFORE admission: no consumer reads rotted
                # bytes through the cache
                raise CorruptLineError(self.name, badrows,
                                       detail="paged fault verification")
        slot = self._take_slot()
        self._slot_of[bid] = slot
        self._admitted.append(bid)
        self._staged.append((slot, blk))
        self._cache.admit(self, bid, self._block_nbytes(bid))
        return slot

    def _block_index(self, rows: np.ndarray):
        """The blocks ``rows`` touch, ascending, and each row's index into
        them."""
        bids = rows // self._block_rows
        if rows.size > 1 and (rows[1:] > rows[:-1]).all():
            # sorted unique rows (every drain's): blocks without a sort
            head = np.empty(bids.size, bool)
            head[0] = True
            np.not_equal(bids[1:], bids[:-1], out=head[1:])
            return bids[head], np.cumsum(head) - 1
        return np.unique(bids, return_inverse=True)

    def _positions(self, rows: np.ndarray) -> np.ndarray:
        """Bookkeeping of one accessor call over ``rows`` (host int64):
        every touched block in ascending order, then each row's pool
        position."""
        br = self._block_rows
        ub, inv = self._block_index(rows)
        slots = self._touch(ub)
        return slots[inv] * br + rows % br

    def _read(self, rows: np.ndarray, col) -> torch.Tensor:
        """``pool[positions of rows, col]`` for one accessor call.  A call
        touching more blocks than the cache holds goes in chunks of its
        capacity in blocks, in the same order, each chunk's evicted slots
        released after its gather: the pool stays within twice the
        budget."""
        br = self._block_rows
        ub, inv = self._block_index(rows)
        step = max(1, self._cache.cache_blocks)
        if ub.size <= step:
            with self._cache.holding():
                slots = self._touch(ub)
                self._seat()
                return self._pool[self._idx(slots[inv] * br + rows % br),
                                  col]
        order = np.argsort(inv, kind="stable")
        cuts = np.searchsorted(inv[order], np.arange(0, ub.size + step, step))
        out = None
        for c, c0 in enumerate(range(0, ub.size, step)):
            sel = order[cuts[c]:cuts[c + 1]]
            with self._cache.holding():
                slots = self._touch(ub[c0:c0 + step])
                self._seat()
                pos = slots[inv[sel] - c0] * br + rows[sel] % br
                got = self._pool[self._idx(pos), col]
                if out is None:
                    out = got.new_empty((rows.size,) + tuple(got.shape[1:]))
                out[self._idx(sel)] = got
        return out

    # -- row accessors (block-routed) --------------------------------------
    def read_rows(self, rows) -> torch.Tensor:
        rows = host_rows(rows)
        if self._spill is not None:
            return self._spill[self._idx(rows)]
        if rows.size == 0:
            return torch.empty((0,) + self.shape[1:], dtype=self.tdtype,
                               device=self.arena.device)
        return self._read(rows, slice(None))

    def read_at(self, rows, col) -> torch.Tensor:
        rows = host_rows(rows)
        if self._spill is not None:
            return self._spill[self._idx(rows), col]
        if rows.size == 0:
            return torch.empty((0,) + self.shape[1:], dtype=self.tdtype,
                               device=self.arena.device)[:, col]
        return self._read(rows, col)

    def read_one(self, row, col: int) -> int:
        row = int(row)
        if self._spill is not None:
            return int(self._spill[row, col])
        with self._cache.holding():
            bid, off = divmod(row, self._block_rows)
            slot = int(self._touch(np.asarray([bid], np.int64))[0])
            self._seat()
            return int(self._pool[slot * self._block_rows + off, col])

    def read_col(self, col) -> torch.Tensor:
        """A whole column through the cache (faulting every block, in
        chunks of the cache's capacity)."""
        if self._spill is not None:
            return self._spill[:, col]
        return self._read(np.arange(self.shape[0], dtype=np.int64), col)

    def write_rows(self, rows, vals) -> None:
        rows = host_rows(rows)
        if rows.size == 0:
            return
        if self._spill is not None:
            self._spill[self._idx(rows)] = self._val(vals)
            return
        with self._cache.holding():
            # dirty bits BEFORE the block loop: an admission may evict,
            # and an already-written block of this call must be pinned
            self._pin(rows)
            pos = self._positions(rows)
            self._seat()
            self._pool[self._idx(pos)] = self._val(vals)

    def write_at(self, rows, col, vals) -> None:
        rows = host_rows(rows)
        if rows.size == 0:
            return
        if self._spill is not None:
            self._spill[self._idx(rows), col] = self._val(vals)
            return
        with self._cache.holding():
            self._pin(rows)                   # pin before any admission
            pos = self._positions(rows)
            self._seat()
            self._pool[self._idx(pos), col] = self._val(vals)

    # -- write-back bookkeeping ----------------------------------------------
    def _note_flushed(self, rows: np.ndarray) -> None:
        """Rows persisted by the drain (home in barrier mode, the target
        bank's mirror in shadow mode; a refault sees both): their blocks
        become evictable."""
        if self._spill is not None:
            return
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        with self._cache.lock:
            self._unpin(rows)

    def _set_dirty(self, rows: np.ndarray) -> None:
        with self._cache.lock:
            self._pin(rows)

    def _note_persisted(self, rows: np.ndarray) -> None:
        """A direct (epoch-less) persist wrote these rows home: as durable
        as a flush EXCEPT where a shadow bank still remaps the row, whose
        refault would overlay the stale mirror, so those stay dirty."""
        if self._spill is not None:
            return
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        with self._cache.lock:
            masked = self._masked_rows(rows)
            if masked.any():
                self._set_dirty(rows[masked])
            self._note_flushed(rows[~masked])

    def _note_persisted_range(self, lo: int, hi: int) -> None:
        self._note_persisted(np.arange(lo, hi, dtype=np.int64))

    # -- spill fallback ----------------------------------------------------
    def _materialize_spill(self) -> None:
        with self._cache.lock:
            if self._spill is not None:
                return
            dev = self.arena.device
            full = torch.from_numpy(
                self._assemble_rows(np.arange(self.shape[0], dtype=np.int64))
                if self._armed else np.zeros(self.shape, self.dtype)).to(dev)
            if self._armed:
                self._synth(0, self.shape[0])
            # clean resident blocks equal the assembly; only dirty rows
            # hold newer (unflushed) state
            dirty = np.nonzero(self._dirty_rows)[0]
            if dirty.size:
                br = self._block_rows
                slots = self._slot_of[dirty // br]
                full[self._idx(dirty)] = self._pool[self._idx(
                    slots * br + dirty % br)]
            self._cache.spills += 1
            self._drop_all()
            self._spill = full


class PagedRegion(_BlockPool, Region):
    """One arena's paged region: blocks assemble from the home rows and
    the arena's two shadow banks."""

    def _masked_rows(self, rows: np.ndarray) -> np.ndarray:
        out = np.zeros(rows.size, bool)
        a = self.arena
        if a.commit_mode != "shadow":
            return out
        for bank in (0, 1):
            mask = a._shadow_masks[bank].get(self.name)
            if mask is not None:
                out |= mask[rows]
        return out

    def _overlay(self, region, rows: np.ndarray, img: np.ndarray) -> None:
        """Authority bank, then the in-flight target bank (newer wins)."""
        a = self.arena
        if a.commit_mode != "shadow":
            return
        auth = a._shadow_auth_bank
        for bank in (auth, 1 - auth):
            mask = a._shadow_masks[bank].get(region.name)
            if mask is not None:
                hit = np.nonzero(mask[rows])[0]
                if hit.size:
                    img[hit] = a._shadow_mirror(region, bank)[rows[hit]]

    def _assemble_rows(self, rows: np.ndarray) -> np.ndarray:
        img = self._pview()[rows]
        self._overlay(self, rows, img)
        return img

    def _integ_ref_rows(self, rows: np.ndarray) -> np.ndarray:
        sc = self._integ
        ref = sc._pview()[rows]
        self._overlay(sc, rows, ref)
        return ref

    def _synth(self, lo: int, hi: int) -> None:
        self.arena.synth_read((hi - lo) * self.rowbytes)

    def load(self) -> None:
        """Lazy reload: drop every block; the post-crash working set
        faults back in on demand."""
        self._reset_blocks()

    def _crash_reset(self) -> None:
        self._reset_blocks(armed=False)


class PagedShardedRegion(_BlockPool, ShardedRegion):
    """A sharded paged region: ONE block pool at the sharded level; each
    fault gathers its rows from the owning shards' slices and lays each
    shard's own bank overlays over them with LOCAL row masks."""

    def _masked_rows(self, rows: np.ndarray) -> np.ndarray:
        out = np.zeros(rows.size, bool)
        sh = self.shard_of[rows]
        for s in np.unique(sh):
            shard = self.arena.shards[s]
            if shard.commit_mode != "shadow":
                continue
            pos = np.nonzero(sh == s)[0]
            lr = self.local_of[rows[pos]]
            for bank in (0, 1):
                mask = shard._shadow_masks[bank].get(self.name)
                if mask is not None:
                    out[pos] |= mask[lr]
        return out

    def _gather_shards(self, region, rows: np.ndarray) -> np.ndarray:
        out = np.empty((rows.size,) + region.shape[1:], region.dtype)
        sh = region.shard_of[rows]
        for s in np.unique(sh):
            pos = np.nonzero(sh == s)[0]
            sl = region.slices[s]
            lr = region.local_of[rows[pos]]
            sub = sl._pview()[lr]
            shard = self.arena.shards[s]
            if shard.commit_mode == "shadow":
                auth = shard._shadow_auth_bank
                for bank in (auth, 1 - auth):
                    mask = shard._shadow_masks[bank].get(region.name)
                    if mask is not None:
                        hit = np.nonzero(mask[lr])[0]
                        if hit.size:
                            sub[hit] = shard._shadow_mirror(
                                sl, bank)[lr[hit]]
            out[pos] = sub
        return out

    def _assemble_rows(self, rows: np.ndarray) -> np.ndarray:
        return self._gather_shards(self, rows)

    def _integ_ref_rows(self, rows: np.ndarray) -> np.ndarray:
        return self._gather_shards(self._integ, rows)

    def _synth(self, lo: int, hi: int) -> None:
        if not self.arena.synth_line_ns:
            return
        sh = self.shard_of[lo:hi]
        for s in np.unique(sh):
            self.arena.shards[s].synth_read(
                int(np.count_nonzero(sh == s)) * self.rowbytes)

    def load(self, concurrency: int = 1) -> None:
        self._reset_blocks()

    def load_shard(self, s: int) -> None:
        # reload is discard-and-fault; idempotent across the per-shard loop
        self._reset_blocks()

    def _crash_reset(self) -> None:
        self._reset_blocks(armed=False)


# ----------------------------------------------------------------------
# The drain's bookkeeping
# ----------------------------------------------------------------------

def drain_positions(script) -> Dict:
    """Run a drain's cache bookkeeping, ``script``, in the reference's
    order, and return each paged region's pool positions: ``{region:
    (sorted rows, positions)}``, each row at the position its FIRST read
    found it.  The caller holds the cache (``BlockCache.holding``) until
    it has gathered from those positions.

    ``script`` is a list of ``("read", region, rows)`` (the reference's
    ``_gather``), ``("flushed", region, rows)`` and ``("persisted",
    region, rows)``; ops on resident or spilled regions are no-ops.  A
    block faulted again after an earlier read of this drain evicted it
    takes the values the earlier read saw for those rows (the reference's
    refault reads them back from where the drain has written them): they
    are copied from their first positions once every fault is seated."""
    first: Dict = {}
    copies: List = []
    for op, region, rows in script:
        if not getattr(region, "paged_active", False):
            continue
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            continue
        if op == "flushed":
            region._note_flushed(rows)
            continue
        if op == "persisted":
            region._note_persisted(rows)
            continue
        pos = region._positions(rows)
        seen = first.get(region)
        new = region._admitted
        if seen is not None and new:
            br = region._block_rows
            srows = np.concatenate(seen[0])
            spos = np.concatenate(seen[1])
            hit = np.isin(srows // br, new)
            if hit.any():
                r = srows[hit]
                slots = region._slot_of[r // br]
                copies.append((region, spos[hit], slots * br + r % br))
        if seen is None:
            seen = first[region] = ([], [])
        seen[0].append(rows)
        seen[1].append(pos)
    for region in first:
        region._seat()
    for region, src, dst in copies:
        region._pool[region._idx(dst)] = \
            region._pool[region._idx(src)]
    out = {}
    for region, (rs, ps) in first.items():
        if len(rs) == 1:
            out[region] = (rs[0], ps[0])
            continue
        rows, idx = np.unique(np.concatenate(rs), return_index=True)
        out[region] = (rows, np.concatenate(ps)[idx])
    return out
