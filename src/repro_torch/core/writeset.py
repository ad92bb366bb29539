"""Write-set / epoch-flush layer (paper §V-E), the port of
``repro.core.writeset.WriteSet``.

Structures mark dirty rows inside an epoch (``Arena.epoch()``); when the
outermost epoch closes (or ``Arena.commit`` runs) the write set flushes
ONCE: rows marked several times are deduplicated, adjacent dirty rows
coalesce into distinct 64 B lines once across the whole operation, and
data regions flush before metadata (header) regions.  ``flush(
include_meta=False)`` drops the metadata marks: the crash point the
recovery tests inject.

The bookkeeping (row sets, line counts) is host numpy, the reference's own
arithmetic, so the accounting matches it exactly.  The row DATA stays on
the arena's device until the drain.  A drain first plans both barrier
phases on the host (which regions, their unique rows, the line costs),
then gathers every row it will write, data and metadata phase alike, in
ONE grouped gather (``WriteSet.gather``): the host writes the indices
into a pinned buffer and ``pack_rows_grouped_host`` packs every region's
rows into one staging buffer in pinned host memory, the kernel reading
the indices and writing the rows directly over the bus (one launch for
up to 64 regions; no index upload, no device staging buffer and no
download: no copy call, one launch and one synchronize, which precedes
the host's reads; PERF.md).  Then,
phase by phase in the reference's order, it writes the rows into the
persistent image, accounts them and fences.  Gathering both phases at
once is safe: nothing writes the volatile tensors between the two
phases of one drain.  The reference's ``Arena(pack_flush_rows=N)`` path
is here always on, whatever N (the arenas keep the value for the
reference's argument order), and unlike the reference there is no silent
fallback: a failed kernel raises.

Every flush first asks the arena's order-snapshot providers for their
dirty snapshot rows (``_drain_snapshots``), at every drain and not only
at commits.  Snapshot rows ride the same gather as data rows, flush in
the metadata phase, and stay out of the ``marks`` / ``dedup_rows`` /
``saved_lines`` ledger: their lines land in
``FlushStats.snapshot_lines``.  Request-journal rings (``.jrnl``) stay
off that ledger too; their lines land in ``FlushStats.journal_lines``.

Integrity sidecars ride the drain (DESIGN.md §13): as a phase writes a
covered region's rows home, it checksums the same staged host rows
(``Arena._integrity_home``), before the next gather reuses the staging
buffer, and writes the checksums into the sidecar's image in the same
phase, under the same fence.  The sidecars' volatile tensors are brought
up to date once per drain, by one host-to-device copy of every sidecar
row the drain wrote (``seat_sidecars``); sidecar rows are never marked.

On a shadow arena (DESIGN.md §9) a drain is ONE unordered phase
(``_flush_shadow``): the committed bank folds home first, then the same
one grouped gather stages every region's rows, fresh and rewritten
alike, and the host writes the fresh rows (``mark(fresh=True)``, and a
row marked both ways counts as rewritten) home with their checksums and
the rest into the target bank's mirrors (``Arena._shadow_write``), their
checksums into the sidecars' mirrors of the same bank.  No fence: the
commit's flip is the one ordering point.  A sharded shadow drain keeps the
one gather across every shard (``ShardedWriteSet._flush_shadow``).

Paged regions (DESIGN.md §12) ride the same one gather: the drain first
runs its cache bookkeeping in the reference's order (each region's gather,
then its ``_note_flushed``; a direct persist's ``_note_persisted``; the
second gather of a covered rewrite), faulting what is not resident
(``core/paging.drain_positions``), then gathers the region's rows from its
block pool by translated index.  The drain IS the dirty blocks'
write-back.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.pack_flush import (group_layout, pack_rows,
                                            pack_rows_grouped,
                                            pack_rows_grouped_host)

__all__ = ["DigestWriteSet", "ShardedWriteSet", "WriteSet", "gather_rows",
           "host_rows"]


def host_rows(rows) -> np.ndarray:
    """Row ids as a host int64 array, from a tensor on any device, a
    numpy array or a sequence."""
    if isinstance(rows, torch.Tensor):
        return rows.detach().to("cpu", torch.int64).numpy().reshape(-1)
    return np.asarray(rows, np.int64).reshape(-1)


def _row_lines(region) -> int:
    """Lines one row of ``region`` spans at most, a line for a sub-line
    row: what ``ShardedArena.run_shards`` weighs a shard's stall by."""
    return max(1, -(-region.rowbytes // 64))


class _Planned(NamedTuple):
    """One region of a drain: its sorted unique rows, the line cost its
    marks claimed, and how many rows they named.  A shadow drain's rows
    are the fresh rows, then the rewritten ones (``fresh`` of them
    fresh)."""
    region: object
    rows: np.ndarray
    would_lines: int
    marked_rows: int
    fresh: int = 0


class _Marks:
    """One region's pending marks: the row arrays of its rewrite marks
    and of its fresh marks, the line cost their calls claimed and the
    rows they named, summed as they come so a drain only concatenates."""
    __slots__ = ("rows", "would", "marked")

    def __init__(self):
        self.rows: Tuple[List[np.ndarray], List[np.ndarray]] = ([], [])
        self.would = 0
        self.marked = 0

    def add(self, rows: np.ndarray, would: int, fresh: bool) -> None:
        self.rows[fresh].append(rows)
        self.would += would
        self.marked += int(rows.size)


def _union(parts: List[np.ndarray]) -> np.ndarray:
    """Sorted unique rows of the sorted unique arrays ``parts``."""
    if len(parts) == 1:
        return parts[0]
    if not parts:
        return np.empty(0, np.int64)
    return np.unique(np.concatenate(parts))


class WriteSet:
    """Per-arena dirty-row tracker with epoch-batched flushing."""

    # non-empty grouped gathers, summed over every write set: a run sets it
    # to 0 and compares it with pack_rows' launches
    gathers = 0

    def __init__(self, arena):
        self.arena = arena
        # region name -> its pending marks
        self._pending: Dict[str, _Marks] = {}
        # pinned host indices and staging, card arenas only: grown on
        # demand, reused by every drain (each ends in a stream synchronize)
        self._pinned_idx: Optional[torch.Tensor] = None
        self._pinned_out: Optional[torch.Tensor] = None
        # each pinned buffer's numpy view, made once per buffer
        self._pinned_host: Dict[str, np.ndarray] = {}

    def mark(self, region, rows: np.ndarray, fresh: bool = False) -> None:
        """Record dirty rows of `region`; flushed at epoch close.
        ``fresh`` rows were never reachable from a committed generation,
        so a shadow drain writes them home in place (barrier mode ignores
        it)."""
        rows = np.unique(host_rows(rows))
        if rows.size == 0:
            return
        marks = self._pending.get(region.name)
        if marks is None:
            marks = self._pending[region.name] = _Marks()
        if region.snap or region.jrnl:
            # snapshot and journal rows stay off the marks/dedup/saved
            # ledger
            marks.add(rows, 0, fresh)
            return
        marks.add(rows, self._would(region, rows), fresh)
        self._ledger().marks += 1

    def _ledger(self):
        """The FlushStats that marks, epochs, dedup and saved lines land
        in."""
        return self.arena.stats

    def _would(self, region, rows: np.ndarray) -> int:
        """Lines one accounting call for these rows would charge."""
        return self.arena._rows_line_count(region.offset, region.rowbytes,
                                           rows)

    def _order(self, names) -> List[str]:
        """A phase's regions in flush order: by offset."""
        return sorted(names, key=lambda n: self.arena.regions[n].offset)

    def __bool__(self) -> bool:
        return bool(self._pending)

    def discard(self) -> None:
        """Drop all pending marks without flushing (crash simulation)."""
        self._pending.clear()

    def flush(self, include_meta: bool = True) -> None:
        """Flush all pending marks, data regions first, then metadata
        regions; ``include_meta=False`` flushes only the data half and
        DROPS the metadata marks.  One gather covers every region the
        flush writes."""
        self._drain_snapshots()
        if not self._pending:
            return
        if self.arena.commit_mode == "shadow":
            # one phase; include_meta=False is a crash before the flip,
            # which nothing drained here can reach anyway
            if self._flush_shadow():
                self._ledger().epochs += 1
            return
        plans = [self._plan(meta=False)]
        if include_meta:
            plans.append(self._plan(meta=True))
        else:
            self._pending.clear()   # crash point: metadata marks are lost
        staged = iter(self._gather_paged(
            [(p.region, p.rows) for plan in plans for p in plan],
            lambda: self._barrier_script(plans)))
        flushed, sidecars = False, []
        for plan in plans:
            flushed = self._write_phase(plan, staged, sidecars) or flushed
        self.seat_sidecars(sidecars)
        if flushed:
            self._ledger().epochs += 1

    def _drain_snapshots(self) -> None:
        """Mark each registered provider's dirty snapshot rows.  Providers
        are idempotent (nothing newly dirty, nothing emitted), so draining
        them at every flush leaves a commit's own flush adding no bytes
        beyond the preceding epoch's; a record sealed at a non-commit
        flush names a generation recovery skips until it commits."""
        for prov in self.arena._snap_providers:
            for region, rows in prov():
                self.mark(region, rows)

    def flush_phase(self, meta: bool) -> bool:
        """Flush only the data half (``meta=False``) or only the metadata
        half (``meta=True``) of the pending marks, with a gather of its
        own; returns whether anything flushed."""
        plan = self._plan(meta)
        sidecars = []
        flushed = self._write_phase(plan, iter(self._gather_paged(
            [(p.region, p.rows) for p in plan],
            lambda: self._barrier_script([plan]))), sidecars)
        self.seat_sidecars(sidecars)
        return flushed

    def _plan(self, meta: bool) -> List[_Planned]:
        """Pop the pending marks of one phase's regions, in flush order."""
        arena = self.arena
        names = self._order(n for n in self._pending
                            if arena.regions[n].meta == meta)
        plan = []
        for name in names:
            marks = self._pending.pop(name)
            plan.append(_Planned(arena.regions[name],
                                 _union(marks.rows[0] + marks.rows[1]),
                                 marks.would, marks.marked))
        return plan

    def _flush_shadow(self) -> bool:
        """The single-phase shadow drain, every region by offset: fold the
        committed bank home, gather every region's fresh and rewritten
        rows in ONE grouped gather, then write the fresh rows home (with
        their checksums) and route the rewrites through the arena's remap
        (``Arena._shadow_write``, checksums cascading into the same bank).
        Returns whether anything flushed."""
        arena = self.arena
        plan = self._shadow_plan()
        sidecars = []
        with arena.stall_scope():
            arena._shadow_collapse()
            staged = self._gather_paged(
                [(p.region, p.rows) for p in plan],
                lambda: self._shadow_script(
                    [(p.region, p.rows[p.fresh:], True) if part else
                     (p.region, p.rows[:p.fresh], False)
                     for p in plan for part in (0, 1)]))
            for p, host in zip(plan, staged):
                region, k = p.region, p.fresh
                before = arena.stats.lines
                if k:
                    fr = p.rows[:k]
                    region._pview()[fr] = host[:k]
                    arena._account_rows(region.offset, region.rowbytes, fr,
                                        snap=region.snap, jrnl=region.jrnl)
                    sidecars.append(arena._integrity_home(region, fr,
                                                          host[:k]))
                if p.rows.size > k:
                    sidecars.append(arena._shadow_write(region, p.rows[k:],
                                                        host[k:]))
                if region.snap or region.jrnl:
                    continue
                actual = arena.stats.lines - before
                arena.stats.saved_lines += max(0, p.would_lines - actual)
                arena.stats.dedup_rows += p.marked_rows - p.rows.size
        self.seat_sidecars(sidecars)
        return bool(plan)

    def _gather_paged(self, plan, script) -> List[np.ndarray]:
        """``gather(plan)``, with the cache bookkeeping ``script()`` where
        ``plan`` holds a paged region."""
        if any(region.is_paged for region, _ in plan):
            return self.gather(plan, script=script())
        return self.gather(plan)

    def _barrier_script(self, plans) -> list:
        """A barrier drain's cache bookkeeping (``gather``'s ``script``):
        each paged region's gather, then its note, phase by phase in flush
        order."""
        return [(op, p.region, p.rows) for plan in plans for p in plan
                if p.region.is_paged for op in ("read", "flushed")]

    @staticmethod
    def _shadow_script(parts) -> list:
        """A shadow drain's cache bookkeeping, ``parts`` being ``(region,
        rows, remap)`` in write order: a gather and a note each, and a
        covered region's rewrite gathers again for its checksums."""
        out = []
        for region, rows, remap in parts:
            if not region.is_paged or rows.size == 0:
                continue
            out += [("read", region, rows), ("flushed", region, rows)]
            if remap and region._integ is not None:
                out.append(("read", region, rows))
        return out

    def _shadow_plan(self) -> List[_Planned]:
        """Pop every pending mark, region by region in flush order, as a
        shadow drain's plan: the fresh rows, then the rewritten ones."""
        plan = []
        for name in self._order(self._pending):
            marks = self._pending.pop(name)
            rew, fr = _union(marks.rows[0]), _union(marks.rows[1])
            if fr.size and rew.size:
                # a row marked both ways is conservatively a rewrite
                fr = np.setdiff1d(fr, rew, assume_unique=True)
            plan.append(_Planned(self.arena.regions[name],
                                 np.concatenate([fr, rew]) if fr.size
                                 else rew, marks.would, marks.marked,
                                 int(fr.size)))
        return plan

    def _write_phase(self, plan: List[_Planned], staged,
                     sidecars: list) -> bool:
        """Write one phase's gathered rows (the next ``len(plan)`` arrays
        of ``staged``) into the persistent image with their sidecar
        checksums, account them, and fence once; returns whether anything
        flushed.  The sidecar rows written are appended to ``sidecars``
        for ``seat_sidecars``."""
        arena = self.arena
        with arena.stall_scope():
            for p, host in zip(plan, staged):
                region, rows = p.region, p.rows
                region._pview()[rows] = host
                # checksummed from the staged rows now: the next gather
                # reuses the staging buffer
                sidecars.append(arena._integrity_home(region, rows, host))
                if region.snap or region.jrnl:
                    arena._account_rows(region.offset, region.rowbytes,
                                        rows, snap=region.snap,
                                        jrnl=region.jrnl)
                    continue
                before = arena.stats.lines
                arena._account_rows(region.offset, region.rowbytes, rows)
                actual = arena.stats.lines - before
                arena.stats.saved_lines += max(0, p.would_lines - actual)
                arena.stats.dedup_rows += p.marked_rows - rows.size
        if plan:
            arena._fence()      # one ordering point per barrier phase
        return bool(plan)

    def seat_sidecars(self, sidecars: list) -> None:
        """Write the checksums ``_integrity_home`` persisted (``(sidecar,
        rows, checksums)`` entries; None for uncovered regions) into the
        sidecars' volatile tensors.  On a card every entry's rows and
        checksums travel in ONE host-to-device copy (from a pinned copy of
        them, which the copy keeps alive until it lands), then one indexed
        write per sidecar."""
        sidecars = [u for u in sidecars if u is not None]
        if not sidecars:
            return
        if self.arena.device.type == "cpu":
            for sc, rows, ck in sidecars:
                sc.vol[torch.from_numpy(rows)] = torch.from_numpy(ck)
            return
        buf = np.concatenate([part.reshape(-1) for _, rows, ck in sidecars
                              for part in (rows, ck)])
        dbuf = torch.from_numpy(buf).pin_memory().to(self.arena.device,
                                                     non_blocking=True)
        pos = 0
        for sc, rows, ck in sidecars:
            m = rows.size
            sc.vol[dbuf[pos:pos + m]] = dbuf[pos + m:pos + m + ck.size] \
                .view(ck.shape)
            pos += m + ck.size

    def gather(self, plan, script=None) -> List[np.ndarray]:
        """Rows ``rows`` (host ids) of each ``(region, rows)`` of ``plan``
        as host arrays, gathered in one grouped gather on the arena's
        device.  On a card the kernel writes them straight into this
        write set's pinned staging buffer, and the arrays are views of it,
        valid until its next gather.

        A paged region's rows come from its block pool: ``script`` (the
        drain's cache bookkeeping in the reference's order, default one
        read per paged region of ``plan``) runs first, under one hold of
        the cache, and the rows' indices are translated to pool
        positions."""
        counts = [int(rows.size) for _, rows in plan]
        n = sum(counts)
        if n == 0:
            return [rows.reshape((0,) + region.shape[1:])
                    .astype(region.dtype) for region, rows in plan]
        paged = [region for region, _ in plan
                 if getattr(region, "paged_active", False)]
        if not paged:
            return self._gather(plan, counts, n)
        if script is None:
            script = [("read", region, rows) for region, rows in plan
                      if region.is_paged]
        from repro_torch.core.paging import drain_positions
        with paged[0]._cache.holding():
            at = drain_positions(script)
            return self._gather(plan, counts, n, at)

    def _gather(self, plan, counts, n, at=None) -> List[np.ndarray]:
        """``gather``'s one launch; ``at`` maps a paged region to its rows'
        pool positions (``drain_positions``)."""
        srcs, idxs = [], []
        for region, rows in plan:
            if at is not None and region in at:
                urows, upos = at[region]
                srcs.append(region._pool_rows())
                idxs.append(upos if urows is rows
                            else upos[np.searchsorted(urows, rows)])
            else:
                srcs.append(region.vol.reshape(region.shape[0], -1))
                idxs.append(rows)
        offs, total = group_layout(srcs, counts)
        dev = self.arena.device
        if dev.type == "cpu":
            idx = torch.from_numpy(np.concatenate(idxs).astype(np.int32))
            buf = pack_rows_grouped(srcs, idx, counts).numpy()
        else:
            hidx = self._pinned("_pinned_idx", 4 * n)
            host_idx, pos = self._pinned_host["_pinned_idx"].view(
                np.int32), 0
            for rows, m in zip(idxs, counts):
                host_idx[pos:pos + m] = rows
                pos += m
            hout = self._pinned("_pinned_out", total)
            stream = torch.cuda.current_stream(dev)
            pack_rows_grouped_host(srcs, counts, hidx, hout, stream)
            stream.synchronize()
            buf = self._pinned_host["_pinned_out"]
        WriteSet.gathers += 1
        return [buf[off:off + m * region.rowbytes].view(region.dtype)
                .reshape((m,) + region.shape[1:])
                for (region, _), m, off in zip(plan, counts, offs)]

    def _pinned(self, attr: str, nbytes: int) -> torch.Tensor:
        """This write set's pinned host buffer ``attr``, at least
        ``nbytes`` long (grown to the next power of two)."""
        buf = getattr(self, attr)
        if buf is None or buf.shape[0] < nbytes:
            size = 1 << max(12, (nbytes - 1).bit_length())
            buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            setattr(self, attr, buf)
            self._pinned_host[attr] = buf.numpy()
        return buf


class ShardedWriteSet(WriteSet):
    """The cross-shard write set of a ``ShardedArena``.

    Marks are buffered GLOBALLY per region, one append per ``mark_rows``
    as on a single arena, and split per shard once per drain.  A drain
    plans both barrier phases, then gathers every row it writes, of every
    shard and both phases, from the regions' global volatile tensors in
    ONE grouped gather (``WriteSet.gather``), so the launches per drain do
    not grow with the shard count.  Then, phase by phase, each shard's
    slices take their rows: the persistent writes, the per-shard line
    accounting and the sidecar checksums go shard by shard, and one
    global fence closes the phase: every shard's data regions land
    before any shard's metadata.  Per-shard accounting stays in each
    shard's ``FlushStats``; marks, dedup, saved lines and epochs are
    counted at the sharded level, against the per-call line counts of the
    GLOBAL rows (``Arena._rows_line_count`` at base 0), so they equal a
    single arena's for line-aligned rows.  The pool runs only where the
    arena models media stalls (``ShardedArena.run_shards``): without them
    the shards are written one after another on the calling thread.

    A shadow drain is one phase (``_flush_shadow``): the same one grouped
    gather, then per shard, in region-name order, each region's rewrites
    through the shard's remap and then its fresh rows home; a shard with
    no work in the drain does not fold its committed bank."""

    def _ledger(self):
        return self.arena._local_stats

    def _would(self, region, rows: np.ndarray) -> int:
        # the GLOBAL rows' count, as the reference's (base 0)
        return self.arena.shards[0]._rows_line_count(0, region.rowbytes,
                                                     rows)

    def _order(self, names) -> List[str]:
        return sorted(names)

    def _write_phase(self, plan: List[_Planned], staged,
                     sidecars: list) -> bool:
        """Write one phase's gathered rows into their shards' images, then
        pay the one global fence."""
        if not plan:
            return False
        work: Dict[int, list] = {}
        for p, host in zip(plan, staged):
            for s, local, sel in p.region._split(p.rows):
                work.setdefault(s, []).append(
                    (p.region.slices[s], local,
                     host if sel is None else host[sel], False))
        sidecars.extend(self._write_shards(plan, work, fold=False))
        self.arena._fence()         # the global cross-shard ordering point
        return True

    def _flush_shadow(self) -> bool:
        """The single-phase sharded shadow drain.  Every region's rewrites
        and fresh rows (a row marked both ways is a rewrite), over all
        shards, come up in ONE grouped gather.  Then each shard with work
        folds its committed bank home and takes, region by region in name
        order, the rewrites through its remap and then the fresh rows
        home.  Returns whether anything flushed."""
        plan = self._shadow_plan()
        if not plan:
            return False
        staged = self._gather_paged(
            [(p.region, p.rows) for p in plan],
            lambda: self._shard_script(
                [(p.region, rows, remap) for p in plan
                 for rows, remap in ((p.rows[p.fresh:], True),
                                     (p.rows[:p.fresh], False))
                 if rows.size]))
        # each region's rows split across the shards once, each shard's
        # share then cut into its rewrites and its fresh rows
        work: Dict[int, list] = {}
        for p, host in zip(plan, staged):
            k, sl_of = p.fresh, p.region.slices
            for s, local, sel in p.region._split(p.rows):
                g = host if sel is None else host[sel]
                cut = k if sel is None else \
                    int(np.count_nonzero(sel[:k]))
                w = work.setdefault(s, [])
                if cut < local.size:
                    w.append((sl_of[s], local[cut:], g[cut:], True))
                if cut:
                    w.append((sl_of[s], local[:cut], g[:cut], False))
        self.seat_sidecars(self._write_shards(plan, work, fold=True))
        return True

    def _barrier_script(self, plans) -> list:
        return [op for plan in plans for op in self._shard_script(
            [(p.region, p.rows, None) for p in plan])]

    def _shard_script(self, parts) -> list:
        """The reference's cache bookkeeping of a sharded drain of
        ``parts`` (``(region, global rows, remap)`` in write order; None
        for a barrier phase): shard by shard, each part's share gathered
        and noted, a covered rewrite gathered again."""
        work: Dict[int, list] = {}
        for region, rows, remap in parts:
            if not region.is_paged:
                continue
            for s, local, sel in region._split(rows):
                work.setdefault(s, []).append(
                    (region, rows if sel is None else rows[sel], remap))
        out = []
        for s in sorted(work):
            out += self._shadow_script(
                [(region, rows, bool(remap))
                 for region, rows, remap in work[s]])
        return out

    def _write_shards(self, plan: List[_Planned], work: Dict[int, list],
                      fold: bool) -> list:
        """Write ``work``, shard -> ``[(slice, local rows, gathered rows,
        remap)]`` in order, shard by shard: each shard with work first
        folds its committed bank home when ``fold``, then takes its
        parts, through its remap where ``remap`` (``Arena._shadow_write``
        on the slice, checksums cascading into the sidecar slice's mirror)
        and home otherwise, with their checksums.  Saved lines count each
        shard's whole line delta, a fold included, against the marks'
        per-call counts of ``plan``'s non-snapshot, non-journal regions,
        as the reference does.  Returns the sidecar rows to seat."""
        arena = self.arena
        actual, seats = {}, {}

        def write_shard(s: int) -> None:
            shard = arena.shards[s]
            before = shard.stats.lines
            seats[s] = []
            with shard.stall_scope():
                if fold:
                    shard._shadow_collapse()
                for sl, local, host, remap in work[s]:
                    if remap:
                        seats[s].append(shard._shadow_write(sl, local, host))
                        continue
                    sl._pview()[local] = host
                    shard._account_rows(sl.offset, sl.rowbytes, local,
                                        snap=sl.snap, jrnl=sl.jrnl)
                    seats[s].append(shard._integrity_home(sl, local, host))
            actual[s] = shard.stats.lines - before

        shards = sorted(work)
        arena.run_shards(write_shard, shards, lines=lambda s: (
            arena.shards[s]._fold_lines() if fold else 0) + sum(
                local.size * _row_lines(sl) for sl, local, _, _ in work[s]))
        ledger = [p for p in plan if not (p.region.snap or p.region.jrnl)]
        arena._local_stats.saved_lines += max(
            0, sum(p.would_lines for p in ledger) - sum(actual.values()))
        arena._local_stats.dedup_rows += sum(
            p.marked_rows - p.rows.size for p in ledger)
        return [_global_seat(u) for s in shards for u in seats[s]]

    def persist(self, region, rows: np.ndarray) -> None:
        """A direct (epoch-less) flush of one region's sorted unique global
        ``rows``: one gather, then each shard's slice written home,
        accounted per call and checksummed, shard by shard."""
        script = []
        for s, local, sel in region._split(rows):
            script += region._persist_script(
                rows if sel is None else rows[sel], region._integ)
        host = self._gather_paged([(region, rows)], lambda: script)[0]
        sidecars = []
        for s, local, sel in region._split(rows):
            shard, sl = self.arena.shards[s], region.slices[s]
            g = host if sel is None else host[sel]
            sl._pview()[local] = g
            shard._account_rows(sl.offset, sl.rowbytes, local, snap=sl.snap,
                                jrnl=sl.jrnl, integ=sl.integ)
            sidecars.append(_global_seat(shard._integrity_home(sl, local,
                                                               g)))
        self.seat_sidecars(sidecars)


def _global_seat(seat):
    """A shard's ``(sidecar slice, local rows, checksums)`` as the sharded
    sidecar region and its global rows, for ``seat_sidecars``."""
    if seat is None:
        return None
    sl, local, ck = seat
    return sl._parent, sl._gidx[local], ck


def gather_rows(region, rows: np.ndarray) -> np.ndarray:
    """Rows ``rows`` (sorted unique host ids) of one region's volatile
    tensor as a host array, the way drains gathered before the grouped
    gather: a pageable index upload, ``pack_rows`` on the region alone and
    a pageable download.  Kept to time against ``WriteSet.gather``."""
    if getattr(region, "paged_active", False):
        from repro_torch.core.paging import drain_positions
        with region._cache.holding():
            urows, upos = drain_positions([("read", region, rows)])[region]
            vol = region._pool_rows()
            idx = torch.from_numpy(upos[np.searchsorted(urows, rows)]
                                   .astype(np.int32)).to(vol.device)
            staged = pack_rows(vol, idx)
            return staged.cpu().numpy().reshape((rows.size,)
                                                + region.shape[1:])
    vol = region.vol.reshape(region.shape[0], -1)
    idx = torch.from_numpy(rows.astype(np.int32)).to(vol.device)
    staged = pack_rows(vol, idx)
    return staged.cpu().numpy().reshape((rows.size,) + region.shape[1:])


class DigestWriteSet:
    """Content-digest dirty tracking for file-per-leaf persistence.

    ``dirty(key, digest, present)`` returns True when the leaf must be
    rewritten (digest changed, or the backing file is missing) and
    records the new digest; unchanged leaves are counted as deduplicated
    writes, mirroring ``WriteSet``'s row dedup at file granularity."""

    def __init__(self):
        self._digests: Dict[str, str] = {}
        self.skipped = 0
        self.written = 0

    def dirty(self, key: str, digest: str, present: bool = True) -> bool:
        clean = present and self._digests.get(key) == digest
        self._digests[key] = digest
        if clean:
            self.skipped += 1
            return False
        self.written += 1
        return True

    def note(self, key: str, digest: str) -> None:
        """Record a write that happens regardless of digest (callers not
        running in incremental mode), keeping the counters truthful."""
        self._digests[key] = digest
        self.written += 1
