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
the arena's device until the drain: every drain gathers the dirty rows
there into one staging buffer with ``pack_rows`` (the kernel on a CUDA
arena; the reference's ``Arena(pack_flush_rows=N)`` path, here always
on), copies that buffer to the host once, and writes it into the
persistent image.  Unlike the reference there is no silent fallback: a
failed kernel raises.

Every flush first asks the arena's order-snapshot providers for their
dirty snapshot rows (``_drain_snapshots``), at every drain and not only
at commits.  Snapshot rows ride the same ``pack_rows`` gather as data
rows, flush in the metadata phase, and stay out of the ``marks`` /
``dedup_rows`` / ``saved_lines`` ledger: their lines land in
``FlushStats.snapshot_lines``.  Request-journal rings (``.jrnl``) stay
off that ledger too; their lines land in ``FlushStats.journal_lines``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels.pack_flush import pack_rows

__all__ = ["DigestWriteSet", "WriteSet", "gather_rows", "host_rows"]


def host_rows(rows) -> np.ndarray:
    """Row ids as a host int64 array, from a tensor on any device, a
    numpy array or a sequence."""
    if isinstance(rows, torch.Tensor):
        return rows.detach().to("cpu", torch.int64).numpy().reshape(-1)
    return np.asarray(rows, np.int64).reshape(-1)


class WriteSet:
    """Per-arena dirty-row tracker with epoch-batched flushing."""

    def __init__(self, arena):
        self.arena = arena
        # region name -> list of (unique rows, per-call line cost)
        self._pending: Dict[str, List[Tuple[np.ndarray, int]]] = {}

    def mark(self, region, rows: np.ndarray) -> None:
        """Record dirty rows of `region`; flushed at epoch close."""
        rows = np.unique(host_rows(rows))
        if rows.size == 0:
            return
        if region.snap or region.jrnl:
            # snapshot and journal rows stay off the marks/dedup/saved
            # ledger
            self._pending.setdefault(region.name, []).append((rows, 0))
            return
        would = self.arena._rows_line_count(region.offset, region.rowbytes,
                                            rows)
        self._pending.setdefault(region.name, []).append((rows, would))
        self.arena.stats.marks += 1

    def __bool__(self) -> bool:
        return bool(self._pending)

    def discard(self) -> None:
        """Drop all pending marks without flushing (crash simulation)."""
        self._pending.clear()

    def flush(self, include_meta: bool = True) -> None:
        """Flush all pending marks, data regions first, then metadata
        regions; ``include_meta=False`` flushes only the data half and
        DROPS the metadata marks."""
        self._drain_snapshots()
        if not self._pending:
            return
        flushed = self.flush_phase(meta=False)
        if include_meta:
            flushed = self.flush_phase(meta=True) or flushed
        else:
            self._pending.clear()   # crash point: metadata marks are lost
        if flushed:
            self.arena.stats.epochs += 1

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
        half (``meta=True``) of the pending marks; returns whether
        anything flushed."""
        arena = self.arena
        names = [n for n in self._pending if arena.regions[n].meta == meta]
        names.sort(key=lambda n: arena.regions[n].offset)
        with arena.stall_scope():
            flushed_any = self._flush_names(names, arena)
        if flushed_any:
            arena._fence()      # one ordering point per barrier phase
        return flushed_any

    def _flush_names(self, names, arena) -> bool:
        flushed_any = False
        for name in names:
            region = arena.regions[name]
            marks = self._pending.pop(name)
            rows = np.unique(np.concatenate([r for r, _ in marks]))
            would_lines = sum(w for _, w in marks)
            marked_rows = sum(r.size for r, _ in marks)
            self._copy_rows(region, rows)
            flushed_any = True
            if region.snap or region.jrnl:
                arena._account_rows(region.offset, region.rowbytes, rows,
                                    snap=region.snap, jrnl=region.jrnl)
                continue
            before = arena.stats.lines
            arena._account_rows(region.offset, region.rowbytes, rows)
            actual = arena.stats.lines - before
            arena.stats.saved_lines += max(0, would_lines - actual)
            arena.stats.dedup_rows += marked_rows - rows.size
        return flushed_any

    def _copy_rows(self, region, rows: np.ndarray) -> None:
        region._pview()[rows] = gather_rows(region, rows)


def gather_rows(region, rows: np.ndarray) -> np.ndarray:
    """Rows ``rows`` (sorted unique host ids) of ``region``'s volatile
    tensor as a host array: gathered on the region's device into one
    staging buffer by ``pack_rows``, then copied to the host once."""
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
