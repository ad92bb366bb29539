"""Persistent request journal: detectable, exactly-once op semantics, the
port of ``repro.serve.journal``.

Every admission / completion appends one sealed 64 B descriptor line to a
persistent append ring, and recovery replays the committed window to
classify every request as completed / must-retry / never-admitted, so the
serving path can refuse duplicate admissions and retry exactly the
requests whose effects never committed.

Partly-persistent split:

* ESSENTIAL: the ring entries (``{name}.jrnl``, one 64 B line each:
  ``[magic, seq, rid, op, digest, info, gen, cksum]``) and the HEAD / TAIL
  counters.
* DERIVABLE: the rid -> seq index (``_admit`` / ``_complete``), rebuilt by
  the registered ``serve.journal`` reconstructor.

The journal adds no ordering point of its own.  Entries are marked into
the enclosing epoch's write set (every append targets a slot outside the
committed live window, the sealing rule, so they are marked ``fresh``: a
shadow drain writes them home in place, a barrier drain in its data
phase), and the persisted HEAD/TAIL ride a metadata line.  Hosted by the request hashmap, HEAD/TAIL take words 4-5
of its header row, which every insert/remove already marks, so the table's
committed size and the journal's committed head share one line and the
journal's flush overhead is the one ring line per epoch counted in
``FlushStats.journal_lines``.  An entry is visible iff its seq is under
the committed HEAD: a torn (data-phase-only) crash leaves the entry bytes
behind an unmoved HEAD.

The ring lives on the arena's device like every region; the entries are
built and checked on the host with the reference's numpy uint64 checksum
(``mix_checksums``), so the bytes are the reference's.
"""
from __future__ import annotations

from typing import Dict, Set

import numpy as np
import torch

from repro_torch.core import reconstruct as rec
from repro_torch.core.arena import _splitmix64, mix_checksums, snap_checksum

JR_MAGIC = 0x4C4E524A            # "JRNL" little-endian
JR_WORDS = 8                     # int64 words per entry = one 64 B line

OP_ADMIT = 1                     # request admitted; effects pending
OP_COMPLETE = 2                  # request's effects fully applied
OP_APPLY = 3                     # single-epoch admit+complete fusion

ST_NEVER = "never-admitted"
ST_RETRY = "must-retry"
ST_DONE = "completed"

# piggyback base: the request hashmap's header row uses words 0-3
# (H_FLAG/H_SIZE/H_FRESH/H_BUCKETS); the journal takes words 4-5
HOST_HEADER_BASE = 4


class DuplicateRequestError(RuntimeError):
    """An already-journaled request id was admitted again."""


def args_digest(arr) -> int:
    """Order-sensitive splitmix64 fold of an int array: the per-op args
    fingerprint stored in the entry's digest word."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    a = np.asarray(arr).astype(np.int64, copy=False).ravel().astype(np.uint64)
    x = np.uint64(0x9E3779B97F4A7C15)
    if a.size:
        mixed = _splitmix64(a + np.arange(1, a.size + 1, dtype=np.uint64))
        x = np.bitwise_xor.reduce(mixed)
    return int(_splitmix64(np.array([x ^ np.uint64(a.size)],
                                    np.uint64))[0].astype(np.int64))


class RequestJournal:
    """Partly-persistent append ring of per-request op descriptors.

    ``header``/``header_base``: the metadata row carrying the persisted
    HEAD/TAIL words.  Pass the host structure's header region to piggyback
    (words ``header_base``, ``header_base+1`` must be unused by the host);
    omit it for a standalone journal, which lays out its own
    ``{name}.jrnlheader`` line.
    """

    def __init__(self, arena, capacity: int, name: str = "jr",
                 header=None, header_base: int = HOST_HEADER_BASE):
        self.arena = arena
        self.capacity = int(capacity)
        self.name = name
        self.ring = arena.regions.get(f"{name}.jrnl") or arena.region(
            f"{name}.jrnl", np.int64, (self.capacity, JR_WORDS),
            router=("seg", 8))
        if header is None:
            header = arena.regions.get(f"{name}.jrnlheader") or arena.region(
                f"{name}.jrnlheader", np.int64, (1, 8))
            header_base = 0
        self.header = header
        self._hb = int(header_base)
        assert 0 <= self._hb <= 6
        # volatile redundancy (rebuilt by the serve.journal reconstructor)
        self.head = 0                       # next seq to append
        self.tail = 0                       # oldest live seq
        self._admit: Dict[int, int] = {}    # rid -> ADMIT/APPLY seq
        self._complete: Dict[int, int] = {} # rid -> COMPLETE/APPLY seq
        self._retired: Set[int] = set()     # seqs retired, tail not yet past

    @staticmethod
    def layout(capacity: int, name: str = "jr", standalone: bool = False):
        """Arena layout fragment.  Hosted journals (header piggyback) need
        only the ring; ``standalone=True`` adds the dedicated header
        line."""
        out = {f"{name}.jrnl": (np.int64, (int(capacity), JR_WORDS),
                                ("seg", 8))}
        if standalone:
            out[f"{name}.jrnlheader"] = (np.int64, (1, 8))
        return out

    # ------------------------------------------------------------- write
    def log(self, op: int, rid: int, digest: int = 0, info: int = 0) -> int:
        """Append one op descriptor inside the CURRENT epoch.  Raises
        DuplicateRequestError on re-admission of a known rid; the dedup
        window is the ring capacity."""
        assert self.arena._epoch_depth > 0, \
            "journal writes must ride an epoch"
        rid = int(rid)
        if op in (OP_ADMIT, OP_APPLY):
            st = self.state_of(rid)
            if st != ST_NEVER:
                raise DuplicateRequestError(
                    f"request {rid} already journaled as {st}")
        elif op == OP_COMPLETE:
            if rid not in self._admit:
                raise KeyError(f"request {rid} was never admitted")
            if rid in self._complete:
                raise DuplicateRequestError(
                    f"request {rid} already completed")
        else:
            raise ValueError(f"unknown journal op {op!r}")
        if self.head - self.tail >= self.capacity:
            raise MemoryError(
                "journal ring full — retire_completed() first")
        seq = self.head
        slot = seq % self.capacity
        row = np.array([JR_MAGIC, seq, rid, int(op), int(digest),
                        int(info), self.arena.generation + 1, 0], np.int64)
        row[7] = snap_checksum(row)
        self.ring.write_row(slot, row)
        # sealing rule: the slot is outside the committed live window
        # (only retired slots are ever reused), hence fresh
        self.ring.mark_rows(np.array([slot]), fresh=True)
        self.header.write_at([0], slice(self._hb, self._hb + 2),
                             np.array([[seq + 1, self.tail]], np.int64))
        self.header.mark_rows(np.array([0]))
        self.head = seq + 1
        if op == OP_ADMIT:
            self._admit[rid] = seq
        elif op == OP_COMPLETE:
            self._complete[rid] = seq
        else:                               # OP_APPLY
            self._admit[rid] = seq
            self._complete[rid] = seq
        return seq

    def retire_completed(self) -> int:
        """Drop completed rids from the volatile index and advance TAIL
        over the contiguous retired prefix, freeing their ring slots for
        reuse.  Volatile-only: the advanced TAIL persists with the next
        ``log``'s header line.  Must run outside any epoch."""
        assert self.arena._epoch_depth == 0, \
            "retire_completed must run outside epochs"
        n = 0
        for r in list(self._complete):
            self._retired.add(self._complete.pop(r))
            adm = self._admit.pop(r, None)
            if adm is not None:
                self._retired.add(adm)
            n += 1
        while self.tail < self.head and self.tail in self._retired:
            self._retired.discard(self.tail)
            self.tail += 1
        return n

    # -------------------------------------------------------------- read
    def state_of(self, rid: int) -> str:
        rid = int(rid)
        if rid in self._complete:
            return ST_DONE
        if rid in self._admit:
            return ST_RETRY
        return ST_NEVER

    def admitted(self, rid: int) -> bool:
        rid = int(rid)
        return rid in self._admit or rid in self._complete

    def classify(self) -> Dict[int, str]:
        """rid -> state for every request in the live window."""
        out = {r: ST_DONE for r in self._complete}
        for r in self._admit:
            out.setdefault(r, ST_RETRY)
        return out

    def must_retry(self) -> Set[int]:
        """Rids admitted but never completed: the replay set."""
        return {r for r in self._admit if r not in self._complete}

    def space(self) -> int:
        return self.capacity - (self.head - self.tail)


@rec.register("serve.journal")
def _reconstruct_journal(j: RequestJournal) -> dict:
    """Pure rebuild of the volatile rid index from the committed window
    [TAIL, HEAD).  A window slot is accepted iff its magic, stored seq and
    checksum all match; a mismatch is a retired entry's slot destroyed by
    an uncommitted later lap, so skipping it cannot change any live rid's
    classification."""
    hv = j.header.read_row(0)
    head, tail = int(hv[j._hb]), int(hv[j._hb + 1])
    j._admit, j._complete, j._retired = {}, {}, set()
    if not (0 <= tail <= head and head - tail <= j.capacity):
        # unreachable from any committed image (HEAD/TAIL share one
        # flushed line); garbage header words recover as empty
        j.head = j.tail = 0
        return {"window": 0, "entries": 0, "skipped": 0,
                "invalid_header": True}
    j.head, j.tail = head, tail
    detail = {"window": head - tail}
    seqs = np.arange(tail, head, dtype=np.int64)
    if seqs.size == 0:
        detail.update(entries=0, skipped=0, completed=0, must_retry=0)
        return detail
    rows = j.ring.read_rows(seqs % j.capacity).cpu().numpy()
    valid = ((rows[:, 0] == JR_MAGIC) & (rows[:, 1] == seqs)
             & (rows[:, 7] == mix_checksums(rows[:, :7])))
    for seq, rid, op in zip(seqs[valid].tolist(),
                            rows[valid, 2].tolist(),
                            rows[valid, 3].tolist()):
        if op == OP_ADMIT:
            j._admit[rid] = seq
        elif op == OP_COMPLETE:
            j._complete[rid] = seq
        elif op == OP_APPLY:
            j._admit[rid] = seq
            j._complete[rid] = seq
    cls = j.classify()
    detail.update(entries=int(valid.sum()), skipped=int((~valid).sum()),
                  completed=sum(1 for s in cls.values() if s == ST_DONE),
                  must_retry=sum(1 for s in cls.values() if s == ST_RETRY))
    return detail
