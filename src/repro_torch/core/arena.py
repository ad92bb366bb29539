"""Persistent arena: the framework's "persistent memory", the port of
``repro.core.arena`` (barrier and shadow commit), single and sharded.

* Every region's VOLATILE copy (``Region.vol``) is a torch tensor on the
  arena's device — the working copy the structures mutate.
* The PERSISTENT image stays in host memory: an ``np.uint8`` buffer for
  ``path=None``, or an ``np.memmap`` of the backing file.  Its byte layout
  is the reference's exactly (regions row-aligned to 64 B after a 4 KiB
  header page, the ``_HDR_FMT`` commit header, the ``.layout`` sidecar),
  so an arena file moves between the two packages.
* Structures mark dirty rows inside ``Arena.epoch()``; the epoch exit
  drains the write set once (core/writeset.py): rows deduplicated, lines
  coalesced across the operation, data regions before header regions.
  Flush cost is accounted in 64 B lines, with the optional synthetic
  per-line and per-fence latencies of the reference.
* ``commit()`` orders data before metadata: drain, flush the file, fence,
  then set the header's valid flag.  ``crash()`` drops all volatile
  state; ``reopen()`` copies each region back to the device.
* Order-snapshot regions (a ``.snap`` in the name) are metadata: they
  flush in the metadata phase, and their lines land in
  ``FlushStats.snapshot_lines``, never in ``lines``/``bytes``/``calls``.
  Request-journal rings (a ``.jrnl`` in the name) are data-phase regions
  whose lines land in ``FlushStats.journal_lines`` the same way.
  The structures register snapshot providers that every drain asks for
  their dirty rows; the one-line record format is at the end of this
  module (the reference's, byte for byte).
* Integrity sidecars (DESIGN.md §13, on unless ``integrity=False`` or
  ``REPRO_INTEGRITY=0``): ``finalize`` appends one ``<region>.integ``
  region of per-line checksums after every declared region, for each
  data region with 8-byte-divisible rows, so an integrity-off layout is a
  prefix of the integrity-on one.  The epoch drain computes the checksums
  from the same staged host rows it writes, in the same phase, and their
  lines land in ``FlushStats.integrity_lines``.  ``scrub`` /
  ``verify_region`` recompute them over the persistent image (host numpy,
  as the reference) and name the rows that fail; ``verify_header`` raises
  ``ManifestError`` on a scribbled header magic, and a backing file
  shorter than the layout raises ``ShardLossError`` before it is mapped.
  ``_salvage`` is set by a salvage recovery for its duration.
* ``ShardedArena`` (DESIGN.md §7, ``open_arena(n_shards > 1)``) splits the
  persistent bytes across N backing files ``{path}.s{k}``, each a plain
  ``Arena`` with its own commit header, plus a manifest ``{path}.manifest``
  written LAST: the cross-shard generation is the one every shard has
  reached.  A ``ShardedRegion`` keeps ONE full-shape volatile tensor on
  the device, indexed by global row; its rows route to shards by a pure
  function of the row index (``route_rows``; the layouts' third entry).
  The epoch drain gathers every shard's rows in one grouped gather and
  keeps the data-before-metadata barrier global across the shards; a
  shard's reload is one upload of its slice, seated by ``scatter_rows_``.
  The files are the reference's, byte for byte.

* Shadow commit (DESIGN.md §9, ``Arena(commit_mode="shadow")``): the
  epoch drain is ONE unordered phase.  Rows marked ``fresh`` (never
  reachable from a committed generation) go home in place; every other row
  goes into the mirror of the target remap bank (bank ``(generation + 1) %
  2``, slot = row), and a row's first rewrite appends a ``(region id,
  row)`` entry to the bank.  A covered row's checksums follow it into the
  sidecar's own mirror in the same bank.  ``commit()`` folds the committed
  bank home, drains, seals the target bank's entry count on the meta line,
  pays ONE fence and flips the header's generation: the flip makes the
  target bank authoritative, and a crash before it leaves the committed
  bank as it was.  The fold of a committed bank into its home rows is
  deferred to the start of the next drain.  ``reopen()`` parses the bank
  the committed generation selects from the persistent image alone, and
  every load, ``scrub`` and salvage read the home rows with that bank's
  rows over them (``_pimage``).  The layout (meta line, two entry banks,
  a mirror per region per bank, after the last region) and every byte
  are the reference's.  Recovery writes nothing.
* Shadow commit on a ``ShardedArena``: every shard is a shadow ``Arena``
  with its own banks.  The drain stays ONE grouped gather over all
  shards, and each shard with work folds its committed bank, then takes
  its rewrites and fresh rows.  ``commit()`` folds every shard, drains,
  seals every shard, pays ONE fence, flips the shards' headers and
  writes the manifest last; ``_crash_after_shard=-1`` crashes between
  the seals and the first flip.  The MANIFEST's generation selects each
  shard's authoritative bank on ``reopen()``, so a shard whose header
  flipped ahead of a torn manifest overlays (and next targets) the
  bank the manifest's parity names.  A shard's pinned reload lays its
  bank's rows over the staged host bytes before the one upload.

The arena runs on ``cuda`` unless the caller passes ``device="cpu"``.  With
no device given and no GPU present it raises: it never falls back to the
CPU silently.  ``integrity=None`` and ``snapshot=None`` resolve through the
reference's env axes (``integrity_enabled``, ``snapshot_enabled``), both
on by default.

* Paged regions (DESIGN.md §12, ``paged=True`` or ``REPRO_PAGED=1``): a
  data region bigger than one block (``_paged_eligible``) keeps a device
  block pool behind an arena-wide LRU ``BlockCache`` of ``cache_blocks``
  blocks of ``block_bytes`` instead of one full-shape tensor
  (``core/paging.py``).  A ``ShardedArena`` keeps the one cache at the
  sharded level and opens its shards unpaged.  ``reopen`` resets paged
  regions lazily; the reconstructors fault what they touch.  The drain is
  the write-back: ``_note_flushed`` unpins the rows it wrote.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.writeset import (ShardedWriteSet, WriteSet, _row_lines,
                                      host_rows)
from repro_torch.kernels.pack_flush import scatter_rows_

LINE = 64                 # flush granularity (bytes) — paper's cache line
MEDIA_GRAIN = 256         # DCPMM internal granularity (§IV-D bucket sizing)
SLEEP_NS = 200_000        # a shard's synthetic stall this long sleeps

_MAGIC = b"RPRA"
_HDR_FMT = "<4sQQ?7x"     # magic, n_regions, generation, valid flag

_TORCH_DTYPES = {np.dtype(d): t for d, t in (
    (np.int64, torch.int64), (np.int32, torch.int32),
    (np.int16, torch.int16), (np.int8, torch.int8),
    (np.uint8, torch.uint8), (np.float64, torch.float64),
    (np.float32, torch.float32), (np.float16, torch.float16),
    (np.bool_, torch.bool))}


class IntegrityError(RuntimeError):
    """Base of the media-fault taxonomy: persistent bytes failed a trust
    check that power loss alone cannot produce (a checksum mismatch, a
    lost or short backing file, a garbage header magic)."""


class CorruptLineError(IntegrityError):
    """Committed persistent line(s) fail their sidecar checksum."""

    def __init__(self, region: str, rows, detail: str = ""):
        self.region = region
        self.rows = np.atleast_1d(np.asarray(rows, np.int64))
        msg = (f"corrupt line(s) in region {region!r}, "
               f"rows {self.rows[:8].tolist()}"
               + (f" (+{self.rows.size - 8} more)"
                  if self.rows.size > 8 else ""))
        super().__init__(msg + (f": {detail}" if detail else ""))


class ShardLossError(IntegrityError):
    """A backing file is missing or truncated: media loss, not a torn
    commit."""


class ManifestError(IntegrityError):
    """The arena's commit header, the trust anchor everything else hangs
    off, carries a garbage magic."""


class QuarantinedError(RuntimeError):
    """A request touched keys a salvage recovery quarantined: refusing is
    the contract, serving reconstructed garbage is not."""


def not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet (see ROADMAP Queue 1)")


def snapshot_enabled(flag: Optional[bool] = None) -> bool:
    """Resolve a structure's ``snapshot=`` argument as the reference does:
    an explicit flag wins; ``None`` defers to ``REPRO_SNAPSHOT`` (default
    on)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_SNAPSHOT", "1") != "0"


def journal_enabled(flag: Optional[bool] = None) -> bool:
    """Resolve a structure's ``journal=`` argument as the reference does:
    an explicit flag wins; ``None`` defers to ``REPRO_JOURNAL`` (default
    on)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_JOURNAL", "1") != "0"


def paged_enabled(flag: Optional[bool] = None) -> bool:
    """Resolve an arena's ``paged=`` argument as the reference does: an
    explicit flag wins; ``None`` defers to ``REPRO_PAGED`` (default
    off)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_PAGED", "0") != "0"


def integrity_enabled(flag: Optional[bool] = None) -> bool:
    """Resolve an arena's ``integrity=`` argument as the reference does:
    an explicit flag wins; ``None`` defers to ``REPRO_INTEGRITY`` (default
    on)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_INTEGRITY", "1") != "0"


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU, and raises when
    there is none.  A CUDA device without an index gets the current one,
    so it compares equal to the device its tensors report."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch runs on a CUDA device; none is "
                               "available (pass device='cpu' to run on the "
                               "CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass
class FlushStats:
    lines: int = 0
    bytes: int = 0
    calls: int = 0
    fence_ns: int = 0      # synthetic latency accumulated (if enabled)
    fences: int = 0        # ordering points paid (barrier phases + commits)
    # epoch-flush (write-set) counters
    epochs: int = 0        # batched epoch flushes performed
    marks: int = 0         # mark_rows calls absorbed by the write set
    dedup_rows: int = 0    # row marks dropped as duplicates within an epoch
    saved_lines: int = 0   # lines one accounting call PER MARK would have
                           # charged minus lines the epoch flush charged
    # order-snapshot lines, kept out of lines/bytes/calls/saved_lines so
    # the data accounting stays equal to a snapshot-off run
    snapshot_lines: int = 0
    # request-journal ring lines and checksum-sidecar lines, kept out of
    # the data counters the same way
    journal_lines: int = 0
    integrity_lines: int = 0

    def snapshot(self) -> "FlushStats":
        return dataclasses.replace(self)

    def delta(self, since: "FlushStats") -> "FlushStats":
        return FlushStats(*(getattr(self, f.name) - getattr(since, f.name)
                            for f in dataclasses.fields(self)))


class _RowAccess:
    """What ``Region`` and ``ShardedRegion`` share: the region's kind and
    sizes, range forms of marking and persisting, and the row accessors,
    views and copies of the volatile tensor ``vol`` on the arena's device
    (only ``read_one`` and ``read_row`` bring a value to the host).  The
    paged regions of ``core/paging.py`` override the accessors to route
    through the block cache; here the paging hooks are no-ops."""

    is_paged = False

    def _declare(self, name: str, dtype, shape: Tuple[int, ...],
                 meta: Optional[bool]) -> None:
        self.name = name
        self.dtype = np.dtype(dtype)
        if self.dtype not in _TORCH_DTYPES:
            raise TypeError(f"region {name!r}: no torch dtype for "
                            f"{self.dtype}")
        self.tdtype = _TORCH_DTYPES[self.dtype]
        self.shape = tuple(int(s) for s in shape)
        # order-snapshot regions: derivable mirrors, accounted apart
        self.snap = ".snap" in name
        # request-journal rings: data-phase regions (an entry becomes
        # visible through the committed head on a metadata line), accounted
        # in FlushStats.journal_lines
        self.jrnl = ".jrnl" in name
        # integrity sidecars: per-line checksums of a data region, written
        # by the drain that moves the data rows (never marked), accounted
        # in FlushStats.integrity_lines
        self.integ = name.endswith(".integ")
        self._integ: Optional["Region"] = None   # my sidecar, if covered
        # Metadata regions (structure headers, order snapshots) flush
        # AFTER data regions within an epoch — data-before-metadata
        # ordering; a torn data phase never leaves half a snapshot behind
        # the committed header.
        self.meta = (name.endswith("header") or self.snap) \
            if meta is None else meta
        self.rowbytes = int(self.dtype.itemsize
                            * np.prod(self.shape[1:], dtype=np.int64)) \
            if len(self.shape) > 1 else self.dtype.itemsize
        self.nbytes = self.rowbytes * self.shape[0]

    def mark_range(self, lo: int, hi: int, fresh: bool = False) -> None:
        if hi > lo:
            self.mark_rows(np.arange(lo, hi, dtype=np.int64), fresh=fresh)

    def persist_all(self) -> None:
        self.persist_range(0, self.shape[0])

    def read_row(self, i: int) -> np.ndarray:
        """Host copy of volatile row i (one device sync on a card)."""
        return self.vol[i].cpu().numpy().copy()

    def write_row(self, i: int, row: np.ndarray) -> None:
        self.vol[i] = torch.from_numpy(row).to(self.vol.device)

    def read_rows(self, rows) -> torch.Tensor:
        return self.vol[self._idx(rows)]

    def read_at(self, rows, col) -> torch.Tensor:
        return self.vol[self._idx(rows), col]

    def read_one(self, row, col: int) -> int:
        """One element as a Python int (``row`` an int or a 0-d tensor).
        On a card-resident region this is one device sync."""
        return int(self.vol[row, col])

    def read_col(self, col) -> torch.Tensor:
        return self.vol[:, col]

    def write_rows(self, rows, vals) -> None:
        self.vol[self._idx(rows)] = self._val(vals)

    def write_at(self, rows, col, vals) -> None:
        self.vol[self._idx(rows), col] = self._val(vals)

    def _idx(self, rows):
        if isinstance(rows, (int, np.integer)):
            return int(rows)
        if isinstance(rows, torch.Tensor):
            return rows.to(self.arena.device, torch.int64)
        return torch.as_tensor(np.asarray(rows, np.int64),
                               device=self.arena.device)

    def _val(self, vals):
        if isinstance(vals, (int, float)):
            return vals
        if isinstance(vals, torch.Tensor):
            return vals.to(self.arena.device, self.tdtype)
        return torch.as_tensor(np.asarray(vals), dtype=self.tdtype,
                               device=self.arena.device)

    # -- paging hooks (no-ops on resident regions) ------------------------
    def _note_flushed(self, rows: np.ndarray) -> None:
        """Rows just written persistent by the drain: a paged region
        unpins their blocks."""

    def _note_persisted(self, rows: np.ndarray) -> None:
        """Rows just written home by a direct persist: a paged region
        unpins them except where a shadow bank still remaps them."""

    def _note_persisted_range(self, lo: int, hi: int) -> None:
        pass

    def _persist_script(self, rows: np.ndarray, integ) -> list:
        """The cache bookkeeping of a direct persist of ``rows``, in the
        reference's order (``core/paging.drain_positions``): the gather,
        the note, and the second gather ``_integrity_home`` makes for a
        covered region."""
        if not self.is_paged:
            return []
        out = [("read", self, rows), ("persisted", self, rows)]
        if integ is not None:
            out.append(("read", self, rows))
        return out


class Region(_RowAccess):
    """A named, row-structured persistent region."""

    def __init__(self, arena: "Arena", name: str, dtype,
                 shape: Tuple[int, ...], offset: int,
                 meta: Optional[bool] = None):
        self.arena = arena
        self.offset = offset
        self._declare(name, dtype, shape, meta)
        self._init_vol()

    def _init_vol(self) -> None:
        """The volatile state at creation (a paged region: its pool)."""
        self._crash_reset()

    def _crash_reset(self) -> None:
        """Volatile copy zeroed: creation, and a simulated power loss."""
        self.vol = torch.zeros(self.shape, dtype=self.tdtype,
                               device=self.arena.device)

    # -- persistence ------------------------------------------------------
    def _pview(self) -> np.ndarray:
        return self.arena._mm_view(self.offset, self.nbytes, self.dtype,
                                   self.shape)

    def persist_rows(self, rows) -> None:
        """Flush the given row indices (volatile -> persistent) NOW, with
        per-call line accounting.  Structures prefer ``mark_rows``."""
        rows = np.unique(host_rows(rows))
        if rows.size == 0:
            return
        ws = self.arena.writeset
        host = ws._gather_paged([(self, rows)], lambda: self._persist_script(
            rows, self._integ))[0]
        self._pview()[rows] = host
        self.arena._account_rows(self.offset, self.rowbytes, rows,
                                 snap=self.snap, jrnl=self.jrnl,
                                 integ=self.integ)
        ws.seat_sidecars([self.arena._integrity_home(self, rows, host)])

    def mark_rows(self, rows, fresh: bool = False) -> None:
        """Add rows to the arena's write set (flushed once, deduplicated,
        when the enclosing epoch closes); outside any epoch this is an
        immediate ``persist_rows``, which writes home in either mode.
        ``fresh`` asserts the rows were never reachable from a committed
        generation, so a shadow drain writes them home in place instead of
        through the remap; barrier mode ignores it."""
        if self.arena._epoch_depth > 0:
            self.arena.writeset.mark(self, rows, fresh=fresh)
        else:
            self.persist_rows(rows)

    def persist_range(self, lo: int, hi: int) -> None:
        """Flush rows [lo, hi) NOW: one download of the slice, accounted as
        one contiguous byte range (the reference's ``_account_range``)."""
        if hi <= lo:
            return
        if self.is_paged:
            rows = np.arange(lo, hi, dtype=np.int64)
            host = self.arena.writeset.gather(
                [(self, rows)], script=self._persist_script(rows,
                                                            self._integ))[0]
        else:
            host = self.vol[lo:hi].cpu().numpy()
        self._pview()[lo:hi] = host
        self.arena._account_range(self.offset + lo * self.rowbytes,
                                  (hi - lo) * self.rowbytes, snap=self.snap,
                                  jrnl=self.jrnl, integ=self.integ)
        self.arena.writeset.seat_sidecars([self.arena._integrity_home(
            self, np.arange(lo, hi, dtype=np.int64), host)])

    def load(self) -> None:
        """Reload the volatile copy from persistent memory (post-crash):
        the home rows, with the authoritative shadow bank's rows laid over
        them on the host copy before its upload, paying the synthetic
        media read latency when the arena models one."""
        img = np.array(self._pview())
        self.arena._shadow_overlay(self, img)
        self.vol = torch.from_numpy(img).to(self.arena.device)
        self.arena.synth_read(self.nbytes)


class Arena:
    """Host-image persistent arena with device-resident volatile regions
    and flush accounting."""

    def __init__(self, path: Optional[str], synth_line_ns: float = 0.0,
                 pack_flush_rows: int = 0, commit_mode: str = "barrier",
                 synth_fence_ns: float = 0.0, paged: Optional[bool] = None,
                 block_bytes: int = 4096, cache_blocks: int = 1024,
                 integrity: Optional[bool] = None, device=None):
        """The reference's parameters in the reference's order, then
        ``device``.  ``pack_flush_rows`` is kept for that order and read
        nowhere: the reference gathers a drain's rows through its Pallas
        ``pack_rows`` when a region has at least that many and through
        numpy otherwise, with the same bytes either way; here every drain
        gathers through the grouped ``pack_rows`` kernel, so the value
        changes no byte, no FlushStats field and no launch count."""
        if commit_mode not in ("barrier", "shadow"):
            raise ValueError(f"unknown commit_mode {commit_mode!r}")
        self.pack_flush_rows = int(pack_flush_rows)
        self.device = resolve_device(device)
        # paged regions fault fixed-size blocks through one arena-wide
        # cache instead of holding a full-shape tensor each
        self.paged = paged_enabled(paged)
        self.block_bytes = int(block_bytes)
        self.cache_blocks = int(cache_blocks)
        self.cache = _block_cache(self)
        self.path = path
        self.regions: Dict[str, Region] = {}
        self.stats = FlushStats()
        self.integrity = integrity_enabled(integrity)
        # set by a salvage recovery for its duration: reconstructors may
        # verify their regions and drop the rows that fail
        self._salvage = False
        self.synth_line_ns = synth_line_ns
        self.synth_fence_ns = synth_fence_ns
        self.commit_mode = commit_mode
        # a sharded parent sets this: its shards' big stalls then sleep, so
        # the stalls of shards flushing or loading in the pool overlap
        self.synth_sleep = False
        # per-region load stages may stall one shard from several threads
        self._fence_lock = threading.Lock()
        self._defer = False
        self._defer_ns = 0
        self.writeset = WriteSet(self)
        self._epoch_depth = 0
        self._layout_final = False
        self._mm: Optional[np.ndarray] = None
        # typed views of the image (``_mm_view``), for the image they view
        self._views: Dict[tuple, np.ndarray] = {}
        self._views_of: Optional[np.ndarray] = None
        self._cursor = 4096  # header page
        self._meta: Dict[str, dict] = {}
        self.generation = 0
        # order-snapshot providers: callables returning [(region, rows)]
        # of snapshot rows to persist, asked at every write-set drain
        self._snap_providers: List = []
        # shadow-commit state, all volatile: region ids in declaration
        # order (the remap entries name them), the persistent areas'
        # offsets (laid out by finalize), and per bank the rows it remaps
        # ({region name: bool mask}), its entry count and whether it has
        # been folded home
        self._region_ids: Dict[str, int] = {}
        self._shadow_meta_off = 0
        self._shadow_ent_off = [0, 0]
        self._shadow_cap = 0
        self._shadow_masks: Tuple[Dict[str, np.ndarray], ...] = ({}, {})
        self._shadow_counts = [0, 0]
        self._shadow_collapsed = [True, True]
        self._shadow_auth_bank = 0

    # -- epochs -----------------------------------------------------------
    @contextlib.contextmanager
    def epoch(self):
        """One logical operation: ``mark_rows`` calls inside the block
        accumulate in the write set; the outermost epoch exit flushes them
        once."""
        self._epoch_depth += 1
        try:
            yield self
        finally:
            self._epoch_depth -= 1
            if self._epoch_depth == 0:
                self.writeset.flush()

    # -- layout -----------------------------------------------------------
    def region(self, name: str, dtype, shape: Tuple[int, ...],
               meta: Optional[bool] = None, router=None, _cls=None,
               **slice_kw) -> Region:
        """Declare a region.  ``router`` (a row-to-shard spec of the
        layouts) is accepted for ``ShardedArena``'s sake and ignored: a
        single arena is one shard."""
        if self._layout_final:
            raise RuntimeError("layout already finalized")
        if name in self.regions:
            raise ValueError(f"region {name!r} already declared")
        # Row-align every region to LINE so a row flush never straddles an
        # unrelated region (paper: __attribute__((aligned(64)))).
        self._cursor = _align(self._cursor, LINE)
        cls = _cls or Region
        if cls is Region and self.cache is not None and _paged_eligible(
                name, meta, dtype, shape, self.block_bytes):
            from repro_torch.core.paging import PagedRegion
            cls = PagedRegion
        r = cls(self, name, dtype, shape, self._cursor, meta=meta,
                **slice_kw)
        self._cursor += _align(r.nbytes, LINE)
        self.regions[name] = r
        self._region_ids[name] = len(self._region_ids)
        self._meta[name] = {"dtype": np.dtype(dtype).str,
                            "shape": list(shape), "offset": r.offset}
        return r

    def finalize(self) -> None:
        if self._layout_final:
            raise RuntimeError("layout already finalized")
        if self.integrity:
            self._integrity_layout()
        self._layout_final = True
        if self.commit_mode == "shadow":
            self._shadow_layout()
        total = _align(self._cursor, 4096)
        if self.path is None:
            self._mm = np.zeros(total, np.uint8)  # in-memory image
        else:
            create = not os.path.exists(self.path)
            if create:
                with open(self.path, "wb") as f:
                    f.truncate(total)
            elif os.path.getsize(self.path) < total:
                # media loss, checked BEFORE mapping: np.memmap in r+ mode
                # would re-extend a short file with zeros, which also wipe
                # the sidecars back to the never-written sentinel and hide
                # the loss from scrub
                raise ShardLossError(
                    f"backing file {self.path!r} truncated: "
                    f"{os.path.getsize(self.path)} < {total} bytes")
            try:
                self._mm = np.memmap(self.path, dtype=np.uint8, mode="r+",
                                     shape=(total,))
            except (ValueError, OSError) as e:
                raise ShardLossError(
                    f"backing file {self.path!r} unmappable at {total} "
                    f"bytes: {e}") from e
            if create:
                self._write_header(valid=False)
            with open(self.path + ".layout", "w") as f:
                json.dump(self._meta, f)

    def region_shards(self, name: str, rows) -> np.ndarray:
        """Shard id of each row of region ``name``: all zeros on this
        single arena (callers group work per shard either way)."""
        return np.zeros(len(np.atleast_1d(rows)), np.int64)

    def add_snapshot_provider(self, fn) -> None:
        """Register an order-snapshot provider: a callable returning
        ``[(region, rows), ...]`` of snapshot-region rows to persist,
        asked by the write set at every drain."""
        self._snap_providers.append(fn)

    # -- integrity sidecars (DESIGN.md §13) --------------------------------
    def _integrity_layout(self) -> None:
        """Append one checksum sidecar per covered data region: int64 rows
        of shape (rows, chunks), a word per 64 B line of the source row (a
        word per row for sub-line rows).  Appended after every declared
        region, so no region's offset moves."""
        for name, r in list(self.regions.items()):
            if r.meta or r.snap or r.jrnl or r.integ or r.rowbytes % 8:
                continue
            r._integ = self.region(name + ".integ", np.int64,
                                   (r.shape[0], _integ_chunks(r.rowbytes)),
                                   meta=False)

    def _integrity_home(self, region: Region, rows: np.ndarray,
                        data: np.ndarray):
        """Checksum ``data`` (the host copy of ``rows`` just written home),
        persist the checksums into the sidecar's image and account their
        lines: the data and its checksums move in one flush phase, so a
        torn crash never splits them.  Returns ``(sidecar, rows,
        checksums)`` for the write set to seat in the sidecar's volatile
        tensor (one upload per drain), or None for an uncovered region."""
        sc = region._integ
        if sc is None or rows.size == 0:
            return None
        ck = sidecar_checksums(data, sc.shape[1])
        sc._pview()[rows] = ck
        self._account_rows(sc.offset, sc.rowbytes, rows, integ=True)
        return sc, rows, ck

    def verify_header(self) -> None:
        """Raise ManifestError when the commit header's magic is neither
        ours nor the all-zero never-committed state: field corruption that
        power loss cannot produce (the header is one atomic line)."""
        raw = bytes(self._mm[:4])
        if raw not in (_MAGIC, b"\x00\x00\x00\x00"):
            raise ManifestError(
                f"arena {self.path!r} header magic {raw!r} corrupt")

    def _pimage(self, region: Region, copy: bool = True) -> np.ndarray:
        """The region's COMMITTED persistent image: its home bytes, with
        the authoritative shadow bank's rows over them in shadow mode.  A
        copy, or with ``copy=False`` the home view itself when no bank row
        overlays it (for readers only).  Scrub and salvage read through
        it and never write persistent state."""
        rows = self._shadow_rows(region)
        if rows is None:
            return np.array(region._pview()) if copy else region._pview()
        img = np.array(region._pview())
        img[rows] = self._shadow_mirror(region, self._shadow_auth_bank)[rows]
        return img

    def verify_region(self, region) -> np.ndarray:
        """Row indices of ``region`` whose persistent bytes fail their
        sidecar checksums (empty = clean).  Reads the persistent image
        only, so in-flight volatile writes and pending marks are invisible
        to it, and rows never flushed carry the 0 "no checksum" sentinel
        and are skipped: scrub under traffic cannot false-positive."""
        if isinstance(region, str):
            region = self.regions[region]
        sc = region._integ
        if sc is None:
            return np.empty(0, np.int64)
        # read-only views stand in for the reference's copies where no
        # shadow bank row overlays the home rows
        ck = sidecar_checksums(self._pimage(region, copy=False), sc.shape[1])
        ref = self._pimage(sc, copy=False)
        bad = (ref != 0) & (ck != ref)
        self.synth_read(region.nbytes + sc.nbytes)
        return np.nonzero(bad.any(axis=1))[0]

    def scrub(self, raise_on_error: bool = False
              ) -> Dict[str, np.ndarray]:
        """Verify every covered region against its sidecar; returns
        ``{region name: bad rows}`` for the regions that fail (empty dict =
        media clean).  Read-only and crash-safe at any instant."""
        bad: Dict[str, np.ndarray] = {}
        for name, r in self.regions.items():
            if r._integ is None:
                continue
            rows = self.verify_region(r)
            if rows.size:
                bad[name] = rows
        if bad and raise_on_error:
            name, rows = next(iter(bad.items()))
            raise CorruptLineError(name, rows,
                                   detail=f"scrub: {len(bad)} region(s)")
        return bad

    # -- header / commit protocol -----------------------------------------
    def _write_header(self, valid: bool) -> None:
        hdr = struct.pack(_HDR_FMT, _MAGIC, len(self.regions),
                          self.generation, valid)
        self._mm[: len(hdr)] = np.frombuffer(hdr, np.uint8)

    def header_valid(self) -> bool:
        raw = bytes(self._mm[: struct.calcsize(_HDR_FMT)])
        magic, _, _, valid = struct.unpack(_HDR_FMT, raw)
        return magic == _MAGIC and bool(valid)

    def header_generation(self) -> int:
        """Committed generation as persisted in the header — survives a
        fresh-process reopen, unlike the in-memory ``generation``."""
        raw = bytes(self._mm[: struct.calcsize(_HDR_FMT)])
        magic, _, gen, _ = struct.unpack(_HDR_FMT, raw)
        return int(gen) if magic == _MAGIC else 0

    def commit(self) -> None:
        """Data-before-metadata ordering: drain the write set, flush file
        contents, fence, then set the valid flag.  In shadow mode the
        protocol is ONE ordering point (``_commit_shadow``)."""
        if self.commit_mode == "shadow":
            self._commit_shadow()
            return
        self.writeset.flush()
        if isinstance(self._mm, np.memmap):
            self._mm.flush()
        self._fence()
        self.generation += 1
        self._write_header(valid=True)
        if isinstance(self._mm, np.memmap):
            self._mm.flush()
        self.stats.calls += 1

    def invalidate(self) -> None:
        """Clear the header's valid flag (the generation stays)."""
        self._write_header(valid=False)

    def _fence(self) -> None:
        """One ordering point, counted and paid synthetically when
        ``synth_fence_ns`` models the stall."""
        self.stats.fences += 1
        if self.synth_fence_ns:
            self._stall(int(self.synth_fence_ns))

    # -- shadow commit protocol (DESIGN.md §9) ------------------------------
    def _shadow_layout(self) -> None:
        """The persistent shadow areas, after the last region: one meta
        line holding each bank's sealed entry count, two remap-entry banks
        of 16 B entries (the epoch targeting generation T writes bank
        T % 2, so a torn flip never touches the committed bank), and a
        mirror of every region, sidecars included, per bank, whose slot
        index is the row index."""
        cur = _align(self._cursor, LINE)
        self._shadow_meta_off = cur
        cur += LINE
        self._shadow_cap = max(1, sum(r.shape[0]
                                      for r in self.regions.values()))
        for b in (0, 1):
            self._shadow_ent_off[b] = cur
            cur += _align(self._shadow_cap * 16, LINE)
        for r in self.regions.values():
            r._shadow_off = {}
            for b in (0, 1):
                r._shadow_off[b] = cur
                cur += _align(r.nbytes, LINE)
        self._cursor = cur

    def _shadow_target_bank(self) -> int:
        return (self.generation + 1) % 2

    def _mm_view(self, offset: int, nbytes: int, dtype, shape) -> np.ndarray:
        """A typed view of ``nbytes`` of the persistent image at
        ``offset``, kept while the image stays mapped: a drain asks for
        the same regions' views many times an epoch."""
        mm = self._mm
        if self._views_of is not mm:
            self._views, self._views_of = {}, mm
        key = (offset, nbytes, dtype, shape)
        v = self._views.get(key)
        if v is None:
            v = self._views[key] = np.frombuffer(
                mm, dtype=np.uint8, count=nbytes,
                offset=offset).view(dtype).reshape(shape)
        return v

    def _shadow_mirror(self, region: Region, bank: int) -> np.ndarray:
        return self._mm_view(region._shadow_off[bank], region.nbytes,
                             region.dtype, region.shape)

    def _shadow_entries(self, bank: int) -> np.ndarray:
        return self._mm_view(self._shadow_ent_off[bank],
                             self._shadow_cap * 16, np.dtype(np.int64),
                             (self._shadow_cap, 2))

    def _shadow_meta_view(self) -> np.ndarray:
        return self._mm_view(self._shadow_meta_off, LINE,
                             np.dtype(np.int64), (LINE // 8,))

    def _shadow_rows(self, region: Region) -> Optional[np.ndarray]:
        """Rows of ``region`` the authoritative bank remaps, or None (none,
        or a barrier arena)."""
        if self.commit_mode != "shadow":
            return None
        mask = self._shadow_masks[self._shadow_auth_bank].get(region.name)
        if mask is None:
            return None
        rows = np.nonzero(mask)[0]
        return rows if rows.size else None

    def _shadow_write(self, region: Region, rows: np.ndarray,
                      data: np.ndarray):
        """Route a rewrite through the remap: ``data`` (the host copy of
        the sorted unique ``rows``) lands in the target bank's mirror, and
        rows the bank does not remap yet append ``(region id, row)``
        entries.  Committed home rows are never written before the flip.
        A covered region's checksums of ``data`` cascade into its sidecar's
        mirror in the same bank, so a discarded bank drops data and
        checksums together.  Returns the sidecar's ``(sidecar, rows,
        checksums)`` for the write set to seat in its volatile tensor, or
        None."""
        b = self._shadow_target_bank()
        mask = self._shadow_masks[b].get(region.name)
        if mask is None:
            # the bank's first rows of this region: all of them are new
            mask = self._shadow_masks[b][region.name] = \
                np.zeros(region.shape[0], bool)
            new = rows
        else:
            new = rows[~mask[rows]]
        mask[rows] = True
        self._shadow_mirror(region, b)[rows] = data
        self._account_rows(region._shadow_off[b], region.rowbytes, rows,
                           snap=region.snap, jrnl=region.jrnl,
                           integ=region.integ)
        if new.size:
            cnt = self._shadow_counts[b]
            ents = self._shadow_entries(b)
            ents[cnt:cnt + new.size, 0] = self._region_ids[region.name]
            ents[cnt:cnt + new.size, 1] = new
            self._account_range(self._shadow_ent_off[b] + cnt * 16,
                                int(new.size) * 16, snap=region.snap,
                                jrnl=region.jrnl, integ=region.integ)
            self._shadow_counts[b] = cnt + int(new.size)
        sc = region._integ
        if sc is None:
            return None
        ck = sidecar_checksums(data, sc.shape[1])
        self._shadow_write(sc, rows, ck)
        return sc, rows, ck

    def _shadow_collapse(self, limit: Optional[int] = None) -> bool:
        """Fold the committed bank's rows into their home slots: the
        reclamation deferred from the commit that made them into the next
        drain.  The copy is value-identical to what recovery would overlay,
        so a crash at any instant during it changes nothing the committed
        generation shows.  ``limit`` bounds the regions folded (the crash
        hook); returns whether the bank fully collapsed."""
        b = self.generation % 2
        if self._shadow_collapsed[b]:
            return True
        done = True
        for i, name in enumerate(sorted(self._shadow_masks[b])):
            if limit is not None and i >= limit:
                done = False
                break
            rows = np.nonzero(self._shadow_masks[b][name])[0]
            if rows.size == 0:
                continue
            region = self.regions[name]
            region._pview()[rows] = self._shadow_mirror(region, b)[rows]
            self._account_rows(region.offset, region.rowbytes, rows,
                               snap=region.snap, jrnl=region.jrnl,
                               integ=region.integ)
        if done:
            self._shadow_collapsed[b] = True
        return done

    def _fold_lines(self) -> int:
        """About the lines a fold of the committed bank writes home (a line
        a sub-line row), 0 once it has collapsed."""
        b = self.generation % 2
        if self._shadow_collapsed[b]:
            return 0
        return sum(int(np.count_nonzero(m)) * _row_lines(self.regions[n])
                   for n, m in self._shadow_masks[b].items())

    def _shadow_seal(self) -> None:
        """Persist the target bank's entry count.  Safe before the flip:
        the bank is dead until the generation selects it, and the
        committed bank's count is untouched."""
        b = self._shadow_target_bank()
        self._shadow_meta_view()[b] = self._shadow_counts[b]
        self._account_range(self._shadow_meta_off + b * 8, 8)

    def _shadow_retire(self) -> None:
        """After the flip: the previous bank's entries are dead (folded
        home before it); the newly committed bank waits for its fold at
        the next drain."""
        live = self.generation % 2
        dead = 1 - live
        self._shadow_masks[dead].clear()
        self._shadow_counts[dead] = 0
        self._shadow_collapsed[dead] = True
        self._shadow_collapsed[live] = self._shadow_counts[live] == 0
        self._shadow_auth_bank = live

    def _commit_shadow(self) -> None:
        """Shadow commit: fold the committed bank home, drain (fresh rows
        home, rewrites into the target bank), seal the target bank's
        count, then the ONE fence and the generation flip, which makes the
        target bank authoritative.  A torn flip leaves the committed bank
        authoritative; the orphaned target bank is never selected."""
        self._shadow_collapse()
        self.writeset.flush()
        self._shadow_seal()
        if isinstance(self._mm, np.memmap):
            self._mm.flush()
        self._fence()                      # the single ordering point
        self.generation += 1
        self._write_header(valid=True)
        if isinstance(self._mm, np.memmap):
            self._mm.flush()
        self.stats.calls += 1
        self._shadow_retire()

    def _shadow_discard(self) -> None:
        """The volatile shadow bookkeeping dies with a crash; ``reopen``
        parses it again from the committed bank."""
        for m in self._shadow_masks:
            m.clear()
        self._shadow_counts = [0, 0]
        self._shadow_collapsed = [True, True]

    def _shadow_parse(self, authority_gen: Optional[int] = None) -> None:
        """After a crash: rebuild the masks from the bank the COMMITTED
        generation selects, reading the persistent image only, and
        re-anchor ``generation`` to it, so the next drain targets bank
        ``(gen + 1) % 2``.  The committed generation is the header's, or
        ``authority_gen`` for a shard: its manifest's, which a header that
        flipped ahead of a torn manifest write outruns.  The other bank's
        entries (a torn flip's orphans) are never selected, and are
        overwritten when that bank is next targeted."""
        if self.commit_mode != "shadow":
            return
        gen = self.header_generation() if authority_gen is None \
            else int(authority_gen)
        b = gen % 2
        cnt = int(self._shadow_meta_view()[b])
        ents = np.array(self._shadow_entries(b)[:cnt])
        masks: Dict[str, np.ndarray] = {}
        names = list(self.regions)
        for rid in (np.unique(ents[:, 0]) if cnt else ()):
            name = names[int(rid)]
            mask = np.zeros(self.regions[name].shape[0], bool)
            mask[ents[ents[:, 0] == rid, 1]] = True
            masks[name] = mask
        self._shadow_masks = (masks, {}) if b == 0 else ({}, masks)
        self._shadow_counts = [cnt, 0] if b == 0 else [0, cnt]
        self._shadow_collapsed = [True, True]
        self._shadow_collapsed[b] = cnt == 0
        self._shadow_auth_bank = b
        self.generation = gen

    def _shadow_overlay(self, region: Region, img: np.ndarray) -> None:
        """Lay the authoritative bank's rows of ``region`` over ``img``, a
        host copy of its home rows being loaded: recovery-side and
        volatile-only (the fold waits for the next drain)."""
        rows = self._shadow_rows(region)
        if rows is None:
            return
        img[rows] = self._shadow_mirror(region, self._shadow_auth_bank)[rows]
        self.synth_read(int(rows.size) * region.rowbytes)

    # -- crash simulation ---------------------------------------------------
    def crash(self) -> None:
        """Discard all volatile state (keep the persistent image); pending
        write-set marks and the shadow bookkeeping die with it."""
        self.writeset.discard()
        self._shadow_discard()
        for r in self.regions.values():
            r._crash_reset()

    def reopen(self) -> None:
        """Copy every region back to the device from the persistent image,
        and re-anchor the in-memory generation to the committed one.  A
        shadow arena first parses the committed bank, so each load lays
        its rows over the home rows.  A paged region's load is a lazy
        reset of its pool."""
        self._shadow_parse()
        for r in self.regions.values():
            r.load()
        self.generation = max(self.generation, self.header_generation())

    # -- accounting ---------------------------------------------------------
    def _account_range(self, byte_off: int, nbytes: int, snap: bool = False,
                       jrnl: bool = False, integ: bool = False) -> None:
        """Account one contiguous byte range: the lines it touches."""
        lines = (_align(byte_off + nbytes, LINE)
                 - (byte_off // LINE) * LINE) // LINE
        self._account_lines(lines, nbytes, snap, jrnl, integ)

    @staticmethod
    def _rows_line_count(base: int, rowbytes: int, rows: np.ndarray) -> int:
        """Distinct 64 B lines touched by flushing `rows` (sorted unique)."""
        if rowbytes % LINE == 0 and base % LINE == 0:
            return int(rows.size) * (rowbytes // LINE)
        if rowbytes and LINE % rowbytes == 0 and base % LINE == 0:
            # sub-line rows that tile lines exactly: sorted-unique rows
            # sharing a line are adjacent, so distinct lines = breaks + 1
            per = LINE // rowbytes
            if rows.size == 0:
                return 0
            return int(np.count_nonzero(np.diff(rows // per))) + 1
        # exact distinct-line count over sorted row intervals (adjacent
        # rows may share a line — the Fig-12 unaligned-flush effect)
        starts = (base + rows * rowbytes) // LINE
        ends = (base + (rows + 1) * rowbytes - 1) // LINE
        starts = np.maximum(starts,
                            np.concatenate(([-1], ends[:-1])) + 1)
        return int(np.sum(np.maximum(0, ends - starts + 1)))

    def _account_rows(self, base: int, rowbytes: int, rows: np.ndarray,
                      snap: bool = False, jrnl: bool = False,
                      integ: bool = False) -> None:
        self._account_lines(self._rows_line_count(base, rowbytes, rows),
                            int(rows.size) * rowbytes, snap, jrnl, integ)

    def _account_lines(self, lines: int, nbytes: int, snap: bool,
                       jrnl: bool, integ: bool) -> None:
        if snap or jrnl or integ:
            # snapshot, journal and sidecar lines are real media traffic
            # (they pay the synthetic stall) but stay out of the data
            # counters
            if snap:
                self.stats.snapshot_lines += lines
            elif jrnl:
                self.stats.journal_lines += lines
            else:
                self.stats.integrity_lines += lines
            self._synth(lines)
            return
        self.stats.lines += lines
        self.stats.bytes += nbytes
        self.stats.calls += 1
        self._synth(lines)

    def _synth(self, lines: int) -> None:
        if self.synth_line_ns:
            self._stall(int(lines * self.synth_line_ns))

    def synth_read(self, nbytes: int) -> None:
        """Synthetic media READ latency for a reload of `nbytes`, at 256 B
        media grains (zero-cost unless ``synth_line_ns`` is set)."""
        if self.synth_line_ns:
            grains = (nbytes + MEDIA_GRAIN - 1) // MEDIA_GRAIN
            self._stall(int(grains * self.synth_line_ns))

    @contextlib.contextmanager
    def stall_scope(self):
        """Aggregate synthetic stalls issued inside the block into ONE
        stall paid at exit; the ``fence_ns`` accounting is unchanged."""
        self._defer_ns = 0
        self._defer = True
        try:
            yield
        finally:
            self._defer = False
            ns, self._defer_ns = self._defer_ns, 0
            if ns:
                self._pay(ns)

    def _stall(self, ns: int) -> None:
        with self._fence_lock:
            self.stats.fence_ns += ns
        if self._defer:
            self._defer_ns += ns
            return
        self._pay(ns)

    def _pay(self, ns: int) -> None:
        if self.synth_sleep and ns >= SLEEP_NS:
            # a shard's big stalls sleep so that shards stalling in the
            # pool overlap; short ones spin (the timer's wake-up slack
            # would swamp them)
            time.sleep(ns * 1e-9)
            return
        t0 = time.perf_counter_ns()
        while time.perf_counter_ns() - t0 < ns:
            pass

    def close(self) -> None:
        if isinstance(self._mm, np.memmap):
            self._mm.flush()
        self._mm = None
        self._views, self._views_of = {}, None


def _align(x: int, a: int) -> int:
    return ((x + a - 1) // a) * a


def _block_cache(arena):
    """The arena's ``BlockCache`` when it is paged, else None."""
    if not arena.paged:
        return None
    from repro_torch.core.paging import BlockCache
    return BlockCache(arena.block_bytes, arena.cache_blocks)


def _paged_eligible(name: str, meta: Optional[bool], dtype, shape,
                    block_bytes: int) -> bool:
    """Data regions bigger than one block page; headers, order snapshots,
    journal rings and sidecars stay resident (tiny, hot on every epoch,
    read in full by recovery anyway).  Decided from the layout spec, before
    the region is built."""
    snap = ".snap" in name
    jrnl = ".jrnl" in name
    integ = name.endswith(".integ")
    m = (name.endswith("header") or snap) if meta is None else meta
    rowbytes = int(np.dtype(dtype).itemsize *
                   np.prod(shape[1:], dtype=np.int64)) \
        if len(shape) > 1 else np.dtype(dtype).itemsize
    return (not (m or snap or jrnl or integ)
            and rowbytes * shape[0] > block_bytes)


# ----------------------------------------------------------------------
# Order-snapshot records: one 64 B line each, packed and parsed on the host
# with numpy's uint64 arithmetic (wraparound and logical shifts), exactly
# as the reference packs them.
# ----------------------------------------------------------------------

SNAP_MAGIC = 0x50414E53          # "SNAP" little-endian
SNAP_SLOTS = 4                   # record-ring slots; one 64 B line each
SNAP_WORDS = 8                   # int64 words per record (= one line)

_POS_KEYS: Dict[int, np.ndarray] = {}


def _splitmix64(x: np.ndarray) -> np.ndarray:
    # 1-D internally: numpy's scalar ufunc paths warn on the intended
    # uint64 wraparound
    x = np.asarray(x).astype(np.uint64, copy=False)
    shape = x.shape
    x = x.reshape(-1)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return (x ^ (x >> np.uint64(31))).reshape(shape)


def _pos_keys(n: int) -> np.ndarray:
    """``n`` distinct odd 64-bit multipliers, one per word position."""
    k = _POS_KEYS.get(n)
    if k is None:
        k = _splitmix64(np.arange(1, n + 1, dtype=np.uint64)) \
            | np.uint64(1)
        _POS_KEYS[n] = k
    return k


def mix_checksums(words: np.ndarray) -> np.ndarray:
    """The reference's checksum: each word times a distinct odd position
    key, xor-folded over the trailing axis, splitmix64-finalized.
    ``(..., k)`` integer words -> ``(...)`` int64."""
    w = np.asarray(words)
    if w.dtype == np.int64 and w.flags.c_contiguous:
        w = w.view(np.uint64)
    elif w.dtype != np.uint64:
        w = w.astype(np.uint64)
    shape = w.shape[:-1]
    w = np.atleast_2d(w)
    k = _pos_keys(w.shape[-1])
    acc = w[..., 0] * k[0]
    for j in range(1, w.shape[-1]):
        acc = acc ^ (w[..., j] * k[j])
    return _splitmix64(acc).astype(np.int64).reshape(shape)


def _integ_chunks(rowbytes: int) -> int:
    """Checksum words per sidecar row: one per 64 B line of the source
    row, or one for the whole row when rows are sub-line."""
    return rowbytes // LINE if rowbytes % LINE == 0 and rowbytes else 1


def sidecar_checksums(arr: np.ndarray, chunks: int) -> np.ndarray:
    """Per-line checksums of gathered rows: ``(m, ...)`` rows of any
    8-byte-divisible dtype -> ``(m, chunks)`` int64.  0 is the sidecar's
    "never checksummed" sentinel, so a computed 0 nudges to 1."""
    m = arr.shape[0]
    w = np.ascontiguousarray(arr).reshape(m, -1).view(np.uint64)
    ck = mix_checksums(w.reshape(m, chunks, -1))
    ck[ck == 0] = 1
    return ck


def snap_checksum(rec: np.ndarray) -> int:
    """Checksum over the first 7 words of a snapshot record."""
    return int(mix_checksums(np.asarray(rec, np.int64)[:7]))


def snap_record_pack(gen: int, seq: int, a: int, b: int, c: int,
                     d: int = 0) -> np.ndarray:
    """Sealed record ``[magic, gen, seq, a, b, c, d, cksum]``: ``gen`` is
    the generation the enclosing commit seals, ``seq % SNAP_SLOTS`` the
    ring slot, so a torn append can only damage the slot it targets."""
    rec = np.array([SNAP_MAGIC, gen, seq, a, b, c, d, 0], np.int64)
    rec[7] = snap_checksum(rec)
    return rec


def snap_record_parse(rec: np.ndarray) -> Optional[Tuple[int, ...]]:
    """``(gen, seq, a, b, c, d)`` if the record line is intact, else
    ``None`` (torn append, never-written slot, or foreign bytes)."""
    rec = np.asarray(rec, np.int64).ravel()
    if rec.size != SNAP_WORDS or int(rec[0]) != SNAP_MAGIC:
        return None
    if int(rec[7]) != snap_checksum(rec):
        return None
    return tuple(int(x) for x in rec[1:7])


def snap_records(snaprec: Region) -> List[Tuple[int, ...]]:
    """Intact records of a loaded record ring (one copy to the host)."""
    ring = snaprec.vol.cpu().numpy()
    return [r for r in map(snap_record_parse, ring) if r is not None]


def newest_committed(snaprec: Region) -> Optional[Tuple[int, ...]]:
    """The intact record with the highest sequence number among those
    whose generation the header has committed; a record sealed by a
    generation that never committed (a crash inside the commit window)
    is skipped."""
    committed = snaprec.arena.header_generation()
    best = None
    for r in snap_records(snaprec):
        if r[0] <= committed and (best is None or r[1] > best[1]):
            best = r
    return best


# ----------------------------------------------------------------------
# Sharded arenas (DESIGN.md §7), barrier commit: one arena's persistent
# bytes split across N backing files behind the single-arena API.
# ----------------------------------------------------------------------

_MAN_MAGIC = b"RPRM"
_MAN_FMT = "<4sQQ?7x"     # magic, n_shards, generation, valid flag


def route_rows(router, n_rows: int, n_shards: int, rr_hint: int = 0
               ) -> np.ndarray:
    """Shard of every row of a region: a pure function of the row INDEX,
    never of the row's contents, so a row read back after a crash needs
    no knowledge of where it lives.

    * ``("seg", B)``: block-cyclic, segment ``row // B`` on shard
      ``(row // B) % n_shards``;
    * ``("hash", B)``: ``splitmix64(row // B) % n_shards`` (B defaults to
      64 rows);
    * ``("range",)``: a contiguous equal split;
    * ``("shard", k)``: the whole region on shard k;
    * ``None``: a small region (a header) on shard ``rr_hint %
      n_shards``, round-robin by creation order; a larger one in 64-row
      segments (``normalize_router``)."""
    rows = np.arange(n_rows, dtype=np.int64)
    if n_shards == 1:
        return np.zeros(n_rows, np.int32)
    router = normalize_router(router, n_rows, n_shards, rr_hint)
    kind = router[0]
    if kind == "seg":
        return ((rows // int(router[1])) % n_shards).astype(np.int32)
    if kind == "hash":
        blk = int(router[1]) if len(router) > 1 else 64
        return (_splitmix64(rows // blk) %
                np.uint64(n_shards)).astype(np.int32)
    if kind == "range":
        return np.minimum(rows * n_shards // max(n_rows, 1),
                          n_shards - 1).astype(np.int32)
    if kind == "shard":
        return np.full(n_rows, int(router[1]) % n_shards, np.int32)
    raise ValueError(f"unknown router {router!r}")


def normalize_router(router, n_rows: int, n_shards: int,
                     rr_hint: int = 0):
    """The concrete router of a ``None`` default: a region of at most
    4 rows per shard is pinned to shard ``rr_hint``, a larger one routed
    in 64-row segments."""
    if router is not None:
        return router
    if n_rows <= 4 * n_shards:
        return ("shard", rr_hint)
    return ("seg", 64)


def router_block(router) -> int:
    """Segment size of a block-granular router (seg or hash), else 0."""
    if router is None:
        return 0
    if router[0] == "seg":
        return int(router[1])
    if router[0] == "hash":
        return int(router[1]) if len(router) > 1 else 64
    return 0


class _ShardSlice(Region):
    """One shard's persistent slice of a ``ShardedRegion``: its local rows
    are the parent's rows routed to this shard, in ascending global order
    (``_gidx``: local row -> global row).  A slice holds no volatile copy:
    the parent's one tensor is the region's volatile state."""

    def __init__(self, arena, name, dtype, shape, offset, meta=None,
                 parent=None, gidx=None, arena_index=0):
        self._parent = parent
        self._gidx = gidx
        self.arena_index = arena_index
        super().__init__(arena, name, dtype, shape, offset, meta=meta)

    def _crash_reset(self) -> None:
        self.vol = None


class ShardedRegion(_RowAccess):
    """The Region API over per-shard slices.  ``vol`` is ONE full-shape
    tensor on the arena's device, indexed by global row as on a single
    arena; its persistent bytes are split across the shards by the
    router.  Marks buffer globally and split per shard once per drain
    (``ShardedWriteSet``); line accounting lands in each shard's
    ``FlushStats``."""

    def __init__(self, arena: "ShardedArena", name: str, dtype,
                 shape: Tuple[int, ...], meta: Optional[bool] = None,
                 router=None, rr_hint: int = 0):
        self.arena = arena
        self._declare(name, dtype, shape, meta)
        self._init_vol()
        n = self.shape[0]
        self.router = router = normalize_router(router, n, arena.n_shards,
                                                rr_hint)
        self.shard_of = route_rows(router, n, arena.n_shards, rr_hint)
        self.local_of = np.zeros(n, np.int64)
        # block-granular routers (seg, hash) load whole segments: each
        # shard's FULL blocks of the (nb, B, ...) view
        self._blk = router_block(router)
        nb = n // self._blk if self._blk else 0
        self._blocks: List[Optional[np.ndarray]] = []
        self.slices: List[Optional[_ShardSlice]] = []
        for s, shard in enumerate(arena.shards):
            gidx = np.nonzero(self.shard_of == s)[0]
            self.local_of[gidx] = np.arange(gidx.size)
            self._blocks.append(
                np.nonzero(self.shard_of[:nb * self._blk:self._blk] == s)[0]
                if self._blk else None)
            self.slices.append(None if gidx.size == 0 else shard.region(
                name, dtype, (int(gidx.size),) + self.shape[1:],
                meta=self.meta, _cls=_ShardSlice, parent=self, gidx=gidx,
                arena_index=s))
        # per shard, the device ids its load seats (blocks, or rows)
        self._seat_ids: List[Optional[torch.Tensor]] = \
            [None] * arena.n_shards

    def _init_vol(self) -> None:
        self.vol = torch.zeros(self.shape, dtype=self.tdtype,
                               device=self.arena.device)

    def _crash_reset(self) -> None:
        # zeroed in place: the reload writes into the same allocation
        self.vol.zero_()

    def _pview(self) -> np.ndarray:
        """The committed persistent image assembled across the shards (a
        copy: writes to it reach no shard)."""
        return self.arena._pimage(self)

    def _split(self, rows: np.ndarray):
        """``(shard, local rows, mask of rows)`` for each shard holding any
        of the sorted global ``rows``; the mask is None when one shard
        holds them all."""
        shards = self.shard_of[rows]
        held = np.flatnonzero(np.bincount(shards,
                                          minlength=self.arena.n_shards))
        if held.size == 1:
            yield int(held[0]), self.local_of[rows], None
            return
        for s in held:
            sel = shards == s
            yield int(s), self.local_of[rows[sel]], sel

    # -- Region API --------------------------------------------------------
    def mark_rows(self, rows, fresh: bool = False) -> None:
        """Buffered globally inside an epoch (the per-shard split happens
        once per drain), ``fresh`` with them; outside one, an immediate
        ``persist_rows``, which writes home in either mode."""
        rows = host_rows(rows)
        if rows.size == 0:
            return
        if self.arena._epoch_depth > 0:
            self.arena.writeset.mark(self, rows, fresh=fresh)
        else:
            self.persist_rows(rows)

    def persist_rows(self, rows) -> None:
        rows = np.unique(host_rows(rows))
        if rows.size:
            self.arena.writeset.persist(self, rows)

    def persist_range(self, lo: int, hi: int) -> None:
        if hi > lo:
            self.persist_rows(np.arange(lo, hi, dtype=np.int64))

    def load(self, concurrency: int = 1) -> None:
        """Reload every shard's rows; ``concurrency > 1`` runs the shards
        in the arena's pool."""
        if concurrency > 1 and self.arena.n_shards > 1:
            list(self.arena.pool().map(self.load_shard,
                                       range(self.arena.n_shards)))
        else:
            for s in range(self.arena.n_shards):
                self.load_shard(s)

    def load_shard(self, s: int) -> None:
        """Reload this region's shard-s rows into the volatile tensor: the
        shard's persistent slice is staged on the host (in pinned memory on
        a card), a shadow shard's authoritative bank rows laid over the
        staged bytes, then goes to the device in ONE upload and is seated
        by one ``scatter_rows_`` over the tensor's bytes: whole segments
        of the ``(blocks, B * rowbytes)`` view for a block router (plus the
        region's partial tail block, which is one shard's), rows
        otherwise."""
        sl = self.slices[s]
        if sl is None:
            return
        dev = self.arena.device
        m, rb = sl.shape[0], self.rowbytes
        pv = sl._pview().reshape(-1).view(np.uint8)
        if dev.type == "cpu":
            host = pv.copy()
        else:
            pinned = torch.empty(m * rb, dtype=torch.uint8, pin_memory=True)
            host = pinned.numpy()
            host[:] = pv
        sl.arena._shadow_overlay(sl, host.view(sl.dtype).reshape(sl.shape))
        staged = torch.from_numpy(host) if dev.type == "cpu" else \
            pinned.to(dev, non_blocking=True)
        flat = self.vol.view(-1).view(torch.uint8).view(self.shape[0], rb)
        ids = self._seat_ids[s]
        if self._blk:
            B = self._blk
            nb = self.shape[0] // B
            bs = self._blocks[s]
            if ids is None:
                ids = self._seat_ids[s] = torch.from_numpy(
                    bs.astype(np.int32)).to(dev)
            if bs.size:
                scatter_rows_(flat[:nb * B].view(nb, B * rb),
                              staged[:bs.size * B * rb].view(bs.size,
                                                             B * rb), ids)
            if m > bs.size * B:        # the region's tail block is ours
                flat[nb * B:] = staged[bs.size * B * rb:].view(-1, rb)
        else:
            if ids is None:
                ids = self._seat_ids[s] = torch.from_numpy(
                    sl._gidx.astype(np.int32)).to(dev)
            scatter_rows_(flat, staged.view(m, rb), ids)
        sl.arena.synth_read(sl.nbytes)


class ShardedArena:
    """N arena shards behind the single-arena API, plus a manifest that
    makes the cross-shard generation atomic.

    Barrier commit, manifest last: (1) drain the write set, every shard's
    data regions, then every shard's metadata regions (the
    data-before-metadata barrier is global); (2) commit each shard (flush
    its file, bump its header generation, set its valid flag); (3) write
    the manifest.  A crash between shard commits leaves the manifest at
    the previous generation, the one every shard has reached, which is
    what recovery reports.  Shadow commit: fold every shard's committed
    bank, drain in one phase, seal every shard's target bank, ONE fence,
    then the same flips and the manifest last, and every shard retires
    its banks.  Each shard is a plain ``Arena`` over ``{path}.s{k}``, the
    manifest ``{path}.manifest``; the files are the reference's, byte for
    byte.  Synthetic stalls: a shard's sleep (so that shards stalling in
    the pool overlap), the global fence spins."""

    def __init__(self, path: Optional[str], n_shards: int = 2,
                 synth_line_ns: float = 0.0, pack_flush_rows: int = 0,
                 commit_mode: str = "barrier", synth_fence_ns: float = 0.0,
                 paged: Optional[bool] = None, block_bytes: int = 4096,
                 cache_blocks: int = 1024,
                 integrity: Optional[bool] = None, device=None):
        """The reference's parameters in the reference's order, then
        ``device``; ``pack_flush_rows`` as ``Arena``'s (kept, changes
        nothing), handed to every shard."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if commit_mode not in ("barrier", "shadow"):
            raise ValueError(f"unknown commit_mode {commit_mode!r}")
        self.device = resolve_device(device)
        # the ONE block cache (like the one volatile tensor it replaces)
        # lives at the sharded level: shards are always opened unpaged
        self.paged = paged_enabled(paged)
        self.block_bytes = int(block_bytes)
        self.cache_blocks = int(cache_blocks)
        self.cache = _block_cache(self)
        self.path = path
        self.n_shards = int(n_shards)
        # sidecars are declared at the sharded level, each with its source
        # region's router, so a row's checksum lives on the row's shard
        self.integrity = integrity_enabled(integrity)
        self.pack_flush_rows = int(pack_flush_rows)
        self.shards = [Arena(f"{path}.s{k}" if path else None, synth_line_ns,
                             pack_flush_rows, commit_mode=commit_mode,
                             paged=False, integrity=False,
                             device=self.device)
                       for k in range(self.n_shards)]
        for sh in self.shards:
            sh.synth_sleep = True
        self.synth_line_ns = synth_line_ns
        self.commit_mode = commit_mode
        # the fence is a global ordering point: its stall lives here
        self.synth_fence_ns = synth_fence_ns
        self.regions: Dict[str, ShardedRegion] = {}
        self.writeset = ShardedWriteSet(self)
        self.generation = 0
        self._salvage = False
        self._epoch_depth = 0
        self._layout_final = False
        self._snap_providers: List = []
        self._local_stats = FlushStats()
        self._man: Optional[np.ndarray] = None
        self._rr = 0
        self._pool: Optional[ThreadPoolExecutor] = None

    # -- stats -------------------------------------------------------------
    @property
    def stats(self) -> FlushStats:
        """Every shard's accounting summed, plus the sharded level's own
        (marks, epochs, dedup and saved lines, fences, commit calls)."""
        out = self._local_stats.snapshot()
        for sh in self.shards:
            for f in dataclasses.fields(FlushStats):
                setattr(out, f.name,
                        getattr(out, f.name) + getattr(sh.stats, f.name))
        return out

    def shard_stats(self) -> List[FlushStats]:
        return [sh.stats.snapshot() for sh in self.shards]

    # -- epochs ------------------------------------------------------------
    @contextlib.contextmanager
    def epoch(self):
        self._epoch_depth += 1
        try:
            yield self
        finally:
            self._epoch_depth -= 1
            if self._epoch_depth == 0:
                self.writeset.flush()

    # -- layout ------------------------------------------------------------
    def region(self, name: str, dtype, shape: Tuple[int, ...],
               meta: Optional[bool] = None, router=None) -> ShardedRegion:
        """Declare a region routed by ``router`` (``route_rows``).  The
        creation order matters: a small region's default router pins it
        round-robin by it."""
        if self._layout_final:
            raise RuntimeError("layout already finalized")
        if name in self.regions:
            raise ValueError(f"region {name!r} already declared")
        cls = ShardedRegion
        if self.cache is not None and _paged_eligible(
                name, meta, dtype, shape, self.block_bytes):
            from repro_torch.core.paging import PagedShardedRegion
            cls = PagedShardedRegion
        r = cls(self, name, dtype, shape, meta=meta, router=router,
                rr_hint=self._rr)
        self._rr += 1
        self.regions[name] = r
        return r

    def region_shards(self, name: str, rows) -> np.ndarray:
        """Shard id of each row of region ``name``."""
        return self.regions[name].shard_of[
            np.asarray(np.atleast_1d(rows), np.int64)].astype(np.int64)

    def finalize(self) -> None:
        if self._layout_final:
            raise RuntimeError("layout already finalized")
        if self.integrity:
            self._integrity_layout()
        self._layout_final = True
        for sh in self.shards:
            sh.finalize()
        if self.path is None:
            self._man = np.zeros(64, np.uint8)
            return
        mp = self.path + ".manifest"
        create = not os.path.exists(mp)
        if create:
            with open(mp, "wb") as f:
                f.truncate(64)
        self._man = np.memmap(mp, dtype=np.uint8, mode="r+", shape=(64,))
        if create:
            self._write_manifest(valid=False)
            return
        magic, man_shards, man_gen, man_valid = struct.unpack(
            _MAN_FMT, bytes(self._man[: struct.calcsize(_MAN_FMT)]))
        # the manifest records the shard count so that a wrong one fails
        # loudly instead of mapping the wrong files
        if magic == _MAN_MAGIC and man_shards != self.n_shards:
            raise ValueError(
                f"arena at {self.path!r} was committed with {man_shards} "
                f"shards, opened with {self.n_shards}")
        if magic == _MAN_MAGIC and man_valid and man_gen > 0:
            # a valid manifest promises every shard reached its
            # generation (a torn commit leaves shards AHEAD); a shard
            # behind it, or recreated empty because its file vanished, is
            # media loss
            for k, sh in enumerate(self.shards):
                if not (sh.header_valid()
                        and sh.header_generation() >= man_gen):
                    raise ShardLossError(
                        f"shard {k} ({sh.path!r}) lost or behind manifest "
                        f"generation {man_gen}")

    def add_snapshot_provider(self, fn) -> None:
        self._snap_providers.append(fn)

    # -- integrity sidecars ------------------------------------------------
    def _integrity_layout(self) -> None:
        """One sidecar per covered region, with the source's router: a row
        and its checksum commit through the same shard's header."""
        for name, r in list(self.regions.items()):
            if r.meta or r.snap or r.jrnl or r.integ or r.rowbytes % 8:
                continue
            sc = self.region(name + ".integ", np.int64,
                             (r.shape[0], _integ_chunks(r.rowbytes)),
                             meta=False, router=r.router)
            r._integ = sc
            for s in range(self.n_shards):
                if r.slices[s] is not None:
                    r.slices[s]._integ = sc.slices[s]

    def verify_header(self) -> None:
        """ManifestError on a garbage manifest magic, then each shard's
        header check."""
        raw = bytes(self._man[:4])
        if raw not in (_MAN_MAGIC, b"\x00\x00\x00\x00"):
            raise ManifestError(
                f"arena {self.path!r} manifest magic {raw!r} corrupt")
        for sh in self.shards:
            sh.verify_header()

    def _pimage(self, region: ShardedRegion, copy: bool = True
                ) -> np.ndarray:
        """The region's committed persistent image, assembled across the
        shards: each shard's home rows with its authoritative shadow
        bank's rows over them (always a copy, whatever ``copy`` says;
        scrub and salvage never write persistent state)."""
        img = np.zeros(region.shape, region.dtype)
        for sl in region.slices:
            if sl is None:
                continue
            img[sl._gidx] = sl._pview()
            sh = sl.arena
            rows = sh._shadow_rows(sl)
            if rows is not None:
                img[sl._gidx[rows]] = sh._shadow_mirror(
                    sl, sh._shadow_auth_bank)[rows]
        return img

    def verify_region(self, region) -> np.ndarray:
        if isinstance(region, str):
            region = self.regions[region]
        sc = region._integ
        if sc is None:
            return np.empty(0, np.int64)
        ck = sidecar_checksums(self._pimage(region), sc.shape[1])
        ref = self._pimage(sc)
        bad = (ref != 0) & (ck != ref)
        for sh in self.shards:
            sh.synth_read((region.nbytes + sc.nbytes) // self.n_shards)
        return np.nonzero(bad.any(axis=1))[0]

    def scrub(self, raise_on_error: bool = False
              ) -> Dict[str, np.ndarray]:
        bad: Dict[str, np.ndarray] = {}
        for name, r in self.regions.items():
            if r._integ is None:
                continue
            rows = self.verify_region(r)
            if rows.size:
                bad[name] = rows
        if bad and raise_on_error:
            name, rows = next(iter(bad.items()))
            raise CorruptLineError(name, rows,
                                   detail=f"scrub: {len(bad)} region(s)")
        return bad

    # -- manifest / commit protocol ----------------------------------------
    def _write_manifest(self, valid: bool) -> None:
        man = struct.pack(_MAN_FMT, _MAN_MAGIC, self.n_shards,
                          self.generation, valid)
        self._man[: len(man)] = np.frombuffer(man, np.uint8)
        if isinstance(self._man, np.memmap):
            self._man.flush()

    def header_generation(self) -> int:
        magic, _, gen, _ = struct.unpack(
            _MAN_FMT, bytes(self._man[: struct.calcsize(_MAN_FMT)]))
        return int(gen) if magic == _MAN_MAGIC else 0

    def header_valid(self) -> bool:
        """The manifest is valid and every shard has reached its
        generation (shards ahead of it are a torn commit's, which the
        structures' count-bounded recovery handles)."""
        magic, _, gen, valid = struct.unpack(
            _MAN_FMT, bytes(self._man[: struct.calcsize(_MAN_FMT)]))
        if magic != _MAN_MAGIC or not valid:
            return False
        return all(sh.header_valid() and sh.header_generation() >= gen
                   for sh in self.shards)

    def _fence(self) -> None:
        """The global ordering point: one per barrier phase and one per
        barrier commit seal, exactly one per shadow commit."""
        self._local_stats.fences += 1
        if self.synth_fence_ns:
            ns = int(self.synth_fence_ns)
            self._local_stats.fence_ns += ns
            t0 = time.perf_counter_ns()
            while time.perf_counter_ns() - t0 < ns:
                pass

    def commit(self, _crash_after_shard: Optional[int] = None) -> None:
        """Drain the write set (barrier: global data-before-metadata),
        commit each shard, write the manifest LAST.  ``_crash_after_shard=
        k`` injects a power loss in the commit window: shards 0..k commit,
        then the arena crashes before the manifest.

        Shadow: every shard folds its committed bank home, the write set
        drains in one phase, every shard seals its target bank and flushes
        its file, then the ONE ordering point and the same flips and
        manifest; each shard retires its banks after the manifest.
        ``_crash_after_shard=-1`` crashes after the seals and before any
        flip."""
        if self.commit_mode == "shadow":
            # a shard that had work in a drain since the last commit has
            # folded already
            self.run_shards(
                lambda s: self.shards[s]._shadow_collapse(),
                [s for s, sh in enumerate(self.shards)
                 if not sh._shadow_collapsed[sh.generation % 2]],
                lines=lambda s: self.shards[s]._fold_lines())
            self.writeset.flush()
            for sh in self.shards:
                sh._shadow_seal()
                if isinstance(sh._mm, np.memmap):
                    sh._mm.flush()
            if _crash_after_shard is not None and _crash_after_shard < 0:
                self.crash()
                return
        else:
            self.writeset.flush()
        self._fence()
        tgt = self.generation + 1
        for k, sh in enumerate(self.shards):
            if isinstance(sh._mm, np.memmap):
                sh._mm.flush()
            sh.generation = tgt
            sh._write_header(valid=True)
            if isinstance(sh._mm, np.memmap):
                sh._mm.flush()
            if _crash_after_shard is not None and k == _crash_after_shard:
                self.crash()
                return
        self.generation = tgt
        self._write_manifest(valid=True)
        self._local_stats.calls += 1
        if self.commit_mode == "shadow":
            for sh in self.shards:
                sh._shadow_retire()

    def invalidate(self) -> None:
        self._write_manifest(valid=False)

    # -- crash simulation ---------------------------------------------------
    def crash(self) -> None:
        """Drop the pending marks and every shard's shadow bookkeeping, and
        zero every region's one volatile tensor (slices hold none)."""
        self.writeset.discard()
        for sh in self.shards:
            sh._shadow_discard()
        for r in self.regions.values():
            r._crash_reset()

    def reopen(self, concurrency: int = 1,
               exclude: Tuple[str, ...] = ()) -> None:
        """Reload every region not in ``exclude`` (regions the caller
        loads itself: the recovery manager's per-region load stages), shard
        by shard, in the pool when ``concurrency > 1``; then re-anchor the
        generation to the manifest's.  A shadow arena first parses every
        shard's bank under the MANIFEST's generation, before any load."""
        man_gen = self.header_generation()
        for sh in self.shards:
            sh._shadow_parse(authority_gen=man_gen)
        regions = [r for n, r in self.regions.items() if n not in exclude]
        # paged regions reload lazily: one pool reset each, and the
        # post-crash working set faults in on demand
        for r in regions:
            if r.is_paged:
                r.load()
        regions = [r for r in regions if not r.is_paged]

        def load_shard(s: int) -> None:
            # one aggregated media stall per shard, not one per region
            with self.shards[s].stall_scope():
                for r in regions:
                    r.load_shard(s)

        if concurrency > 1 and self.n_shards > 1:
            list(self.pool().map(load_shard, range(self.n_shards)))
        else:
            for s in range(self.n_shards):
                load_shard(s)
        self.generation = max(self.generation, self.header_generation())

    # -- pool ---------------------------------------------------------------
    def pool(self) -> ThreadPoolExecutor:
        """The shard pool, one worker per shard: stalls sleep, so more
        waiters than cores still overlap."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_shards, thread_name_prefix="arena-shard")
        return self._pool

    def run_shards(self, fn, shards, lines) -> None:
        """``fn(s)`` for each shard id of ``shards``, in the pool only where
        the arena models media stalls (``synth_line_ns``) that sleep: the
        pool overlaps them (each shard sleeps its own).  ``lines(s)``
        estimates the lines shard s stalls on, and the pool runs only if
        one shard's stall reaches ``SLEEP_NS``: shorter stalls spin,
        holding the interpreter, so the shards could not overlap and the
        pool would add only its hand-offs.  Without stalls a shard's share
        is a few host copies, cheaper on this thread.  ``fn`` must write
        only shard s's state, so the bytes do not depend on where it
        runs."""
        shards = list(shards)
        if len(shards) > 1 and self.synth_line_ns and \
                max(map(lines, shards)) * self.synth_line_ns >= SLEEP_NS:
            list(self.pool().map(fn, shards))
        else:
            for s in shards:
                fn(s)

    def close(self) -> None:
        for sh in self.shards:
            sh.close()
        if isinstance(self._man, np.memmap):
            self._man.flush()
        self._man = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def open_arena(path: Optional[str], layout: Dict[str, Tuple],
               n_shards: int = 1, **kw):
    """Create/open an arena with the given layout: ``{name: (dtype,
    shape)}`` or ``{name: (dtype, shape, router)}``; the router steers rows
    across shards when ``n_shards > 1`` (``route_rows``).  ``n_shards=1``
    is the plain ``Arena``.  Keyword arguments go to the arena; ``device``
    picks where the volatile regions live."""
    a = Arena(path, **kw) if n_shards == 1 else \
        ShardedArena(path, n_shards=n_shards, **kw)
    for name, spec in layout.items():
        a.region(name, spec[0], spec[1],
                 router=spec[2] if len(spec) > 2 else None)
    a.finalize()
    return a
