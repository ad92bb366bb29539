"""Media-fault injection (DESIGN.md §13), the port of
``repro.core.faultinject`` for the plain barrier arena.

The helpers corrupt the COMMITTED image of a row, the bytes recovery will
read.  On a barrier arena that is the row's home slot in the persistent
image, which the port keeps in host memory (a numpy buffer or the memmap
of the backing file), so every fault is a host write.  Faults by taxonomy
(``core.arena`` error types):

* ``flip_bits`` / ``stuck_line``: ``CorruptLineError`` territory, in-place
  rot inside a committed row's line(s), visible to ``Arena.scrub()``;
* ``truncate_shard`` / ``remove_shard``: ``ShardLossError`` territory,
  whole-file media loss, detected when the arena is next opened (use them
  between arena generations: they work on the backing file, never through
  a live mapping);
* ``corrupt_header``: ``ManifestError`` territory, a scribbled commit
  magic, detected by ``verify_header()`` in the recovery prologue.

``flip_bits`` is an involution: inject twice to undo.  Shadow-commit
remap banks and sharded arenas (``corrupt_manifest``) are not ported.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from repro_torch.core.arena import LINE, Arena, not_ported

__all__ = [
    "flip_bits", "stuck_line", "truncate_shard", "remove_shard",
    "corrupt_header", "corrupt_manifest", "committed_row_offset",
]


def _plain(arena) -> Arena:
    if getattr(arena, "n_shards", 1) != 1:
        raise not_ported("sharding")
    if arena.commit_mode != "barrier":
        raise not_ported("shadow commit")
    return arena


def committed_row_offset(arena, region, row: int
                         ) -> Tuple[Arena, int, int]:
    """(owning arena, byte offset of the row's committed image in its
    persistent buffer, rowbytes).  On a barrier arena the committed image
    is the home slot, before or after a crash."""
    arena = _plain(arena)
    if isinstance(region, str):
        region = arena.regions[region]
    return arena, region.offset + row * region.rowbytes, region.rowbytes


def _flush(a: Arena) -> None:
    if isinstance(a._mm, np.memmap):
        a._mm.flush()


def flip_bits(arena, region, row: int, byte: int = 0,
              mask: int = 0x01) -> int:
    """XOR ``mask`` into one byte of the committed image of ``(region,
    row)``, the single-bit-rot injection.  Returns the absolute byte
    offset that changed (inject again to undo)."""
    a, off, rb = committed_row_offset(arena, region, row)
    if not 0 <= byte < rb:
        raise ValueError(f"byte {byte} outside a {rb}-byte row")
    a._mm[off + byte] ^= np.uint8(mask)
    _flush(a)
    return off + byte


def stuck_line(arena, region, row: int, line: int = 0,
               value: int = 0xFF) -> Tuple[int, int]:
    """Overwrite one 64 B line of the committed row image with a stuck-at
    pattern (a failed cell), clamped to the row so the fault stays a
    single-row corruption; returns the [lo, hi) byte range written."""
    a, off, rb = committed_row_offset(arena, region, row)
    lo = off + line * LINE
    hi = min(off + rb, lo + LINE)
    if lo >= hi:
        raise ValueError(f"line {line} beyond a {rb}-byte row")
    a._mm[lo:hi] = np.uint8(value)
    _flush(a)
    return lo, hi


def _backing_path(arena) -> str:
    arena = _plain(arena)
    if arena.path is None:
        raise ValueError("file faults need a file-backed arena")
    return arena.path


def truncate_shard(arena, shard: int = 0, nbytes: int = 0) -> str:
    """Truncate the arena's backing file to ``nbytes``: partial media
    loss, raised as ``ShardLossError`` by the next open.  A plain arena is
    its own only shard, so ``shard`` names nothing more."""
    path = _backing_path(arena)
    with open(path, "r+b") as f:
        f.truncate(nbytes)
    return path


def remove_shard(arena, shard: int = 0) -> str:
    """Delete the arena's backing file outright."""
    path = _backing_path(arena)
    os.remove(path)
    return path


def corrupt_header(arena, shard: int = 0) -> None:
    """Scribble the commit header's magic word; ``verify_header()`` then
    raises ``ManifestError``."""
    a = _plain(arena)
    a._mm[:4] = np.frombuffer(b"ROT!", np.uint8)
    _flush(a)


def corrupt_manifest(arena) -> None:
    """The reference scribbles a sharded arena's manifest magic; the
    port has no sharded arena yet."""
    raise not_ported("sharding")
