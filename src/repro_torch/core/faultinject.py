"""Media-fault injection (DESIGN.md §13), the port of
``repro.core.faultinject``.

The helpers corrupt the COMMITTED image of a row, the bytes recovery will
read.  On a barrier arena that is the row's home slot in the persistent
image, which the port keeps in host memory (a numpy buffer or the memmap
of the backing file), so every fault is a host write; on a sharded arena
it is the home slot in the shard that holds the row.  On a shadow arena
(``commit_mode="shadow"``) a committed row may live in the authoritative
remap bank's mirror instead: the helpers parse the persistent bank state
(the header's generation parity, the sealed entry count, the entries) as
recovery does, and land the fault where recovery and scrub will read.
Faults by taxonomy
(``core.arena`` error types):

* ``flip_bits`` / ``stuck_line``: ``CorruptLineError`` territory, in-place
  rot inside a committed row's line(s), visible to ``scrub()``;
* ``truncate_shard`` / ``remove_shard``: ``ShardLossError`` territory,
  whole-file media loss of one shard (a plain arena is its own only
  shard), detected when the arena is next opened (use them between arena
  generations: they work on the backing file, never through a live
  mapping; a sharded arena's path prefix may stand for the arena);
* ``corrupt_header`` (a plain arena's, or one shard's) and
  ``corrupt_manifest`` (a sharded arena's): ``ManifestError`` territory, a
  scribbled commit magic, detected by ``verify_header()`` in the recovery
  prologue.

``flip_bits`` is an involution: inject twice to undo.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from repro_torch.core.arena import LINE, Arena, ShardedArena

__all__ = [
    "flip_bits", "stuck_line", "truncate_shard", "remove_shard",
    "corrupt_header", "corrupt_manifest", "committed_row_offset",
]


def committed_row_offset(arena, region, row: int
                         ) -> Tuple[Arena, int, int]:
    """(owning plain arena, byte offset of the row's committed image in its
    persistent buffer, rowbytes).  A sharded region's row resolves to the
    shard that holds it and its local row there; a row the authoritative
    shadow bank remaps, to its mirror slot in that bank.  Persistent state
    only, so valid before or after a crash, in either commit mode."""
    if isinstance(region, str):
        region = arena.regions[region]
    if isinstance(arena, ShardedArena):
        s = int(region.shard_of[row])
        return committed_row_offset(arena.shards[s], region.slices[s],
                                    int(region.local_of[row]))
    base = region.offset
    if arena.commit_mode == "shadow":
        bank = arena.header_generation() % 2
        cnt = int(arena._shadow_meta_view()[bank])
        if cnt:
            ents = np.array(arena._shadow_entries(bank)[:cnt])
            rid = arena._region_ids[region.name]
            if bool(((ents[:, 0] == rid) & (ents[:, 1] == row)).any()):
                base = region._shadow_off[bank]
    return arena, base + row * region.rowbytes, region.rowbytes


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


def _shard_path(arena, shard: int) -> str:
    """Backing file of one shard: ``{path}.s{shard}`` of a sharded arena
    (or of its path prefix, given as a string), a plain arena's own
    file."""
    if isinstance(arena, str):
        return f"{arena}.s{shard}"
    if arena.path is None:
        raise ValueError("file faults need a file-backed arena")
    if isinstance(arena, ShardedArena):
        return arena.shards[shard].path
    return arena.path


def truncate_shard(arena, shard: int = 0, nbytes: int = 0) -> str:
    """Truncate a shard's backing file to ``nbytes``: partial media loss,
    raised as ``ShardLossError`` by the next open."""
    path = _shard_path(arena, shard)
    with open(path, "r+b") as f:
        f.truncate(nbytes)
    return path


def remove_shard(arena, shard: int = 0) -> str:
    """Delete a shard's backing file outright: total media loss of one
    shard."""
    path = _shard_path(arena, shard)
    os.remove(path)
    return path


def corrupt_header(arena, shard: int = 0) -> None:
    """Scribble a commit header's magic word (a plain arena's, or one
    shard's of a sharded one); ``verify_header()`` then raises
    ``ManifestError``."""
    a = arena.shards[shard] if isinstance(arena, ShardedArena) else arena
    a._mm[:4] = np.frombuffer(b"ROT!", np.uint8)
    _flush(a)


def corrupt_manifest(arena) -> None:
    """Scribble a sharded arena's manifest magic: the cross-shard commit
    pointer itself is the corrupted medium."""
    if not isinstance(arena, ShardedArena):
        raise ValueError("corrupt_manifest needs a sharded arena")
    arena._man[:4] = np.frombuffer(b"ROT!", np.uint8)
    if isinstance(arena._man, np.memmap):
        arena._man.flush()
