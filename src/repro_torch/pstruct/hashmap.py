"""Partly-persistent hashmap (paper §IV-E, AOSP-chaining layout), the port
of ``repro.pstruct.hashmap``.

* Entries live in a dense append-only slab.  Partly persistent row = KEY
  + VALUE (7 words) = 64 B = 1 line; fully persistent rows also persist
  HASH and NEXT (a second line, 128 B rows).
* Only SIZE (and the fresh-water mark) is essential, in one header line.
  The bucket array, chain links and cached hashes are volatile redundancy,
  tensors on the arena's device (full mode also keeps a persistent copy of
  the buckets).
* Deletion writes a NULL-key tombstone (1 line); the slab is compacted
  lazily on rehash.

Batched ops vectorize the chain walks: a probe advances every pending
lookup one link per round (rounds = longest chain).  Reconstruction
(§IV-E3): scan the slab rows below the fresh-water mark, drop tombstones,
recompute hashes, derive the bucket count from SIZE and rebuild the
chains in slab order with a stable sort.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import reconstruct as rec
from repro_torch.core.arena import Arena, not_ported
from repro_torch.core.recovery import chain_walk

NULL = -1
KEY_NULL = -(2 ** 62)  # tombstone / empty key sentinel
VALUE_WORDS = 7

H_FLAG, H_SIZE, H_FRESH, H_BUCKETS = range(4)

# splitmix64 finalizer multipliers, as int64 bit patterns
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns.  torch has no uint64
    ``>>`` on the CPU and ``>>`` on int64 is arithmetic, so shift and then
    mask off the copied sign bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def hash64(keys: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (the reference's ``hash64``) on int64 bit
    patterns: int64 multiplication wraps exactly as uint64 does."""
    x = keys.to(torch.int64)
    x = (x ^ _srl(x, 30)) * _M1
    x = (x ^ _srl(x, 27)) * _M2
    return x ^ _srl(x, 31)


def _last_occurrence(keys: torch.Tensor) -> torch.Tensor:
    """Ascending indices of the LAST occurrence of each distinct key (the
    reference's ``np.unique(keys[::-1], return_index=True)``), built from
    a stable sort: within a run of equal keys the last index is last."""
    s, perm = torch.sort(keys, stable=True)
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    return torch.sort(perm[last]).values


def _group_starts(sorted_vals: torch.Tensor) -> torch.Tensor:
    g = torch.ones_like(sorted_vals, dtype=torch.bool)
    g[1:] = sorted_vals[1:] != sorted_vals[:-1]
    return g


class Hashmap:
    def __init__(self, arena: Arena, capacity: int, mode: str = "partly",
                 load_factor: float = 0.75, name: str = "hm",
                 chain_method: str = "auto",
                 snapshot: Optional[bool] = None):
        if mode not in ("partly", "full"):
            raise ValueError(f"unknown mode {mode!r}")
        if snapshot:
            raise not_ported("order snapshots")
        self.mode = mode
        self.capacity = capacity
        self.load_factor = load_factor
        self.chain_method = chain_method
        self.arena = arena
        row = 8 if mode == "partly" else 16
        self.entries = arena.regions.get(f"{name}.entries") or arena.region(
            f"{name}.entries", np.int64, (capacity, row))
        self.header = arena.regions.get(f"{name}.header") or arena.region(
            f"{name}.header", np.int64, (1, 8))
        n_max = _next_pow2(max(16, int(capacity / load_factor)))
        self.n_buckets_max = n_max
        # full mode keeps the bucket array itself persistent
        self._pbuckets = None
        if mode == "full":
            self._pbuckets = arena.regions.get(f"{name}.buckets") or \
                arena.region(f"{name}.buckets", np.int64, (n_max, 1))
        dev = arena.device
        self.n_buckets = n_max
        self.buckets = torch.full((self.n_buckets,), NULL,
                                  dtype=torch.int64, device=dev)
        self.chain = torch.full((capacity,), NULL, dtype=torch.int64,
                                device=dev)
        # cached hashes: uint64 values held as int64 bit patterns
        self.hashes = torch.zeros(capacity, dtype=torch.int64, device=dev)

    @staticmethod
    def layout(capacity: int, mode: str = "partly", name: str = "hm",
               load_factor: float = 0.75, snapshot: Optional[bool] = None):
        if snapshot:
            raise not_ported("order snapshots")
        row = 8 if mode == "partly" else 16
        out = {f"{name}.entries": (np.int64, (capacity, row)),
               f"{name}.header": (np.int64, (1, 8))}
        if mode == "full":
            n_max = _next_pow2(max(16, int(capacity / load_factor)))
            out[f"{name}.buckets"] = (np.int64, (n_max, 1))
        return out

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int64, device=self.arena.device)

    def _persist_buckets(self, bkts: torch.Tensor) -> None:
        if self._pbuckets is not None and bkts.numel():
            self._pbuckets.vol[bkts, 0] = self.buckets[bkts]
            self._pbuckets.mark_rows(bkts)

    # -------- views --------
    @property
    def keys(self) -> torch.Tensor:
        return self.entries.vol[:, 0]

    @property
    def values(self) -> torch.Tensor:
        return self.entries.vol[:, 1:1 + VALUE_WORDS]

    # -------- core probe (vectorized chain walk) --------
    def _find_slots(self, keys: torch.Tensor) -> torch.Tensor:
        """Slab index of each key (NULL if absent)."""
        b = hash64(keys) & (self.n_buckets - 1)
        cur = self.buckets[b]
        found = torch.full_like(keys, NULL)
        active = cur != NULL
        while bool(active.any()):
            idx = cur[active]
            hit = self.keys[idx] == keys[active]
            tgt = torch.nonzero(active).squeeze(1)
            found[tgt[hit]] = idx[hit]
            cur[active] = torch.where(hit, NULL, self.chain[idx])
            active = cur != NULL
        return found

    def find_batch(self, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (present mask, values (m, 7))."""
        keys = self._dev(keys)
        slots = self._find_slots(keys)
        ok = slots != NULL
        vals = torch.zeros((keys.shape[0], VALUE_WORDS), dtype=torch.int64,
                           device=keys.device)
        vals[ok] = self.values[slots[ok]]
        return ok, vals

    # -------- mutation --------
    def insert_batch(self, keys, values) -> None:
        """Insert-or-update.  keys: (m,); values: (m, 7)."""
        with self.arena.epoch():
            self._insert_batch(keys, values)

    def _insert_batch(self, keys, values) -> None:
        keys, values = self._dev(keys), self._dev(values)
        # de-dup within batch: keep the last occurrence
        keep = _last_occurrence(keys)
        keys, values = keys[keep], values[keep]
        slots = self._find_slots(keys)
        upd = slots != NULL
        hv = self.header.read_row(0)
        vol = self.entries.vol
        s = slots[upd]
        if s.numel():
            vol[s, 1:1 + VALUE_WORDS] = values[upd]
            self.entries.mark_rows(s)
        new_keys = keys[~upd]
        nn = new_keys.shape[0]
        if nn:
            fresh0 = int(hv[H_FRESH])
            if fresh0 + nn > self.capacity:
                raise MemoryError("hashmap slab exhausted")
            ids = torch.arange(fresh0, fresh0 + nn, dtype=torch.int64,
                               device=keys.device)
            hv[H_FRESH] = fresh0 + nn
            vol[ids, 0] = new_keys
            vol[ids, 1:1 + VALUE_WORDS] = values[~upd]
            h = hash64(new_keys)
            self.hashes[ids] = h
            hv[H_SIZE] += nn
            self._link(ids, h)
            if self.mode == "full":
                # the persisted HASH word is int64(h) >> 1, arithmetic
                vol[ids, 8] = h >> 1
            self.entries.mark_rows(np.arange(fresh0, fresh0 + nn), fresh=True)
            if hv[H_SIZE] > self.load_factor * self.n_buckets:
                self._grow(int(hv[H_FRESH]))
        hv[H_FLAG] = 1
        self.header.write_row(0, hv)
        self.header.mark_rows(np.array([0]))

    def _link(self, ids: torch.Tensor, h: torch.Tensor) -> None:
        """Append ids to their bucket chains (chain-tail order), grouped by
        bucket with a stable sort."""
        b = h & (self.n_buckets - 1)
        bs, order = torch.sort(b, stable=True)
        ids_s = ids[order]
        grp_start = _group_starts(bs)
        gb = bs[grp_start]
        # head of each new group links after current chain tail
        tails = self._chain_tails(gb)
        # intra-group chaining
        self.chain[ids_s[:-1]] = torch.where(~grp_start[1:], ids_s[1:], NULL)
        self.chain[ids_s[-1]] = NULL
        heads = ids_s[grp_start]
        empty = tails == NULL
        self.buckets[gb[empty]] = heads[empty]
        self.chain[tails[~empty]] = heads[~empty]
        if self.mode == "full":
            vol = self.entries.vol
            vol[ids_s, 9] = self.chain[ids_s]
            link_dirty = tails[~empty]
            if link_dirty.numel():
                vol[link_dirty, 9] = self.chain[link_dirty]
                self.entries.mark_rows(link_dirty)
            self._persist_buckets(gb[empty])

    def _chain_tails(self, bkts: torch.Tensor) -> torch.Tensor:
        cur = self.buckets[bkts]
        tails = torch.full_like(bkts, NULL)
        active = cur != NULL
        while bool(active.any()):
            idx = cur[active]
            tails[active] = idx
            cur[active] = self.chain[idx]
            active = cur != NULL
        return tails

    def remove_batch(self, keys) -> torch.Tensor:
        """Tombstone deletion.  Returns mask of keys that were present."""
        with self.arena.epoch():
            return self._remove_batch(keys)

    def _remove_batch(self, keys) -> torch.Tensor:
        keys = self._dev(keys)
        slots = self._find_slots(keys)
        ok = slots != NULL
        s = torch.unique(slots[ok])
        if s.numel() == 0:
            self.header.mark_rows(np.array([0]))
            return ok
        hv = self.header.read_row(0)
        self._unlink(s)
        self.entries.vol[s, 0] = KEY_NULL
        hv[H_SIZE] -= s.numel()
        self.header.write_row(0, hv)
        self.entries.mark_rows(s)
        self.header.mark_rows(np.array([0]))
        return ok

    def _unlink(self, slots: torch.Tensor) -> None:
        """Remove `slots` from their bucket chains, all buckets in
        parallel: materialize the affected chains with chain_walk, mask
        out the removed members, relink the survivors in order."""
        bkts = torch.unique(self.hashes[slots] & (self.n_buckets - 1))
        members = chain_walk(self.chain, self.buckets[bkts],
                             method=self.chain_method)
        if members.shape[1] == 0:
            self.chain[slots] = NULL
            return
        valid = members != NULL
        keep = valid & ~torch.isin(members, slots)
        # compact survivors left (stable: chain order preserved)
        comp = torch.gather(members, 1, torch.sort(
            (~keep).to(torch.int8), dim=1, stable=True).indices)
        cnt = keep.sum(1)
        old_heads = self.buckets[bkts]
        new_heads = torch.where(cnt > 0, comp[:, 0], NULL)
        self.buckets[bkts] = new_heads
        # relink: comp[b, j] -> comp[b, j+1] for j+1 < cnt, last -> NULL
        chain_dirty = []
        if comp.shape[1] > 1:
            width = comp.shape[1] - 1
            m = (torch.arange(width, device=comp.device)[None, :] + 1) \
                < cnt[:, None]
            src, dst = comp[:, :-1][m], comp[:, 1:][m]
            changed = self.chain[src] != dst
            self.chain[src] = dst
            chain_dirty.append(src[changed])
        nz = torch.nonzero(cnt > 0).squeeze(1)
        last = comp[nz, cnt[nz] - 1]
        last_changed = self.chain[last] != NULL
        self.chain[last] = NULL
        chain_dirty.append(last[last_changed])
        self.chain[slots] = NULL
        if self.mode == "full":
            dirty = torch.unique(torch.cat(chain_dirty))
            if dirty.numel():
                self.entries.vol[dirty, 9] = self.chain[dirty]
                self.entries.mark_rows(dirty)
            self._persist_buckets(bkts[new_heads != old_heads])

    def _grow(self, fresh: int) -> None:
        if self.n_buckets >= self.n_buckets_max:
            return
        self.n_buckets *= 2
        self._rebuild_chains(fresh)
        if self.mode == "full":
            # a PM-resident rehash rewrites every chain pointer and the
            # whole bucket array — the full (expensive) flush
            live = torch.nonzero(self.keys[:fresh] != KEY_NULL).squeeze(1)
            self.entries.vol[live, 9] = self.chain[live]
            self.entries.mark_rows(live)
            self._pbuckets.vol[: self.n_buckets, 0] = \
                self.buckets[: self.n_buckets]
            self._pbuckets.mark_range(0, self.n_buckets)

    def _rebuild_chains(self, fresh: int) -> None:
        dev = self.arena.device
        live = torch.nonzero(self.keys[:fresh] != KEY_NULL).squeeze(1)
        self.buckets = torch.full((self.n_buckets,), NULL, dtype=torch.int64,
                                  device=dev)
        self.chain = torch.full((self.capacity,), NULL, dtype=torch.int64,
                                device=dev)
        if live.numel() == 0:
            return
        b = self.hashes[live] & (self.n_buckets - 1)
        bs, order = torch.sort(b, stable=True)  # slab order within bucket
        ls = live[order]
        grp_start = _group_starts(bs)
        self.buckets[bs[grp_start]] = ls[grp_start]
        self.chain[ls[:-1]] = torch.where(~grp_start[1:], ls[1:], NULL)
        self.chain[ls[-1]] = NULL

    # -------- crash / reconstruction --------
    def reconstruct(self) -> None:
        """Reload the regions and rebuild the volatile redundancy."""
        self.header.load()
        self.entries.load()
        rec.get("pstruct.hashmap")(self)


@rec.register("pstruct.hashmap")
def _reconstruct_hashmap(h: Hashmap) -> dict:
    """Pure rebuild (paper §IV-E3): SIZE + dense (KEY, VALUE) rows -> full
    hashmap.  Scan the slab rows [0, fresh) in one pass, drop NULL keys,
    recompute hashes, derive the bucket count from SIZE and the load
    factor, rebuild chains in slab order."""
    hv = h.header.read_row(0)
    if hv[H_FLAG] != 1:
        # uninitialized image recovers as an empty map
        hv[:] = 0
        h.header.write_row(0, hv)
    fresh = int(hv[H_FRESH])
    size = int(hv[H_SIZE])
    h.n_buckets = _next_pow2(max(16, int(size / h.load_factor) + 1))
    h.hashes = torch.zeros(h.capacity, dtype=torch.int64,
                           device=h.arena.device)
    idx = torch.nonzero(h.keys[:fresh] != KEY_NULL).squeeze(1)
    h.hashes[idx] = hash64(h.keys[idx])
    h._rebuild_chains(fresh)
    return {"mode": h.mode, "size": size, "live": int(idx.numel())}


def _next_pow2(x: int) -> int:
    return 1 << (int(x - 1)).bit_length()
