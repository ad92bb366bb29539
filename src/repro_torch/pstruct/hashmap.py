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

Order snapshots (DESIGN.md §10, on unless ``snapshot=False`` or
``REPRO_SNAPSHOT=0``): persisted mirrors of the bucket heads
(``snapbkt``) and chain links (``snapchain``) plus a 4-slot record ring
(``snaprec``), written by a snapshot provider at every drain.  Recovery
seeds the chains from the newest committed record, links the slab rows
appended after it, verifies the result is the canonical chain assembly
and adopts it (restoring the record's bucket count), else rebuilds.  The
dirty masks are bool tensors on the arena's device, so marking costs no
sync; each emit finds the dirty rows with one ``nonzero`` per mask.

Salvage (DESIGN.md §13): entry rows below the fresh-water mark that fail
their checksums become tombstones on the device; their keys, read from
the persistent image, go into ``quarantined``, SIZE drops by the live rows
lost, and the chains are rebuilt (a salvaged map never adopts a
snapshot, whose mirrors may name the dropped rows).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import reconstruct as rec
from repro_torch.core.arena import (SNAP_SLOTS, SNAP_WORDS, Arena,
                                    FlushStats, newest_committed,
                                    snap_record_pack, snap_records,
                                    snapshot_enabled)
from repro_torch.core.recovery import chain_walk
from repro_torch.pstruct.dll import _salvage_bad_rows

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
        self.mode = mode
        self.capacity = capacity
        self.load_factor = load_factor
        self.chain_method = chain_method
        self.arena = arena
        row = 8 if mode == "partly" else 16
        self.entries = arena.regions.get(f"{name}.entries") or arena.region(
            f"{name}.entries", np.int64, (capacity, row), router=("hash",))
        self.header = arena.regions.get(f"{name}.header") or arena.region(
            f"{name}.header", np.int64, (1, 8))
        n_max = _next_pow2(max(16, int(capacity / load_factor)))
        self.n_buckets_max = n_max
        # full mode keeps the bucket array itself persistent
        self._pbuckets = None
        if mode == "full":
            self._pbuckets = arena.regions.get(f"{name}.buckets") or \
                arena.region(f"{name}.buckets", np.int64, (n_max, 1),
                             router=("seg", 64))
        dev = arena.device
        self.n_buckets = n_max
        self.buckets = torch.full((self.n_buckets,), NULL,
                                  dtype=torch.int64, device=dev)
        self.chain = torch.full((capacity,), NULL, dtype=torch.int64,
                                device=dev)
        # cached hashes: uint64 values held as int64 bit patterns
        self.hashes = torch.zeros(capacity, dtype=torch.int64, device=dev)
        # keys lost to media corruption in the last salvage recovery
        self.quarantined: set = set()
        # order snapshots; OFF when the layout was finalized without the
        # snapshot regions, as in the reference
        snap_on = snapshot_enabled(snapshot)
        self.snapbkt = arena.regions.get(f"{name}.snapbkt")
        self.snapchain = arena.regions.get(f"{name}.snapchain")
        self.snaprec = arena.regions.get(f"{name}.snaprec")
        if snap_on and self.snapbkt is None and not arena._layout_final:
            self.snapbkt = arena.region(f"{name}.snapbkt", np.int64,
                                        (n_max,), router=("seg", 64))
            self.snapchain = arena.region(f"{name}.snapchain", np.int64,
                                          (capacity,), router=("hash",))
            self.snaprec = arena.region(f"{name}.snaprec", np.int64,
                                        (SNAP_SLOTS, SNAP_WORDS))
        self.snapshot = snap_on and self.snapbkt is not None
        if self.snapshot:
            self._snap_bkt_dirty = torch.zeros(n_max, dtype=torch.bool,
                                               device=dev)
            self._snap_chain_dirty = torch.zeros(capacity, dtype=torch.bool,
                                                 device=dev)
            self._snap_seq = 0
            self._snap_resync = True
            self._snap_last = None     # (nb, fresh, size) at the last emit
            arena.add_snapshot_provider(self._snap_emit)

    @staticmethod
    def layout(capacity: int, mode: str = "partly", name: str = "hm",
               load_factor: float = 0.75, snapshot: Optional[bool] = None):
        row = 8 if mode == "partly" else 16
        out = {f"{name}.entries": (np.int64, (capacity, row), ("hash",)),
               f"{name}.header": (np.int64, (1, 8))}
        n_max = _next_pow2(max(16, int(capacity / load_factor)))
        if mode == "full":
            out[f"{name}.buckets"] = (np.int64, (n_max, 1), ("seg", 64))
        if snapshot_enabled(snapshot):
            out[f"{name}.snapbkt"] = (np.int64, (n_max,), ("seg", 64))
            out[f"{name}.snapchain"] = (np.int64, (capacity,), ("hash",))
            out[f"{name}.snaprec"] = (np.int64, (SNAP_SLOTS, SNAP_WORDS))
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

    @property
    def size(self) -> int:
        """Live entries, from the header line (one device sync)."""
        return self.header.read_one(0, H_SIZE)

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
        new_bkts, link_dirty = gb[empty], tails[~empty]
        self.buckets[new_bkts] = heads[empty]
        self.chain[link_dirty] = heads[~empty]
        if self.snapshot:
            self._snap_chain_dirty[ids_s] = True
            self._snap_chain_dirty[link_dirty] = True
            self._snap_bkt_dirty[new_bkts] = True
        if self.mode == "full":
            vol = self.entries.vol
            vol[ids_s, 9] = self.chain[ids_s]
            if link_dirty.numel():
                vol[link_dirty, 9] = self.chain[link_dirty]
                self.entries.mark_rows(link_dirty)
            self._persist_buckets(new_bkts)

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
        if self.snapshot:
            self._snap_bkt_dirty[bkts] = True
            self._snap_chain_dirty[slots] = True
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
            moved = src[self.chain[src] != dst]
            self.chain[src] = dst
            chain_dirty.append(moved)
        nz = torch.nonzero(cnt > 0).squeeze(1)
        last = comp[nz, cnt[nz] - 1]
        chain_dirty.append(last[self.chain[last] != NULL])
        self.chain[last] = NULL
        if self.snapshot:
            for moved in chain_dirty:
                self._snap_chain_dirty[moved] = True
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
        if self.snapshot:
            # every link may have moved: re-mirror wholesale at the next
            # drain (grows are O(log N) rare)
            self._snap_resync = True
        if live.numel() == 0:
            return
        b = self.hashes[live] & (self.n_buckets - 1)
        bs, order = torch.sort(b, stable=True)  # slab order within bucket
        ls = live[order]
        grp_start = _group_starts(bs)
        self.buckets[bs[grp_start]] = ls[grp_start]
        self.chain[ls[:-1]] = torch.where(~grp_start[1:], ls[1:], NULL)
        self.chain[ls[-1]] = NULL

    # -------- incremental order snapshots (DESIGN.md §10) --------
    def _snap_emit(self):
        """Snapshot provider: mirror the bucket heads and chain links
        dirtied since the last emit, then seal one record line naming
        (n_buckets, fresh, size) for the generation the next commit
        seals.  Idempotent: nothing newly dirty and an unchanged state
        emit nothing."""
        out = []
        hv = self.header.read_row(0)
        fresh = int(hv[H_FRESH])
        if self._snap_resync:
            self._snap_chain_dirty.zero_()
            self._snap_bkt_dirty.zero_()
            self._snap_chain_dirty[:fresh] = True
            self._snap_bkt_dirty[:self.n_buckets] = True
            self._snap_resync = False
        cd = torch.nonzero(self._snap_chain_dirty).squeeze(1)
        bd = torch.nonzero(self._snap_bkt_dirty).squeeze(1)
        state = (self.n_buckets, fresh, int(hv[H_SIZE]))
        if state == self._snap_last and not cd.numel() and not bd.numel():
            return out
        self._snap_last = state
        if cd.numel():
            self.snapchain.vol[cd] = self.chain[cd]
            out.append((self.snapchain, cd))
            self._snap_chain_dirty.zero_()
        if bd.numel():
            self.snapbkt.vol[bd] = self.buckets[bd]
            out.append((self.snapbkt, bd))
            self._snap_bkt_dirty.zero_()
        seq = self._snap_seq
        self._snap_seq += 1
        slot = seq % SNAP_SLOTS
        self.snaprec.write_row(slot, snap_record_pack(
            self.arena.generation + 1, seq, self.n_buckets, fresh,
            int(hv[H_SIZE])))
        out.append((self.snaprec, np.asarray([slot], np.int64)))
        return out

    # -------- crash / reconstruction --------
    def reconstruct(self) -> None:
        """Reload the regions and rebuild the volatile redundancy."""
        self.header.load()
        self.entries.load()
        if self.snapshot:
            self.snapbkt.load()
            self.snapchain.load()
            self.snaprec.load()
        rec.get("pstruct.hashmap")(self)

    def check_against(self, ref: dict) -> bool:
        """Whether the map holds exactly ``ref`` ({key: 7 value words})."""
        ks = np.fromiter(ref.keys(), np.int64, len(ref))
        ok, vals = self.find_batch(ks)
        if not bool(ok.all()) or self.size != len(ref):
            return False
        if not len(ref):
            return True
        want = np.stack([np.asarray(ref[int(k)], np.int64) for k in ks])
        return bool(np.array_equal(vals.cpu().numpy(), want))

    def flush_stats(self) -> FlushStats:
        return self.arena.stats


def _hm_snap_resume(h: Hashmap) -> None:
    recs = snap_records(h.snaprec)
    h._snap_seq = (max(r[1] for r in recs) + 1) if recs else 0
    h._snap_bkt_dirty.zero_()
    h._snap_chain_dirty.zero_()
    h._snap_resync = True
    h._snap_last = None


def _hm_snap_adopt(h: Hashmap, fresh: int, idx: torch.Tensor
                   ) -> Optional[int]:
    """Seed the bucket chains from the newest committed snapshot, link the
    slab rows younger than the record, VERIFY the result is the canonical
    chain assembly (every live row once, in its hash bucket, ascending
    slab order) and scatter it into fresh volatile tensors, restoring the
    record's bucket count.  Returns the replayed-suffix length on
    adoption, None on any mismatch (the caller rebuilds).

    The suffix tail walk and ``chain_walk`` test for their end with one
    device sync per round; rounds are bounded by the longest bucket
    chain (about 10 at load factor 0.75)."""
    best = newest_committed(h.snaprec)
    if best is None:
        return None
    _, _, rec_nb, rec_fresh, _, _ = best
    if not (16 <= rec_nb <= h.n_buckets_max and rec_nb & (rec_nb - 1) == 0):
        return None
    if not 0 <= rec_fresh <= fresh:
        return None
    dev = h.arena.device
    mask = rec_nb - 1
    cand_bkt = h.snapbkt.vol[:rec_nb].clone()
    cand_chain = h.snapchain.vol.clone()
    # link only the suffix: rows the record predates were appended at
    # their bucket's chain tail in ascending slab order; replay that
    sfx = idx[idx >= rec_fresh]
    if sfx.numel():
        b = hash64(h.keys[sfx]) & mask
        bs, order = torch.sort(b, stable=True)
        ids_s = sfx[order]
        grp_start = _group_starts(bs)
        tb = bs[grp_start]
        cur = cand_bkt[tb]
        tails = torch.full_like(tb, NULL)
        # tails over the candidate arrays; torn links can cycle, so the
        # rounds are capped
        for _ in range(fresh + 1):
            ok = (cur >= 0) & (cur < h.capacity) & (cur < rec_fresh)
            if not bool(ok.any()):
                break
            tails = torch.where(ok, cur, tails)
            cur = torch.where(ok, cand_chain[torch.where(ok, cur, 0)], NULL)
        else:
            return None                       # never terminated: cycle
        cand_chain[ids_s[:-1]] = torch.where(~grp_start[1:], ids_s[1:], NULL)
        cand_chain[ids_s[-1]] = NULL
        heads = ids_s[grp_start]
        empty = tails == NULL
        cand_bkt[tb[empty]] = heads[empty]
        cand_chain[tails[~empty]] = heads[~empty]
    # verify-always: materialize every chain and check it IS the canonical
    # state
    try:
        members = chain_walk(cand_chain, cand_bkt, method=h.chain_method)
    except RuntimeError:
        return None                           # cycle in a torn chain
    valid = members != NULL
    flat = members[valid]
    if flat.numel() != idx.numel():
        return None
    if flat.numel():
        if bool(((flat < 0) | (flat >= fresh)).any()):
            return None
        keys = h.keys[flat]
        want_b = hash64(keys) & mask
        got_b = torch.arange(rec_nb, device=dev)[:, None].expand(
            members.shape)[valid]
        bad = (keys == KEY_NULL).any() | (want_b != got_b).any()
        if members.shape[1] > 1:
            # ascending slab order within each bucket row (rules out both
            # misordering and duplicates: a dupe must share a bucket)
            step = valid[:, 1:]
            bad = bad | (members[:, 1:][step] <= members[:, :-1][step]).any()
        if bool(bad):
            return None
    # adopt: the record's basis, the verified chains scattered
    h.n_buckets = int(rec_nb)
    h.buckets = torch.full((h.n_buckets,), NULL, dtype=torch.int64,
                           device=dev)
    h.chain = torch.full((h.capacity,), NULL, dtype=torch.int64, device=dev)
    if members.shape[1]:
        h.buckets[valid[:, 0]] = members[valid[:, 0], 0]
        if members.shape[1] > 1:
            step = valid[:, 1:]
            h.chain[members[:, :-1][step]] = members[:, 1:][step]
    return int(sfx.numel())


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
    # salvage: entry rows failing their sidecar become tombstones; the map
    # recovers every verifiable entry and refuses the rest by key.  A
    # corrupt VALUE word leaves the key word intact, so the quarantine
    # names the real key; a corrupt KEY word is recorded as read.
    h.quarantined = set()
    dropped = 0
    if h.arena._salvage:
        bad = _salvage_bad_rows(h.arena, h.entries)
        bad = bad[bad < fresh]
        if bad.size:
            keys = h.arena._pimage(h.entries, copy=False)[bad, 0]
            h.quarantined.update(int(k) for k in keys[keys != KEY_NULL])
            bad_t = torch.from_numpy(bad).to(h.arena.device)
            was_live = int((h.keys[bad_t] != KEY_NULL).sum())
            h.entries.vol[bad_t, 0] = KEY_NULL
            hv[H_SIZE] = max(0, int(hv[H_SIZE]) - was_live)
            h.header.write_row(0, hv)
            dropped = int(bad.size)
    size = int(hv[H_SIZE])
    h.n_buckets = _next_pow2(max(16, int(size / h.load_factor) + 1))
    h.hashes = torch.zeros(h.capacity, dtype=torch.int64,
                           device=h.arena.device)
    idx = torch.nonzero(h.keys[:fresh] != KEY_NULL).squeeze(1)
    h.hashes[idx] = hash64(h.keys[idx])
    detail = {"mode": h.mode, "size": size, "live": int(idx.numel())}
    if dropped:
        detail.update(degraded=True, quarantined_rows=dropped,
                      quarantined_keys=sorted(h.quarantined))
    # a salvaged map never adopts a snapshot: its mirrors may name the
    # quarantined rows
    replayed = _hm_snap_adopt(h, fresh, idx) \
        if h.snapshot and not dropped else None
    if replayed is None:
        h._rebuild_chains(fresh)
    if h.snapshot:
        detail["chain"] = "snapshot" if replayed is not None else "rebuild"
        detail["replayed"] = replayed if replayed is not None \
            else detail["live"]
        _hm_snap_resume(h)
    return detail


def _next_pow2(x: int) -> int:
    return 1 << (int(x - 1)).bit_length()
