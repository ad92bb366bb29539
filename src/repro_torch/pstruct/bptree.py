"""Partly-persistent B+Tree (paper §IV-D), the port of
``repro.pstruct.bptree``.

Node layout (the paper's Listing 2): one node = 256 B = 4 cache lines, an
int32 row of 64 words:

  [0] num_keys  [1] is_leaf  [2:20] keys (18 x i32)
  [20:39] pointers (19 x i32: children for inner, record ids for leaves)
  [40] next (leaf chain)  [41] parent  [42:] pad

Records (the paper's 64 B ``struct record`` holding a 7-word Value) live in
a dense (cap, 8) int64 region — 1 line per record.  Both modes share one
node region; *partly* persists only leaf rows (+ records + header), inner
rows are volatile redundancy; *fully* persists every dirty node row.

The node rows, records and ``leaf_prev`` live on the arena's device.  An
insert or delete walks the tree on the device (one vectorized descent),
then its per-leaf merge and split logic — scalar, data-dependent control
flow — runs on a host staging copy of just the rows it touches
(``_Stage``): fetched in one gather, edited with the reference's own
numpy code, and scattered back in one write before the epoch drains.  A
batch costs a handful of device syncs instead of several per leaf.

Reconstruction (paper §IV-D3): rank the persistent leaf chain with the
shared ``chain_order`` primitive (pointer doubling at this size, on the
card's kernels), then bulk-load the inner levels bucketing ORDER children
per parent, one vectorized pass per level.

Salvage (DESIGN.md §13): a fully persistent tree has pointers woven
through every row, so any corrupt row quarantines it wholesale
(``CorruptLineError``).  A partly persistent tree keeps the longest prefix
of its leaf chain free of bad rows (``salvage_prefix``, on the chain
kernels), cuts the volatile chain there, names the keys of the intact
leaves it can no longer reach (read from the persistent image in one
vectorized pass), and drops the leaf slots whose record row is corrupt,
naming their keys.  Survivors are never quarantined.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import reconstruct as rec
from repro_torch.core.arena import Arena, CorruptLineError, FlushStats
from repro_torch.core.recovery import chain_method, chain_order, \
    salvage_prefix
from repro_torch.pstruct.dll import _image_col, _salvage_bad_rows

ORDER = 19
MAX_KEYS = ORDER - 1           # 18
SPLIT_FILL = ORDER // 2        # 9..10 keys per split target
NULL = -1
VALUE_WORDS = 7

# Sharded-arena routing (DESIGN.md §7): node rows route by leaf range,
# block-cyclic runs of 16 node ids (sequentially allocated leaves land in
# runs), records in 64-row ranges.
LEAF_RANGE = 16
REC_RANGE = 64

H_FLAG, H_ROOT, H_FIRST_LEAF, H_COUNT, H_FRESH_NODES, H_FRESH_RECS = range(6)

C_NK, C_LEAF = 0, 1
K0, K1 = 2, 20
P0, P1 = 20, 39
C_NEXT, C_PARENT = 40, 41


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.int64).numpy()
    return np.asarray(x, np.int64)


class _Stage:
    """Host staging copy of the rows one operation touches.

    ``row(i)`` returns a writable numpy view of node row i (fetched from
    the device on first touch; ``fetch`` gathers many at once), and
    ``fresh(ids)`` stages allocated rows without reading them.
    ``leaf_prev`` and record writes are buffered the same way.
    ``commit`` scatters every staged row back in one write each."""

    def __init__(self, t: "BPTree"):
        self.t = t
        self.rows: Dict[int, np.ndarray] = {}
        self.lp: Dict[int, int] = {}
        self.rec_ids: List[np.ndarray] = []
        self.rec_vals: List[np.ndarray] = []

    def fetch(self, ids) -> None:
        need = [i for i in dict.fromkeys(int(x) for x in ids)
                if i not in self.rows]
        if not need:
            return
        vol = self.t.nodes.vol
        got = vol[torch.tensor(need, device=vol.device)].cpu().numpy()
        for i, r in zip(need, got):
            self.rows[i] = r

    def row(self, i: int) -> np.ndarray:
        r = self.rows.get(int(i))
        if r is None:
            self.fetch([i])
            r = self.rows[int(i)]
        return r

    def fresh(self, ids) -> None:
        for i in ids:
            r = np.zeros(64, np.int32)
            r[C_NEXT] = NULL
            r[C_PARENT] = NULL
            self.rows[int(i)] = r

    def leaf_prev(self, i: int) -> int:
        v = self.lp.get(int(i))
        return int(self.t.leaf_prev[int(i)]) if v is None else v

    def set_leaf_prev(self, i: int, v: int) -> None:
        self.lp[int(i)] = int(v)

    def write_records(self, ids: np.ndarray, vals: np.ndarray) -> None:
        self.rec_ids.append(np.asarray(ids, np.int64))
        self.rec_vals.append(np.asarray(vals, np.int64))

    def commit(self) -> None:
        t = self.t
        dev = t.nodes.vol.device
        if self.rows:
            ids = np.fromiter(self.rows, np.int64, len(self.rows))
            t.nodes.vol[torch.from_numpy(ids).to(dev)] = torch.from_numpy(
                np.stack([self.rows[i] for i in ids.tolist()])).to(dev)
        if self.lp:
            ids = np.fromiter(self.lp, np.int64, len(self.lp))
            vals = np.fromiter(self.lp.values(), np.int32, len(self.lp))
            t.leaf_prev[torch.from_numpy(ids).to(dev)] = \
                torch.from_numpy(vals).to(dev)
        if self.rec_ids:
            ids = np.concatenate(self.rec_ids)
            vals = np.concatenate(self.rec_vals)
            # later writes of a record win, as the reference's sequence
            # of row writes would have it
            _, last = np.unique(ids[::-1], return_index=True)
            keep = ids.size - 1 - last
            t.records.vol[torch.from_numpy(ids[keep]).to(dev),
                          :VALUE_WORDS] = torch.from_numpy(vals[keep]).to(dev)
        self.rows, self.lp = {}, {}
        self.rec_ids, self.rec_vals = [], []


class BPTree:
    def __init__(self, arena: Arena, cap_nodes: int, cap_records: int,
                 mode: str = "partly", name: str = "bt",
                 chain_method: str = "auto"):
        if mode not in ("partly", "full"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.arena = arena
        self.cap_nodes = cap_nodes
        self.cap_records = cap_records
        self.chain_method = chain_method
        self.nodes = arena.regions.get(f"{name}.nodes") or arena.region(
            f"{name}.nodes", np.int32, (cap_nodes, 64),
            router=("seg", LEAF_RANGE))
        self.records = arena.regions.get(f"{name}.records") or arena.region(
            f"{name}.records", np.int64, (cap_records, 8),
            router=("seg", REC_RANGE))
        self.header = arena.regions.get(f"{name}.header") or arena.region(
            f"{name}.header", np.int64, (1, 8))
        self._free_nodes: List[int] = []
        self._free_recs: List[int] = []
        self.leaf_prev = torch.full((cap_nodes,), NULL, dtype=torch.int32,
                                    device=arena.device)
        self._hvc = None     # host header row while an operation runs
        self._st = None      # the operation's _Stage
        # keys lost to media corruption in the last salvage recovery (best
        # effort: readable from intact but unreachable leaf rows)
        self.quarantined: set = set()

    @staticmethod
    def layout(cap_nodes: int, cap_records: int, mode: str = "partly",
               name: str = "bt"):
        return {f"{name}.nodes": (np.int32, (cap_nodes, 64),
                                  ("seg", LEAF_RANGE)),
                f"{name}.records": (np.int64, (cap_records, 8),
                                    ("seg", REC_RANGE)),
                f"{name}.header": (np.int64, (1, 8))}

    def _begin(self) -> Tuple[np.ndarray, _Stage]:
        self._hvc, self._st = self.header.read_row(0), _Stage(self)
        return self._hvc, self._st

    def _end(self) -> None:
        self._st.commit()
        self.header.write_row(0, self._hvc)
        self._hvc = self._st = None

    # ---------------- allocation ----------------
    # The free lists pop from the back, exactly as the reference's do: their
    # order decides which rows a later insert rewrites, so any other order
    # would change the persistent bytes.
    def _alloc_nodes(self, m: int) -> np.ndarray:
        hv = self._hvc
        ids = []
        take = min(len(self._free_nodes), m)
        if take:
            ids.extend(self._free_nodes[-take:])
            del self._free_nodes[-take:]
        need = m - take
        if need:
            f0 = int(hv[H_FRESH_NODES])
            if f0 + need > self.cap_nodes:
                raise MemoryError("bptree node arena exhausted")
            ids.extend(range(f0, f0 + need))
            hv[H_FRESH_NODES] = f0 + need
        arr = np.asarray(ids, np.int32)
        self._st.fresh(arr)
        return arr

    def _alloc_recs(self, m: int) -> np.ndarray:
        hv = self._hvc
        ids = []
        take = min(len(self._free_recs), m)
        if take:
            ids.extend(self._free_recs[-take:])
            del self._free_recs[-take:]
        need = m - take
        if need:
            f0 = int(hv[H_FRESH_RECS])
            if f0 + need > self.cap_records:
                raise MemoryError("bptree record arena exhausted")
            ids.extend(range(f0, f0 + need))
            hv[H_FRESH_RECS] = f0 + need
        return np.asarray(ids, np.int64)

    # ---------------- flush policy ----------------
    def _mark_nodes(self, dirty) -> None:
        """Mark dirty (staged) node rows into the arena write set.  Partly
        mode persists only leaf rows — inner nodes are volatile
        redundancy."""
        dirty = np.unique(np.asarray(dirty, np.int64))
        if dirty.size == 0:
            return
        if self.mode == "partly":
            st = self._st
            leaf = np.fromiter((st.row(i)[C_LEAF] == 1 for i in dirty),
                               bool, dirty.size)
            dirty = dirty[leaf]
            if dirty.size == 0:
                return
        self.nodes.mark_rows(dirty)

    # ---------------- search ----------------
    def _descend(self, keys: torch.Tensor, root: int) -> torch.Tensor:
        """Leaf id for each key (vectorized level-synchronous descent on
        the device)."""
        vol = self.nodes.vol
        cur = torch.full(keys.shape, root, dtype=torch.int64,
                         device=vol.device)
        keys = keys.to(torch.int32)
        slots = torch.arange(MAX_KEYS, device=vol.device)[None, :]
        for _ in range(64):  # depth bound
            rows = vol[cur]
            inner = rows[:, C_LEAF] == 0
            if not bool(inner.any()):
                break
            r = rows[inner]
            valid = slots < r[:, C_NK:C_NK + 1]
            pos = ((r[:, K0:K1] <= keys[inner, None]) & valid).sum(1)
            child = r[torch.arange(r.shape[0], device=vol.device), P0 + pos]
            cur = cur.clone()
            cur[inner] = child.long()
        return cur

    def find_batch(self, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self.arena.device
        keys = torch.as_tensor(keys, dtype=torch.int64, device=dev)
        m = keys.shape[0]
        hv = self.header.read_row(0)
        vals = torch.zeros((m, VALUE_WORDS), dtype=torch.int64, device=dev)
        if hv[H_FLAG] == 0 or hv[H_ROOT] == NULL:
            return torch.zeros(m, dtype=torch.bool, device=dev), vals
        leaves = self._descend(keys, int(hv[H_ROOT]))
        rows = self.nodes.vol[leaves]
        valid = torch.arange(MAX_KEYS, device=dev)[None, :] \
            < rows[:, C_NK:C_NK + 1]
        hit = (rows[:, K0:K1] == keys[:, None].to(torch.int32)) & valid
        ok = hit.any(1)
        slot = hit.to(torch.int32).argmax(1)
        recs = rows[torch.arange(m, device=dev), P0 + slot]
        vals[ok] = self.records.vol[recs[ok].long(), :VALUE_WORDS]
        return ok, vals

    # ---------------- insert ----------------
    def insert_batch(self, keys, values) -> None:
        with self.arena.epoch():
            self._insert_batch(keys, values)

    def _insert_batch(self, keys, values) -> None:
        keys, values = _host(keys), _host(values)
        # de-dup batch (keep last)
        _, last = np.unique(keys[::-1], return_index=True)
        keep = np.sort(len(keys) - 1 - last)
        keys, values = keys[keep], values[keep]
        hv, st = self._begin()
        if hv[H_FLAG] == 0 or hv[H_ROOT] == NULL:
            root = int(self._alloc_nodes(1)[0])
            st.row(root)[C_LEAF] = 1
            hv[H_ROOT] = root
            hv[H_FIRST_LEAF] = root
            hv[H_FLAG] = 1
            st.commit()          # the descent reads the device rows
        dev = self.arena.device
        leaves = self._descend(torch.from_numpy(keys).to(dev),
                               int(hv[H_ROOT])).cpu().numpy()
        order = np.argsort(leaves, kind="stable")
        bounds = np.flatnonzero(np.diff(leaves[order])) + 1
        groups = np.split(order, bounds) if order.size else []
        st.fetch(leaves[order[np.concatenate([[0], bounds])]]
                 if order.size else [])
        promo: List[Tuple[int, int, int]] = []  # (left, sep_key, right)
        for sel in groups:
            promo.extend(self._leaf_merge(int(leaves[sel[0]]), keys[sel],
                                          values[sel]))
        # propagate splits upward
        while promo:
            promo = self._parent_insert(promo)
        self._end()
        self.header.mark_rows(np.array([0]))

    def _leaf_merge(self, leaf: int, ks: np.ndarray, vs: np.ndarray):
        hv, st = self._hvc, self._st
        row = st.row(leaf)
        nk = int(row[C_NK])
        old_k = row[K0:K0 + nk].astype(np.int64)
        old_p = row[P0:P0 + nk].copy()
        ks32 = ks.astype(np.int32)
        # in-place updates for duplicates
        dup = np.isin(ks32, old_k.astype(np.int32))
        if dup.any():
            pos = np.searchsorted(old_k, ks[dup])
            recs = old_p[pos].astype(np.int64)
            st.write_records(recs, vs[dup])
            self.records.mark_rows(recs)
        new_mask = ~dup
        if not new_mask.any():
            return []
        nks, nvs = ks[new_mask], vs[new_mask]
        f0 = int(hv[H_FRESH_RECS])
        recs = self._alloc_recs(len(nks))
        st.write_records(recs, nvs)
        fr = recs[recs >= f0]
        if fr.size:
            self.records.mark_rows(fr, fresh=True)
        rew = recs[recs < f0]
        if rew.size:
            self.records.mark_rows(rew)
        merged_k = np.concatenate([old_k, nks])
        merged_p = np.concatenate([old_p.astype(np.int64), recs])
        so = np.argsort(merged_k, kind="stable")
        merged_k, merged_p = merged_k[so], merged_p[so]
        hv[H_COUNT] += len(nks)
        if len(merged_k) <= MAX_KEYS:
            self._write_leaf(leaf, merged_k, merged_p)
            self._mark_nodes(np.array([leaf]))
            return []
        # split into chunks of SPLIT_FILL (last chunk takes remainder <= MAX)
        n = len(merged_k)
        cuts = list(range(SPLIT_FILL, n, SPLIT_FILL))
        if cuts and n - cuts[-1] < 2:
            cuts = cuts[:-1]
        chunks_k = np.split(merged_k, cuts)
        chunks_p = np.split(merged_p, cuts)
        new_ids = self._alloc_nodes(len(chunks_k) - 1)
        for nid in new_ids:
            st.row(nid)[C_LEAF] = 1
        old_next = int(row[C_NEXT])
        chain = [leaf] + new_ids.tolist()
        promos = []
        for idx, (nid, ck, cp) in enumerate(zip(chain, chunks_k, chunks_p)):
            self._write_leaf(nid, ck, cp)
            if idx > 0:
                promos.append((chain[idx - 1], int(ck[0]), nid))
        for a, b in zip(chain[:-1], chain[1:]):
            st.row(a)[C_NEXT] = b
            st.set_leaf_prev(b, a)
        st.row(chain[-1])[C_NEXT] = old_next
        if old_next != NULL:
            st.set_leaf_prev(old_next, chain[-1])
        parent = int(row[C_PARENT])
        for nid in new_ids:
            st.row(nid)[C_PARENT] = parent
        self._mark_nodes(np.asarray(chain, np.int64))
        return promos

    def _write_leaf(self, nid: int, ks: np.ndarray, ps: np.ndarray) -> None:
        row = self._st.row(nid)
        row[C_NK] = len(ks)
        row[K0:K1] = 0
        row[K0:K0 + len(ks)] = ks.astype(np.int32)
        row[P0:P1] = 0
        row[P0:P0 + len(ks)] = ps.astype(np.int32)

    def _parent_insert(self, promo: List[Tuple[int, int, int]]):
        """Insert (sep, right) pairs after `left` in their parents.  Returns
        next level's promotions."""
        hv, st = self._hvc, self._st
        st.fetch(p for p in (st.row(left)[C_PARENT] for left, _, _ in promo)
                 if p != NULL)
        dirty: List[int] = []
        by_parent: Dict[int, List[Tuple[int, int, int]]] = {}
        for left, sep, right in promo:
            parent = int(st.row(left)[C_PARENT])
            if parent == NULL:
                # splitting the root: create a new root holding just `left`
                # (0 separators); the (sep, right) pair is then inserted via
                # the regular path below.
                new_root = int(self._alloc_nodes(1)[0])
                r = st.row(new_root)
                r[C_LEAF] = 0
                r[C_NK] = 0
                r[P0] = left
                st.row(left)[C_PARENT] = new_root
                hv[H_ROOT] = new_root
                dirty.append(new_root)
                parent = new_root
            # Set the right child's parent EAGERLY so later promotions in
            # this same pass (whose `left` is this `right`) resolve to the
            # correct parent.
            st.row(right)[C_PARENT] = parent
            if self.mode == "full":
                dirty.append(right)  # parent field is persistent
            by_parent.setdefault(parent, []).append((left, sep, right))
        next_promo: List[Tuple[int, int, int]] = []
        plans = []
        for parent, items in by_parent.items():
            row = st.row(parent)
            nk = int(row[C_NK])
            keysv = row[K0:K0 + nk].astype(np.int64).tolist()
            ptrs = row[P0:P0 + nk + 1].astype(np.int64).tolist()
            for left, sep, right in items:
                at = ptrs.index(left) + 1
                keysv.insert(at - 1, sep)
                ptrs.insert(at, right)
            plans.append((parent, keysv, ptrs))
        # every parent of this pass sits on one tree level, so no split
        # below touches another plan's row: stage the children of all the
        # splitting parents in ONE gather
        st.fetch(c for _, keysv, ptrs in plans if len(keysv) > MAX_KEYS
                 for c in ptrs)
        for parent, keysv, ptrs in plans:
            if len(keysv) <= MAX_KEYS:
                self._write_inner(parent, keysv, ptrs)
                dirty.append(parent)
                continue
            # split inner node into chunks of <= MAX_KEYS keys
            all_k, all_p = keysv, ptrs
            chunks: List[Tuple[List[int], List[int]]] = []
            seps: List[int] = []
            i = 0
            n = len(all_k)
            while True:
                take = min(SPLIT_FILL, n - i)
                if n - (i + take) == 0:
                    chunks.append((all_k[i:i + take], all_p[i:i + take + 1]))
                    break
                if n - (i + take + 1) < 1:  # leave >=1 key for the last chunk
                    take = n - i - 2
                chunks.append((all_k[i:i + take], all_p[i:i + take + 1]))
                seps.append(all_k[i + take])
                i += take + 1
            new_ids = self._alloc_nodes(len(chunks) - 1)
            node_ids = [parent] + new_ids.tolist()
            for nid, (ck, cp) in zip(node_ids, chunks):
                self._write_inner(nid, ck, cp)
                for c in cp:
                    st.row(c)[C_PARENT] = nid
                if self.mode == "full":
                    dirty.extend(int(c) for c in cp)
                dirty.append(nid)
            gp = int(st.row(parent)[C_PARENT])
            for nid in new_ids:
                st.row(nid)[C_PARENT] = gp
            for li, sep in enumerate(seps):
                next_promo.append((node_ids[li], sep, node_ids[li + 1]))
        self._mark_nodes(np.asarray(dirty, np.int64))
        return next_promo

    def _write_inner(self, nid: int, ks, ps) -> None:
        row = self._st.row(nid)
        row[C_LEAF] = 0
        row[C_NK] = len(ks)
        row[K0:K1] = 0
        row[K0:K0 + len(ks)] = np.asarray(ks, np.int32)
        row[P0:P1] = 0
        row[P0:P0 + len(ps)] = np.asarray(ps, np.int32)

    # ---------------- delete ----------------
    def delete_batch(self, keys) -> torch.Tensor:
        with self.arena.epoch():
            return self._delete_batch(keys)

    def _delete_batch(self, keys) -> torch.Tensor:
        keys = _host(keys)
        dev = self.arena.device
        hv, st = self._begin()
        ok = np.zeros(len(keys), bool)
        if hv[H_FLAG] == 0 or hv[H_ROOT] == NULL:
            self._end()
            return torch.from_numpy(ok).to(dev)
        leaves = self._descend(torch.from_numpy(keys).to(dev),
                               int(hv[H_ROOT])).cpu().numpy()
        order = np.argsort(leaves, kind="stable")
        bounds = np.flatnonzero(np.diff(leaves[order])) + 1
        groups = np.split(order, bounds) if order.size else []
        st.fetch(leaves[order[np.concatenate([[0], bounds])]]
                 if order.size else [])
        for sel in groups:
            leaf = int(leaves[sel[0]])
            row = st.row(leaf)
            nk = int(row[C_NK])
            old_k = row[K0:K0 + nk].astype(np.int64)
            old_p = row[P0:P0 + nk].astype(np.int64)
            hit = np.isin(old_k, keys[sel])
            ok[sel] = np.isin(keys[sel], old_k)
            if not hit.any():
                continue
            self._free_recs.extend(old_p[hit].tolist())
            keep_k, keep_p = old_k[~hit], old_p[~hit]
            hv[H_COUNT] -= int(hit.sum())
            self._write_leaf(leaf, keep_k, keep_p)
            self._mark_nodes(np.array([leaf]))
            if len(keep_k) == 0:
                self._unlink_leaf(leaf)
        self._end()
        self.header.mark_rows(np.array([0]))
        return torch.from_numpy(ok).to(dev)

    def _unlink_leaf(self, leaf: int) -> None:
        hv, st = self._hvc, self._st
        nxt = int(st.row(leaf)[C_NEXT])
        prv = st.leaf_prev(leaf)
        if prv != NULL:
            st.row(prv)[C_NEXT] = nxt
            self._mark_nodes(np.array([prv]))
        else:
            hv[H_FIRST_LEAF] = nxt
        if nxt != NULL:
            st.set_leaf_prev(nxt, prv)
        # detach from parent (recursively removing emptied inner nodes)
        self._remove_child(int(st.row(leaf)[C_PARENT]), leaf)
        self._free_nodes.append(leaf)

    def _remove_child(self, parent: int, child: int) -> None:
        hv, st = self._hvc, self._st
        if parent == NULL:
            if int(hv[H_ROOT]) == child:
                hv[H_ROOT] = NULL
                hv[H_FLAG] = 1  # initialized-but-empty
            return
        row = st.row(parent)
        nk = int(row[C_NK])
        ptrs = row[P0:P0 + nk + 1].astype(np.int64).tolist()
        if child in ptrs:
            at = ptrs.index(child)
            keysv = row[K0:K0 + nk].astype(np.int64).tolist()
            del ptrs[at]
            if nk:
                del keysv[max(0, at - 1)]
            if not ptrs:
                self._remove_child(int(row[C_PARENT]), parent)
                self._free_nodes.append(parent)
                return
            self._write_inner(parent, keysv, ptrs)
            self._mark_nodes(np.array([parent]))

    # ---------------- traversal ----------------
    def leaves(self) -> torch.Tensor:
        """Leaf ids in chain order via the shared chain_order primitive
        (NEXT sliced at the committed fresh-water mark; empty for an empty
        tree)."""
        hv = self.header.read_row(0)
        first = int(hv[H_FIRST_LEAF])
        if hv[H_FLAG] != 1 or first == NULL:
            return torch.empty(0, dtype=torch.int64,
                               device=self.arena.device)
        fresh = int(hv[H_FRESH_NODES])
        return chain_order(self.nodes.vol[:fresh, C_NEXT].long(), first,
                           method=self.chain_method)

    def _leaf_keys(self, leaves: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(keys (L, 18) int64, valid (L, 18)) of the given leaf rows."""
        rows = self.nodes.vol[leaves]
        valid = torch.arange(MAX_KEYS, device=rows.device)[None, :] \
            < rows[:, C_NK:C_NK + 1]
        return rows[:, K0:K1].long(), valid

    def keys_in_order(self) -> torch.Tensor:
        """All keys in sorted (leaf-chain) order, one masked gather over
        the leaf rows."""
        leaves = self.leaves()
        if leaves.numel() == 0:
            return torch.empty(0, dtype=torch.int64,
                               device=self.arena.device)
        keymat, valid = self._leaf_keys(leaves)
        return keymat[valid]

    def max_key(self) -> Optional[int]:
        """Largest key, read off the last non-empty leaf of the chain."""
        leaves = self.leaves()
        if leaves.numel() == 0:
            return None
        nks = self.nodes.vol[leaves, C_NK]
        ne = torch.nonzero(nks > 0).squeeze(1)
        if ne.numel() == 0:
            return None
        last = int(ne[-1])
        return int(self.nodes.vol[leaves[last], K0 + int(nks[last]) - 1])

    def flush_stats(self) -> FlushStats:
        return self.arena.stats

    # ---------------- crash / reconstruction ----------------
    def reconstruct(self) -> None:
        """Reload the regions and rebuild the volatile redundancy."""
        self.header.load()
        self.nodes.load()
        self.records.load()
        rec.get("pstruct.bptree")(self)

    def _bulk_load_level(self, parents: torch.Tensor, level: torch.Tensor,
                         mins: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Write one inner level in a single vectorized pass: bucket ORDER
        children per parent, build all parent rows in one (P, 64) buffer,
        scatter children's parent pointers once."""
        dev = level.device
        n_parents = parents.shape[0]
        n_level = level.shape[0]
        kids = torch.zeros(n_parents * ORDER, dtype=torch.int64, device=dev)
        kids[:n_level] = level
        kids = kids.view(n_parents, ORDER)
        kmins = torch.zeros(n_parents * ORDER, dtype=torch.int64, device=dev)
        kmins[:n_level] = mins
        kmins = kmins.view(n_parents, ORDER)
        counts = torch.clamp(
            n_level - torch.arange(n_parents, device=dev) * ORDER, max=ORDER)
        rowbuf = torch.zeros((n_parents, 64), dtype=torch.int32, device=dev)
        rowbuf[:, C_NK] = (counts - 1).to(torch.int32)
        keymask = torch.arange(MAX_KEYS, device=dev)[None, :] \
            < (counts - 1)[:, None]
        rowbuf[:, K0:K1] = torch.where(keymask, kmins[:, 1:], 0).to(
            torch.int32)
        ptrmask = torch.arange(ORDER, device=dev)[None, :] < counts[:, None]
        rowbuf[:, P0:P0 + ORDER] = torch.where(ptrmask, kids, 0).to(
            torch.int32)
        rowbuf[:, C_NEXT] = NULL
        rowbuf[:, C_PARENT] = NULL
        self.nodes.vol[parents] = rowbuf
        self.nodes.vol[level, C_PARENT] = parents.to(
            torch.int32).repeat_interleave(ORDER)[:n_level]
        return parents, kmins[:, 0]

    def _live_record_mask(self, leaves: torch.Tensor) -> torch.Tensor:
        """Records referenced by live leaves, one vectorized gather."""
        rec_live = torch.zeros(self.cap_records, dtype=torch.bool,
                               device=leaves.device)
        if leaves.numel():
            rows = self.nodes.vol[leaves]
            valid = torch.arange(MAX_KEYS, device=rows.device)[None, :] \
                < rows[:, C_NK:C_NK + 1]
            rec_live[rows[:, P0:P0 + MAX_KEYS].long()[valid]] = True
        return rec_live

    def _alloc_nodes_reconstruct(self, m: int, live: torch.Tensor,
                                 hv: np.ndarray) -> torch.Tensor:
        """Allocate inner nodes during rebuild from non-live slots."""
        free = torch.nonzero(~live).squeeze(1)[:m]
        if free.numel() < m:
            raise MemoryError("bptree node arena exhausted during rebuild")
        live[free] = True
        self.nodes.vol[free] = 0
        self.nodes.vol[free, C_NEXT] = NULL
        self.nodes.vol[free, C_PARENT] = NULL
        hv[H_FRESH_NODES] = max(int(hv[H_FRESH_NODES]), int(free.max()) + 1)
        return free

    def _rebuild_volatile_only(self, hv: np.ndarray) -> None:
        """Fully-persistent mode: the tree is complete in PM; rebuild
        leaf_prev and the free lists."""
        dev = self.arena.device
        fresh = int(hv[H_FRESH_NODES])
        self.leaf_prev[:] = NULL
        leaves = self.leaves()
        if leaves.numel() == 0:
            return
        self.leaf_prev[leaves[1:]] = leaves[:-1].to(torch.int32)
        live = torch.zeros(self.cap_nodes, dtype=torch.bool, device=dev)
        live[leaves] = True
        cur = leaves
        while True:   # one round per tree LEVEL (O(log n) rounds)
            parents = torch.unique(self.nodes.vol[cur, C_PARENT]).long()
            parents = parents[parents != NULL]
            if parents.numel() == 0:
                break
            live[parents] = True
            cur = parents
        self._free_nodes = torch.nonzero(~live[:fresh]).squeeze(1).tolist()
        rec_live = self._live_record_mask(leaves)
        self._free_recs = torch.nonzero(
            ~rec_live[:int(hv[H_FRESH_RECS])]).squeeze(1).tolist()

    # ---------------- verification ----------------
    def check_invariants(self) -> None:
        """Leaf-chain order/sortedness/count, vectorized over the chain;
        raises AssertionError on a violation."""
        hv = self.header.read_row(0)
        if hv[H_FLAG] == 0 or hv[H_ROOT] == NULL:
            return
        leaves = self.leaves()
        if leaves.numel() == 0:
            if int(hv[H_COUNT]) != 0:
                raise AssertionError(f"empty leaf chain, count "
                                     f"{int(hv[H_COUNT])}")
            return
        rows = self.nodes.vol[leaves]
        if not bool((rows[:, C_LEAF] == 1).all()):
            raise AssertionError("non-leaf on leaf chain")
        nk = rows[:, C_NK].long()
        keymat = rows[:, K0:K1].long()
        valid = torch.arange(MAX_KEYS, device=rows.device)[None, :] \
            < nk[:, None]
        if not bool(((keymat[:, 1:] > keymat[:, :-1])
                     | ~valid[:, 1:]).all()):
            raise AssertionError("leaf keys not sorted")
        ne = nk > 0
        firsts = keymat[ne, 0]
        lasts = keymat[ne, nk[ne] - 1]
        if not bool((firsts[1:] > lasts[:-1]).all()):
            raise AssertionError("leaf chain out of order")
        total = int(nk.sum())
        if total != int(hv[H_COUNT]):
            raise AssertionError(f"leaf keys {total} != count "
                                 f"{int(hv[H_COUNT])}")


@rec.register("pstruct.bptree")
def _reconstruct_bptree(t: BPTree) -> dict:
    """Pure rebuild (paper §IV-D3): enumerate leaves via the persistent
    NEXT chain (count derived and cycle-checked), then bulk-load the inner
    levels bucketing ORDER children per parent.  Under salvage, the rows
    failing their checksums are dropped as the module docstring says."""
    hv = t.header.read_row(0)
    dev = t.arena.device
    t.quarantined = set()
    if hv[H_FLAG] != 1:
        # uninitialized image recovers as an empty tree
        hv[:] = 0
        hv[H_ROOT] = NULL
        hv[H_FIRST_LEAF] = NULL
        t.leaf_prev[:] = NULL
        t._free_nodes = []
        t._free_recs = []
        t.header.write_row(0, hv)
        return {"mode": t.mode, "count": 0}
    salvage = t.arena._salvage
    empty = np.empty(0, np.int64)
    bad_nodes = _salvage_bad_rows(t.arena, t.nodes) if salvage else empty
    bad_recs = _salvage_bad_rows(t.arena, t.records) if salvage else empty
    bad_nodes = bad_nodes[bad_nodes < t.cap_nodes]
    bad_recs = bad_recs[bad_recs < t.cap_records]
    corrupt = int(bad_nodes.size + bad_recs.size)
    if t.mode == "full":
        if corrupt:
            # pointers woven through every row: no committed-prefix
            # remainder to keep, so the whole stage quarantines
            raise CorruptLineError(
                t.nodes.name if bad_nodes.size else t.records.name,
                bad_nodes if bad_nodes.size else bad_recs,
                detail="fully-persistent tree: no salvageable remainder")
        t._rebuild_volatile_only(hv)
        return {"mode": "full", "count": int(hv[H_COUNT])}
    detail = {"mode": "partly"}
    bad_nodes_t = torch.from_numpy(bad_nodes).to(dev)
    bad_recs_t = torch.from_numpy(bad_recs).to(dev)
    # 1. enumerate leaves via the persistent next chain
    if bad_nodes.size:
        # salvage: keep the longest leaf-chain prefix that never touches a
        # corrupt row; everything after it is unreachable without trusting
        # rotten bytes
        fresh_n = int(hv[H_FRESH_NODES])
        nxt = _image_col(t.nodes, C_NEXT, dev)[:fresh_n]
        leaves = salvage_prefix(nxt, int(hv[H_FIRST_LEAF]), None,
                                bad_nodes_t, method=t.chain_method)
        if leaves.numel():
            t.nodes.vol[leaves[-1], C_NEXT] = NULL   # volatile chain cut
        _quarantine_unreachable(t, leaves, bad_nodes, fresh_n)
    else:
        try:
            leaves = t.leaves()
        except (RuntimeError, ValueError) as e:
            if not salvage:
                raise
            raise CorruptLineError(t.nodes.name, empty,
                                   detail=f"leaf chain rebuild: {e}") from e
    if leaves.numel() == 0:
        hv[H_ROOT] = NULL
        if corrupt:
            hv[H_FIRST_LEAF] = NULL
            hv[H_COUNT] = 0
            t.leaf_prev[:] = NULL
            live = torch.zeros(t.cap_nodes, dtype=torch.bool, device=dev)
            live[bad_nodes_t] = True   # corrupt rows are never reusable
            t._free_nodes = torch.nonzero(
                ~live[:int(hv[H_FRESH_NODES])]).squeeze(1).tolist()
            rec_live = torch.zeros(t.cap_records, dtype=torch.bool,
                                   device=dev)
            rec_live[bad_recs_t] = True
            t._free_recs = torch.nonzero(
                ~rec_live[:int(hv[H_FRESH_RECS])]).squeeze(1).tolist()
            t.header.write_row(0, hv)
            detail.update(count=0, quarantined=True, degraded=True,
                          quarantined_rows=corrupt,
                          quarantined_keys=sorted(t.quarantined))
            return detail
        t.header.write_row(0, hv)
        return {"mode": "partly", "count": 0}
    # 2. leaf prev (volatile redundancy)
    t.leaf_prev[:] = NULL
    t.leaf_prev[leaves[1:]] = leaves[:-1].to(torch.int32)
    # 2b. salvage: drop leaf slots whose record row is corrupt; the key is
    #     readable from the intact leaf, so it quarantines by name
    if bad_recs.size:
        _drop_bad_records(t, leaves, bad_recs_t)
    if corrupt:
        keymat, valid = t._leaf_keys(leaves)
        t.quarantined -= set(keymat[valid].tolist())  # survivors are kept
        hv[H_COUNT] = int(valid.sum())
        detail.update(degraded=True, quarantined_rows=corrupt,
                      quarantined_keys=sorted(t.quarantined))
    # 3. bulk-load inner levels, bucket size = ORDER; subtree minima are
    #    the separators, tracked per level
    level = leaves
    mins = t.nodes.vol[leaves, K0].long()
    # everything not a live leaf is free
    live = torch.zeros(t.cap_nodes, dtype=torch.bool, device=dev)
    live[level] = True
    live[bad_nodes_t] = True   # corrupt rows are never reusable
    while level.shape[0] > 1:
        n_parents = (level.shape[0] + ORDER - 1) // ORDER
        parents = t._alloc_nodes_reconstruct(n_parents, live, hv)
        level, mins = t._bulk_load_level(parents, level, mins)
    root = int(level[0])
    t.nodes.vol[root, C_PARENT] = NULL
    hv[H_ROOT] = root
    # 4. free lists: records referenced by live leaves are live
    t._free_nodes = torch.nonzero(
        ~live[:int(hv[H_FRESH_NODES])]).squeeze(1).tolist()
    rec_live = t._live_record_mask(leaves)
    rec_live[bad_recs_t] = True   # corrupt rows are never reusable
    t._free_recs = torch.nonzero(
        ~rec_live[:int(hv[H_FRESH_RECS])]).squeeze(1).tolist()
    t.header.write_row(0, hv)
    detail.update(count=int(hv[H_COUNT]), leaves=int(leaves.numel()),
                  chain=chain_method(int(hv[H_FRESH_NODES]), None,
                                     t.chain_method))
    return detail


def _quarantine_unreachable(t: BPTree, leaves: torch.Tensor,
                            bad_nodes: np.ndarray, fresh_n: int) -> None:
    """Name the keys of the intact leaf rows below ``fresh_n`` that the
    salvaged chain no longer reaches, read from the persistent image (the
    reference's per-row loop, in one masked pass).  Stale freed leaves
    over-quarantine only keys that are absent anyway; the keys inside the
    corrupt rows are unreadable and stay anonymous."""
    img = t.arena._pimage(t.nodes, copy=False)[:fresh_n]
    skip = np.zeros(fresh_n, bool)
    skip[leaves.cpu().numpy()] = True
    skip[bad_nodes[bad_nodes < fresh_n]] = True
    rows = img[~skip & (img[:, C_LEAF] == 1)]
    nk = np.clip(rows[:, C_NK], 0, MAX_KEYS)
    valid = np.arange(MAX_KEYS)[None, :] < nk[:, None]
    t.quarantined.update(rows[:, K0:K1][valid].astype(np.int64).tolist())


def _drop_bad_records(t: BPTree, leaves: torch.Tensor,
                      bad_recs: torch.Tensor) -> None:
    """Remove from each leaf the slots whose record row is corrupt,
    compacting the kept keys and pointers to the front of the row and
    zeroing the slots freed (the reference's per-leaf loop, in one
    vectorized pass over every leaf); the dropped keys are quarantined."""
    dev = leaves.device
    badrec = torch.zeros(t.cap_records, dtype=torch.bool, device=dev)
    badrec[bad_recs] = True
    rows = t.nodes.vol[leaves]
    nk = rows[:, C_NK].long()
    slot = torch.arange(MAX_KEYS, device=dev)[None, :]
    valid = slot < nk[:, None]
    ptrs = rows[:, P0:P0 + MAX_KEYS].long()
    hit = valid & badrec[torch.where(valid, ptrs, 0)]
    if not bool(hit.any()):
        return
    keys = rows[:, K0:K1]
    t.quarantined.update(keys[hit].long().tolist())
    keep = valid & ~hit
    kept = keep.sum(1)
    # kept slot j of a row moves to position (kept slots before j)
    dest = torch.cumsum(keep.long(), 1) - 1
    new_k = torch.where(valid, 0, keys)
    new_p = torch.where(valid, 0, rows[:, P0:P0 + MAX_KEYS])
    r, j = torch.nonzero(keep, as_tuple=True)
    new_k[r, dest[r, j]] = keys[r, j]
    new_p[r, dest[r, j]] = rows[r, P0 + j]
    rows[:, K0:K1] = new_k
    rows[:, P0:P0 + MAX_KEYS] = new_p
    rows[:, C_NK] = kept.to(torch.int32)
    t.nodes.vol[leaves] = rows
