"""repro_torch structures vs the reference, in both modes.

The same seeded operations run in both packages (both pinned to
``integrity=False``, ``snapshot=False``; the port on CPU tensors):

* after every commit: byte-identical persistent images, equal FlushStats;
* after crash + reconstruct, and after a torn epoch (``flush(
  include_meta=False)``): equal volatile redundancy and equal finds;
* an arena written by either package recovers in the other.

Integer state throughout, compared exactly (tolerance 0)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.arena import open_arena as ref_open
from repro.pstruct import bptree as RB, dll as RD, hashmap as RH
from repro_torch.core.arena import open_arena as port_open
from repro_torch.interop import arena_from_image, image_of
from repro_torch.pstruct import bptree as TB, dll as TD, hashmap as TH

MODES = ("partly", "full")
CAP = {"dll": 300, "hashmap": 400, "bptree": (256, 1024)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _layout(pkg, kind, mode):
    if kind == "dll":
        return (RD if pkg == "ref" else TD).DoublyLinkedList.layout(
            CAP[kind], mode, snapshot=False)
    if kind == "hashmap":
        return (RH if pkg == "ref" else TH).Hashmap.layout(
            CAP[kind], mode, snapshot=False)
    return (RB if pkg == "ref" else TB).BPTree.layout(*CAP[kind], mode)


def _struct(pkg, kind, mode, a):
    if kind == "dll":
        return (RD if pkg == "ref" else TD).DoublyLinkedList(
            a, CAP[kind], mode, snapshot=False)
    if kind == "hashmap":
        return (RH if pkg == "ref" else TH).Hashmap(
            a, CAP[kind], mode, snapshot=False)
    return (RB if pkg == "ref" else TB).BPTree(a, *CAP[kind], mode)


def _make(pkg, kind, mode, path=None):
    if pkg == "ref":
        a = ref_open(path, _layout(pkg, kind, mode), integrity=False)
    else:
        a = port_open(path, _layout(pkg, kind, mode), device="cpu",
                      integrity=False)
    return a, _struct(pkg, kind, mode, a)


def _volatile(kind, s):
    """Every piece of volatile state the reconstructor rebuilds."""
    if kind == "dll":
        return {"prev": _np(s.prev), "order": _np(s.order()),
                "to_list": _np(s.to_list()), "free": list(s._free),
                "header": _np(s.header.vol), "nodes": _np(s.nodes.vol)}
    if kind == "hashmap":
        return {"buckets": _np(s.buckets), "chain": _np(s.chain),
                "hashes": _np(s.hashes).view(np.int64),
                "n_buckets": s.n_buckets, "header": _np(s.header.vol),
                "entries": _np(s.entries.vol)}
    return {"nodes": _np(s.nodes.vol), "records": _np(s.records.vol),
            "leaf_prev": _np(s.leaf_prev), "free_nodes": list(s._free_nodes),
            "free_recs": list(s._free_recs), "header": _np(s.header.vol),
            "leaves": _np(s.leaves())}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


class _Ops:
    """One seeded operation stream for a structure; called identically on
    both packages, so equal states draw equal operations."""

    def __init__(self, kind, seed):
        self.kind = kind
        self.rng = np.random.default_rng(seed)
        self.keys = {}          # hashmap / bptree: live key -> value row

    def step(self, s, i):
        rng = self.rng
        if self.kind == "dll":
            s.append_batch(rng.integers(0, 1 << 40, (rng.integers(1, 30), 7)))
            if i % 2:
                s.pop_front_batch(int(rng.integers(1, 12)))
            live = _np(s.order())
            if live.size > 4:
                s.delete_batch(rng.choice(live, int(rng.integers(1, 8)),
                                          replace=False))
            return
        universe = 600 if self.kind == "hashmap" else 2000
        m = int(rng.integers(5, 60))
        ks = rng.integers(0, universe, m).astype(np.int64)   # dups + updates
        vs = rng.integers(0, 1 << 40, (m, 7)).astype(np.int64)
        s.insert_batch(ks, vs)
        for k, v in zip(ks.tolist(), vs):
            self.keys[k] = v
        if i % 2:
            gone = rng.integers(0, universe, int(rng.integers(3, 25)))
            (s.remove_batch if self.kind == "hashmap" else s.delete_batch)(
                gone.astype(np.int64))
            for k in gone.tolist():
                self.keys.pop(k, None)

    def check_finds(self, s):
        if self.kind == "dll":
            return
        ks = np.fromiter(self.keys, np.int64, len(self.keys))
        probe = np.concatenate([ks, np.arange(3000, 3010)])
        ok, vals = s.find_batch(probe)
        ok, vals = _np(ok), _np(vals)
        assert ok[:ks.size].all() and not ok[ks.size:].any()
        if ks.size:
            np.testing.assert_array_equal(
                vals[:ks.size], np.stack([self.keys[k] for k in ks.tolist()]))


def _run(kind, mode, steps):
    """Drive both packages through the same stream; compare at every
    commit, after a crash + reconstruct, and after more ops (free-list
    reuse)."""
    sides = {}
    for pkg in ("ref", "port"):
        a, s = _make(pkg, kind, mode)
        sides[pkg] = (a, s, _Ops(kind, 11))
    snaps = {"ref": [], "port": []}
    for phase in range(2):
        for i in range(steps):
            for pkg, (a, s, ops) in sides.items():
                ops.step(s, i)
                if i % 3 == 2:
                    a.commit()
                    snaps[pkg].append((np.array(a._mm),
                                       dataclasses.asdict(a.stats)))
        for pkg, (a, s, ops) in sides.items():
            a.commit()
            snaps[pkg].append((np.array(a._mm), dataclasses.asdict(a.stats)))
            a.crash()
            a.reopen()
            s.reconstruct()
            ops.check_finds(s)
        _assert_same(_volatile(kind, sides["ref"][1]),
                     _volatile(kind, sides["port"][1]))
    assert len(snaps["ref"]) == len(snaps["port"])
    for (ri, rs), (pi, ps) in zip(snaps["ref"], snaps["port"]):
        np.testing.assert_array_equal(pi, ri)
        assert ps == rs
    return sides


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["dll", "hashmap", "bptree"])
def test_structure_parity(kind, mode):
    _run(kind, mode, steps=9)


@pytest.mark.parametrize("mode", MODES)
def test_hashmap_growth_parity(mode):
    """Recovery derives a small bucket count from SIZE; later inserts grow
    it (full mode re-persists every chain pointer and the bucket array)."""
    rng = np.random.default_rng(12)
    keys = rng.choice(10 ** 6, 320, replace=False).astype(np.int64)
    vals = rng.integers(0, 1 << 40, (320, 7)).astype(np.int64)
    got = {}
    for pkg in ("ref", "port"):
        a, h = _make(pkg, "hashmap", mode)
        h.insert_batch(keys[:60], vals[:60])
        a.commit()
        a.crash()
        a.reopen()
        h.reconstruct()
        assert h.n_buckets == 128
        for i in range(60, 320, 50):
            h.insert_batch(keys[i:i + 50], vals[i:i + 50])
        assert h.n_buckets == 512                # grew twice
        h.remove_batch(keys[::7])
        a.commit()
        got[pkg] = (np.array(a._mm), dataclasses.asdict(a.stats),
                    _volatile("hashmap", h))
    np.testing.assert_array_equal(got["port"][0], got["ref"][0])
    assert got["port"][1] == got["ref"][1]
    _assert_same(got["ref"][2], got["port"][2])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["dll", "hashmap", "bptree"])
@pytest.mark.parametrize("torn", ["insert", "mixed"])
def test_torn_epoch_recovers_alike(kind, mode, torn):
    """A crash between the data and metadata halves of an epoch recovers
    the same state in both packages — or fails the same way: a torn
    epoch that rewired committed NEXT pointers can leave a chain shorter
    than the committed count, which both packages refuse with the same
    exception."""
    sides = _run(kind, mode, steps=4)
    outcome = {}
    for pkg, (a, s, ops) in sides.items():
        with a.epoch():
            if torn == "insert":
                rng = ops.rng
                vals = rng.integers(0, 1 << 40, (17, 7))
                if kind == "dll":
                    s.append_batch(vals)
                else:
                    s.insert_batch(rng.integers(0, 2000, 17), vals)
            else:
                ops.step(s, 1)
            a.writeset.flush(include_meta=False)
            a.crash()
        a.reopen()
        try:
            s.reconstruct()
            outcome[pkg] = "ok"
        except (RuntimeError, ValueError) as e:
            outcome[pkg] = type(e).__name__
    assert outcome["port"] == outcome["ref"]
    if torn == "insert":
        assert outcome["ref"] == "ok"
    if outcome["ref"] == "ok":
        _assert_same(_volatile(kind, sides["ref"][1]),
                     _volatile(kind, sides["port"][1]))
    np.testing.assert_array_equal(np.array(sides["ref"][0]._mm),
                                  image_of(sides["port"][0]))


def test_hashmap_hash_matches_reference():
    keys = np.random.default_rng(0).integers(-(1 << 63), (1 << 63) - 1,
                                             1000, dtype=np.int64)
    keys[:4] = [0, -1, 2 ** 62, -(2 ** 62)]
    np.testing.assert_array_equal(
        TH.hash64(torch.from_numpy(keys)).numpy(),
        RH.hash64(keys).view(np.int64))


@pytest.mark.parametrize("kind", ["dll", "hashmap", "bptree"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_recovery_through_arena_file(kind, writer, tmp_path):
    """An arena file written by one package is reopened and reconstructed
    by the other to the same logical state."""
    mode = "partly" if kind != "hashmap" else "full"
    path = str(tmp_path / "x.arena")
    a, s = _make(writer, kind, mode, path)
    ops = _Ops(kind, 5)
    for i in range(5):
        ops.step(s, i)
    a.commit()
    a.close()
    reader = "port" if writer == "ref" else "ref"
    states = {}
    for pkg in (writer, reader):
        a2, s2 = _make(pkg, kind, mode, path)
        a2.reopen()
        s2.reconstruct()
        ops.check_finds(s2)
        states[pkg] = _volatile(kind, s2)
    _assert_same(states["ref"], states["port"])


@pytest.mark.parametrize("kind", ["dll", "bptree"])
def test_cross_recovery_through_image(kind):
    """arena_from_image carries a reference in-memory arena into the port;
    image_of carries it back."""
    a, s = _make("ref", kind, "partly")
    ops = _Ops(kind, 6)
    for i in range(4):
        ops.step(s, i)
    a.commit()
    pa = arena_from_image(np.array(a._mm), a._meta, "cpu")
    ps = _struct("port", kind, "partly", pa)
    ps.reconstruct()
    a.crash()
    a.reopen()
    s.reconstruct()
    _assert_same(_volatile(kind, s), _volatile(kind, ps))
    np.testing.assert_array_equal(image_of(pa), np.array(a._mm))
    with pytest.raises(ValueError):
        arena_from_image(np.array(a._mm)[:-64], a._meta, "cpu")


def test_bptree_invariants_and_splits():
    a, t = _make("port", "bptree", "partly")
    keys = np.random.default_rng(8).permutation(900).astype(np.int64)
    vals = np.arange(900 * 7, dtype=np.int64).reshape(900, 7)
    for i in range(0, 900, 64):
        t.insert_batch(keys[i:i + 64], vals[i:i + 64])
    t.check_invariants()
    assert int(t.leaves().numel()) > 50          # many leaf splits
    a.commit()
    a.crash()
    a.reopen()
    t.reconstruct()
    t.check_invariants()
    ok, got = t.find_batch(keys)
    assert bool(ok.all()) and (_np(got) == vals).all()
