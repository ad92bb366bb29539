"""repro_torch paged regions and the block cache (DESIGN.md §12), on the CPU
against the JAX package's reference.

Every test of ``tests/test_paged.py`` runs through both packages with the
same seeded operations, and the port must give the reference's results
exactly: byte-identical backing files (shards and manifest too), equal
``FlushStats``, every ``BlockCache`` counter (``faults``, ``hits``,
``evictions``, ``spills``, ``over_budget``, ``resident_bytes``,
``peak_resident_bytes``) after each step, and the same recovered state.
Also: the paged cells of ``tests/test_integrity.py`` (scrub over its
GRID, the verifying fault path in both commit modes, a fault in a row the
authoritative bank remaps), the paged allocator and the engine with
``paged=True``, a hypothesis test of random DLL traces on tiny caches with
crashes and ``drop_clean`` at random points, the translated-index gather
from a block pool, and ``repro_torch.paged_arena`` against
``examples/paged_arena.py``.

The reference's sharded drains run the shards in a thread pool whose
interleaving would make the LRU's order, and so its evictions, a race;
the reference arenas here get a serial pool (same bytes, fixed order).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import test_torch_integrity as TI
from repro.core import arena as RA
from repro.core import paging as RP
from repro.core import recovery as RR
from repro.pstruct import dll as RD
from repro.serve.kvcache import PagedAllocator as RPA
from repro.serve.kvcache import PagedConfig as RPC
from repro_torch.core import arena as TA
from repro_torch.core import paging as TP
from repro_torch.core import recovery as TR
from repro_torch.core.writeset import WriteSet, gather_rows
from repro_torch.pstruct import dll as TD
from repro_torch.serve.kvcache import PagedAllocator as TPA
from repro_torch.serve.kvcache import PagedConfig as TPC

PKG = {"ref": (RA, RP, RR, RD), "port": (TA, TP, TR, TD)}
MODES = ("barrier", "shadow")
COUNTERS = ("faults", "hits", "evictions", "spills", "over_budget",
            "resident_bytes", "peak_resident_bytes")
ROOT = Path(__file__).resolve().parents[1]


class _SerialPool:
    @staticmethod
    def map(fn, items):
        return map(fn, items)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("REPRO_PAGED", raising=False)
    monkeypatch.delenv("REPRO_INTEGRITY", raising=False)
    monkeypatch.setattr(RA.ShardedArena, "pool", lambda self: _SerialPool)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kw(cache_blocks=4, block_bytes=512):
    return dict(paged=True, block_bytes=block_bytes,
                cache_blocks=cache_blocks)


def _open(pkg, path, layout, **kw):
    if pkg == "port":
        kw["device"] = "cpu"
    return PKG[pkg][0].open_arena(path, layout, **kw)


def _counters(a):
    c = a.cache
    return None if c is None else {k: int(getattr(c, k)) for k in COUNTERS}


def _state(a):
    """What every step compares: FlushStats and the cache's counters."""
    return dataclasses.asdict(a.stats), _counters(a)


def _files(root: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())
            if not p.name.endswith(".layout")}


def _both(fn):
    """``fn(pkg)`` for both packages; asserts the results are equal."""
    out = {pkg: fn(pkg) for pkg in PKG}
    assert out["port"] == out["ref"]
    return out["port"]


# --------------------------------------------------- region selection

def test_eligibility_and_roundtrip():
    layout = {"r": (np.int64, (64, 8)), "r.header": (np.int64, (1, 8)),
              "r.snapring": (np.int64, (64, 8)),
              "jr.jrnl": (np.int64, (64, 8)), "tiny": (np.int64, (4, 8))}
    data = np.arange(64 * 8, dtype=np.int64).reshape(64, 8)

    def run(pkg):
        a = _open(pkg, None, layout, **_kw())
        r = a.regions["r"]
        assert isinstance(r, PKG[pkg][1].PagedRegion) and r.is_paged
        paged = {n: bool(getattr(x, "is_paged", False))
                 for n, x in a.regions.items()}
        r.write_rows(np.arange(64), data)
        out = [paged, _host(r.read_rows(np.arange(64))).tolist(),
               r.read_one(13, 5),
               _host(r.read_at(np.array([3, 60]), 2)).tolist(),
               _host(r.read_col(1)).tolist(), r.total_blocks, _state(a)]
        assert a.cache.faults == r.total_blocks and a.cache.hits > 0
        return out

    got = _both(run)
    # sidecars (integrity on by default) stay resident too
    assert not any(v for n, v in got[0].items() if n.endswith(".integ"))
    assert {n: v for n, v in got[0].items() if not n.endswith(".integ")} \
        == {"r": True, "r.header": False, "r.snapring": False,
            "jr.jrnl": False, "tiny": False}
    assert got[1] == data.tolist() and got[2] == data[13, 5]


def test_scattered_reads_cross_blocks():
    data = np.random.default_rng(0).integers(0, 99, (200, 8))

    def run(pkg):
        a = _open(pkg, None, {"r": (np.int64, (200, 8))}, **_kw(64))
        r = a.regions["r"]
        r.write_rows(np.arange(200), data)
        rng = np.random.default_rng(1)
        out = []
        for _ in range(5):
            rows = rng.integers(0, 200, 37)
            got = _host(r.read_rows(rows))
            np.testing.assert_array_equal(got, data[rows])
            at = _host(r.read_at(rows, slice(2, 5)))
            np.testing.assert_array_equal(at, data[rows, 2:5])
            out.append(_state(a))
        assert tuple(r.read_rows(np.empty(0, np.int64)).shape) == (0, 8)
        return out

    _both(run)


# ------------------------------------------------- pinning & eviction

def test_dirty_blocks_pinned_until_flush():
    def run(pkg):
        a = _open(pkg, None, {"r": (np.int64, (64, 8))},
                  **_kw(cache_blocks=1))
        r, cache, out = a.regions["r"], a.cache, []
        r.write_rows(np.array([0]), np.arange(8))    # block 0 dirty
        r.write_rows(np.array([8]), np.arange(8))    # block 1 dirty
        assert cache.over_budget >= 1
        assert cache.resident_bytes > cache.capacity_bytes
        assert r._block_pinned(0) and r._block_pinned(1)
        out.append(_state(a))
        with a.epoch():
            r.mark_rows(np.array([0, 8]))
        assert not r._block_pinned(0) and not r._block_pinned(1)
        out.append((cache.drop_clean(), _state(a)))
        assert cache.resident_bytes == 0
        got = _host(r.read_rows(np.array([0, 8])))
        np.testing.assert_array_equal(got, np.broadcast_to(np.arange(8),
                                                           (2, 8)))
        out.append(_state(a))
        return out

    assert _both(run)[1][0] == 2


def test_clean_blocks_evict_at_budget():
    data = np.random.default_rng(2).integers(0, 99, (64, 8))

    def run(pkg):
        a = _open(pkg, None, {"r": (np.int64, (64, 8))},
                  **_kw(cache_blocks=2))
        r = a.regions["r"]
        r.write_rows(np.arange(64), data)
        with a.epoch():
            r.mark_rows(np.arange(64))
        a.commit()
        a.cache.drop_clean()
        base, over0 = a.cache.evictions, a.cache.over_budget
        out = [_state(a)]
        for bid in range(r.total_blocks):            # sequential sweep
            r.read_one(bid * r._block_rows, 0)
            out.append(_counters(a))
        assert a.cache.evictions > base
        assert a.cache.resident_bytes <= a.cache.capacity_bytes
        assert a.cache.over_budget == over0
        np.testing.assert_array_equal(_host(r.read_rows(np.arange(64))),
                                      data)
        out.append(_state(a))
        return out

    _both(run)


# ------------------------------------------------------ crash contract

def test_crashed_region_reads_zeros_until_reopen(tmp_path):
    data = np.random.default_rng(3).integers(1, 99, (64, 8))

    def run(pkg):
        root = tmp_path / pkg
        root.mkdir()
        a = _open(pkg, str(root / "a"), {"r": (np.int64, (64, 8))},
                  **_kw())
        r = a.regions["r"]
        r.write_rows(np.arange(64), data)
        with a.epoch():
            r.mark_rows(np.arange(64))
        a.commit()
        a.crash()
        assert (_host(r.read_rows(np.arange(64))) == 0).all()
        out = [_state(a)]
        assert (_host(r.vol) == 0).all()           # the spill reads zeros
        out.append(_state(a))
        a.reopen()
        np.testing.assert_array_equal(_host(r.read_rows(np.arange(64))),
                                      data)
        out.append(_state(a))
        a.close()
        return out, _files(root)

    _both(run)


# ------------------------------------------------------ spill fallback

def test_spill_fallback_roundtrip(tmp_path):
    data = np.random.default_rng(4).integers(0, 99, (64, 8))

    def run(pkg):
        root = tmp_path / pkg
        root.mkdir()
        a = _open(pkg, str(root / "a"), {"r": (np.int64, (64, 8))},
                  **_kw())
        r = a.regions["r"]
        r.write_rows(np.arange(32), data[:32])      # dirty resident rows
        full = r.vol                                # full-array consumer
        assert a.cache.spills == 1 and not r.paged_active
        np.testing.assert_array_equal(_host(full)[:32], data[:32])
        out = [_state(a)]
        if pkg == "port":
            r.vol[32:] = torch.from_numpy(data[32:])
        else:
            r.vol[32:] = data[32:]
        with a.epoch():
            r.mark_rows(np.arange(64))
        a.commit()
        a.crash()
        a.reopen()                                  # load() re-enters
        assert r.paged_active
        np.testing.assert_array_equal(_host(r.read_rows(np.arange(64))),
                                      data)
        out.append(_state(a))
        a.close()
        return out, _files(root)

    _both(run)


# ------------------------------- paged/unpaged parity & byte identity

def _dll_trace(a, d, n_epochs, crash_tail=False, steps=None):
    """The reference test's deterministic append/delete trace, one commit
    per epoch; ``steps`` collects the state after each commit."""
    rng = np.random.default_rng(7)
    live = []
    for e in range(n_epochs):
        ids = _host(d.append_batch(rng.integers(0, 99, (7, 7))))
        live.extend(int(i) for i in ids)
        if e % 2 and len(live) > 6:
            dead = [live.pop(0) for _ in range(3)]
            d.delete_batch(np.asarray(dead, np.int64))
        a.commit()
        if steps is not None:
            steps.append(_state(a))
    if crash_tail:
        d.append_batch(rng.integers(0, 99, (3, 7)))


def _dll_fingerprint(d):
    order = _host(d.to_list())
    return order.tolist(), _host(d.data_rows(order)).tolist()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_shards", [1, 3])
def test_persistent_files_bit_identical_paged_vs_unpaged(
        tmp_path, mode, n_shards):
    """Paging is volatile-only: the same trace lands the same bytes in
    every backing file (shards and manifest), in both packages, and the
    paged state after every commit is the reference's."""
    blobs = {}
    for pkg in PKG:
        D = PKG[pkg][3]
        for paged in (False, True):
            root = tmp_path / f"{pkg}{int(paged)}"
            root.mkdir()
            a = _open(pkg, str(root / "a"), D.DoublyLinkedList.layout(
                256, "partly"), n_shards=n_shards, commit_mode=mode,
                **(_kw() if paged else {"paged": False}))
            d = D.DoublyLinkedList(a, 256, "partly")
            steps = []
            _dll_trace(a, d, 6, steps=steps)
            a.close()
            blobs[pkg, paged] = (_files(root), steps)
    for paged in (False, True):
        assert blobs["port", paged] == blobs["ref", paged]
    assert blobs["port", True][0] == blobs["port", False][0]
    assert blobs["port", True][1][-1][1]["faults"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_shards", [1, 3])
def test_evict_then_crash_sweep_every_epoch_boundary(tmp_path, mode,
                                                     n_shards):
    """At every epoch boundary: commit, drop every clean block, run an
    uncommitted tail, crash, recover.  Both packages reconstruct the
    boundary's state as an unpaged arena does, with equal counters."""
    for k in range(1, 6):
        fps = {}
        for pkg in PKG:
            D = PKG[pkg][3]
            for paged in (False, True):
                ap = str(tmp_path / f"{pkg}.{mode}.{k}.{int(paged)}")
                a = _open(pkg, ap, D.DoublyLinkedList.layout(96, "partly"),
                          commit_mode=mode, n_shards=n_shards,
                          **(_kw(cache_blocks=3) if paged
                             else {"paged": False}))
                d = D.DoublyLinkedList(a, 96, "partly")
                _dll_trace(a, d, k, crash_tail=True)
                dropped = a.cache.drop_clean() if paged else None
                if paged:
                    assert dropped > 0
                pre = _state(a)
                a.crash()
                a.reopen()
                d.reconstruct()
                fps[pkg, paged] = (_dll_fingerprint(d), dropped, pre,
                                   _state(a))
        for paged in (False, True):
            assert fps["port", paged] == fps["ref", paged], (k, paged)
        assert fps["port", True][0] == fps["port", False][0]


@pytest.mark.parametrize("mode", MODES)
def test_organic_eviction_crash_recovery(tmp_path, mode):
    """A cache far smaller than the working set evicts throughout the
    trace; recovery is exact in both packages, with equal counters."""
    def run(pkg):
        D = PKG[pkg][3]
        a = _open(pkg, str(tmp_path / f"{pkg}.a"),
                  D.DoublyLinkedList.layout(96, "partly"), commit_mode=mode,
                  **_kw(cache_blocks=2))
        d = D.DoublyLinkedList(a, 96, "partly")
        steps = []
        _dll_trace(a, d, 8, crash_tail=True, steps=steps)
        assert a.cache.evictions > 0, "cache never evicted"
        a.crash()
        a.reopen()
        d.reconstruct()
        return _dll_fingerprint(d), steps, _state(a)

    got = _both(run)
    D = TD
    a2 = _open("port", str(tmp_path / "b"),
               D.DoublyLinkedList.layout(96, "partly"), commit_mode=mode,
               paged=False)
    d2 = D.DoublyLinkedList(a2, 96, "partly")
    _dll_trace(a2, d2, 8, crash_tail=True)
    a2.crash()
    a2.reopen()
    d2.reconstruct()
    assert _dll_fingerprint(d2) == got[0]


# ----------------------------------------------------- sharded paging

@pytest.mark.parametrize("router", [("seg", 8), ("hash",), ("range",)])
def test_sharded_paged_roundtrip(router):
    data = np.random.default_rng(5).integers(0, 99, (103, 8))

    def run(pkg):
        a = _open(pkg, None, {"r": (np.int64, (103, 8), router),
                              "r.header": (np.int64, (1, 8))},
                  n_shards=3, **_kw())
        r = a.regions["r"]
        assert isinstance(r, PKG[pkg][1].PagedShardedRegion)
        assert not any(sh.paged for sh in a.shards)
        r.write_rows(np.arange(103), data)
        a.regions["r.header"].vol[0, 0] = 42
        with a.epoch():
            r.mark_rows(np.arange(103))
            a.regions["r.header"].mark_rows(np.array([0]))
        a.commit()
        out = [_state(a)]
        a.crash()
        assert (_host(r.read_rows(np.arange(103))) == 0).all()
        out.append(_state(a))
        a.reopen()
        np.testing.assert_array_equal(_host(r.read_rows(np.arange(103))),
                                      data)
        assert int(a.regions["r.header"].vol[0, 0]) == 42
        out.append(_state(a))
        return out, TI._image(a)

    _both(run)


# ------------------------------------------------- recovery reporting

def test_recovery_report_carries_block_faults(tmp_path):
    def run(pkg):
        A, _, R, D = PKG[pkg]
        a = _open(pkg, str(tmp_path / pkg),
                  D.DoublyLinkedList.layout(96, "partly"), **_kw())
        d = D.DoublyLinkedList(a, 96, "partly")
        _dll_trace(a, d, 4)
        a.crash()
        rep = R.RecoveryManager(a).add("dll", "pstruct.dll", d).recover()
        st = {s.name: s.detail for s in rep.stages}
        assert st["dll"]["block_faults"] > 0
        assert a.cache.faults >= st["dll"]["block_faults"]
        return TI._report(rep), _state(a), _dll_fingerprint(d)

    _both(run)


def test_cache_counters_consistent():
    for P in (RP, TP):
        c = P.BlockCache(block_bytes=512, cache_blocks=2)
        assert c.capacity_bytes == 1024
        c.reset_peak()
        assert c.peak_resident_bytes == c.resident_bytes == 0


# ---------------------------------------------------------- integrity

@pytest.mark.parametrize("commit_mode,n_shards", [
    ("barrier", 1), ("barrier", 4), ("shadow", 1), ("shadow", 4)])
def test_scrub_detects_flip_and_stuck_line_paged(tmp_path, commit_mode,
                                                 n_shards):
    """``tests/test_integrity.py``'s ``paged=True`` cells: scrub reads the
    persistent bytes, never the pool, and names the same rows in both
    packages; the images and the cache's counters agree."""
    kw = dict(commit_mode=commit_mode, n_shards=n_shards, paged=True,
              block_bytes=256, cache_blocks=8)
    out = {}
    for pkg in TI.PKG:
        a, d, t, h = TI._mixed(pkg, str(tmp_path / f"{pkg}.pm"), **kw)
        TI._run(a, d, t, h, TI._script(12, seed=1))
        row = int(_host(d.order())[2])
        a.crash()
        F = TI.PKG[pkg][1]
        off = F.flip_bits(a, a.regions["dll.nodes"], row, byte=8, mask=0x01)
        a.reopen()
        first = TI._scrub(a)
        assert list(first) == ["dll.nodes"] and row in first["dll.nodes"]
        F.flip_bits(a, a.regions["dll.nodes"], row, byte=8, mask=0x01)
        assert TI._scrub(a) == {}
        F.stuck_line(a, a.regions["hm.entries"], 2, line=0, value=0xAB)
        second = TI._scrub(a)
        assert list(second) == ["hm.entries"] and 2 in second["hm.entries"]
        with pytest.raises(TI.PKG[pkg][0].CorruptLineError) as ei:
            a.scrub(raise_on_error=True)
        out[pkg] = (row, off, first, second, str(ei.value), TI._image(a),
                    TI._stats(a), _counters(a))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("commit_mode", MODES)
def test_paged_fault_path_verifies_blocks(tmp_path, commit_mode):
    """A demand fault that assembles the corrupt row's block refuses to
    admit it: ``CorruptLineError`` naming the row, in both packages."""
    out = {}
    for pkg in TI.PKG:
        a, d, t, h = TI._mixed(pkg, str(tmp_path / f"{pkg}.pm"),
                               commit_mode=commit_mode, n_shards=1,
                               paged=True, block_bytes=256, cache_blocks=4)
        TI._run(a, d, t, h, TI._script(12, seed=2))
        row = int(_host(d.order())[1])
        a.crash()
        TI.PKG[pkg][1].flip_bits(a, a.regions["dll.nodes"], row, byte=8,
                                 mask=0x04)
        a.reopen()
        before = _counters(a)
        with pytest.raises(TI.PKG[pkg][0].CorruptLineError) as ei:
            a.regions["dll.nodes"].read_rows(np.array([row], np.int64))
        assert ei.value.region == "dll.nodes"
        assert row in np.asarray(ei.value.rows).tolist()
        out[pkg] = (str(ei.value), before, _counters(a))
    assert out["port"] == out["ref"]
    # rejected before admission: the fault added no block
    assert out["port"][2]["faults"] == out["port"][1]["faults"]


def test_remapped_fault_refuses_block_paged(tmp_path):
    """The paged half of the shadow fault check: a flip on a DLL row the
    authoritative bank remaps makes the demand fault of its block raise,
    in both packages, naming the row."""
    import test_torch_shadow as TS
    out = {}
    for pkg in TI.PKG:
        a, d, t, h = TI._mixed(pkg, str(tmp_path / pkg),
                               commit_mode="shadow", paged=True,
                               block_bytes=256, cache_blocks=4)
        TI._run(a, d, t, h, TI._script(12, seed=1))
        TS._rewrite_all(a, d, t, h)
        row = TS._remapped(a, "dll.nodes")
        a.crash()
        TI.PKG[pkg][1].flip_bits(a, a.regions["dll.nodes"], row, byte=8,
                                 mask=0x04)
        a.reopen()
        with pytest.raises(TI.PKG[pkg][0].CorruptLineError) as ei:
            a.regions["dll.nodes"].read_rows(np.array([row], np.int64))
        assert row in np.asarray(ei.value.rows).tolist()
        out[pkg] = (row, str(ei.value), _counters(a))
    assert out["port"] == out["ref"]


# -------------------------------------------- the allocator and the engine

def _alloc_fp(pa):
    return (_host(pa.lru.order()).tolist(), pa.owner.tolist(),
            sorted(pa.pages_free.tolist()))


@pytest.mark.parametrize("commit_mode", MODES)
@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("mode", ["partly", "full"])
def test_paged_allocator_matches_reference(tmp_path, commit_mode, n_shards,
                                           mode):
    """The paged-KV allocator on a paged arena: the files, FlushStats,
    counters and the recovery report (``block_faults`` per stage) are the
    reference's; the recovered allocator equals the pre-crash one."""
    def run(pkg):
        PA, PC = (TPA, TPC) if pkg == "port" else (RPA, RPC)
        cfg = PC(n_pages=256, page_tokens=4, mode=mode, n_shards=n_shards,
                 commit_mode=commit_mode, paged=True, block_bytes=512,
                 cache_blocks=4)
        root = tmp_path / pkg
        root.mkdir()
        kw = {"device": "cpu"} if pkg == "port" else {}
        pa = PA(cfg, path=str(root / "pg"), **kw)
        steps = []
        for rid in range(8):
            pa.alloc(rid, 11 + rid)
            steps.append(_state(pa.arena))
        for rid in (1, 4, 6):
            pa.free_request(rid)
            steps.append(_state(pa.arena))
        pa.alloc(9, 40)
        fp0 = _alloc_fp(pa)
        pa.arena.crash()
        pa.arena.cache.reset_peak()
        pa.recover()
        assert _alloc_fp(pa) == fp0
        rep = TI._report(pa.last_recovery)
        pa.alloc(10, 5)
        steps.append(_state(pa.arena))
        pa.arena.close()
        return steps, rep, _alloc_fp(pa), _files(root)

    got = _both(run)
    assert got[1]["stages"][1][0] == "lru"
    assert "block_faults" in got[1]["stages"][1][3]


def test_paged_allocator_recovery_report(tmp_path):
    """``tests/test_recovery.py``'s allocator report, on a paged arena."""
    def run(pkg):
        PA, PC = (TPA, TPC) if pkg == "port" else (RPA, RPC)
        kw = {"device": "cpu"} if pkg == "port" else {}
        pa = PA(PC(n_pages=64, page_tokens=4, paged=True, block_bytes=256,
                   cache_blocks=2), path=str(tmp_path / f"{pkg}.pg"), **kw)
        pa.alloc(1, 5)
        pa.arena.commit()
        pa.arena.crash()
        assert pa.recover() >= 0
        rep = pa.last_recovery
        assert [s.name for s in rep.stages] == ["reopen", "lru", "pages"]
        assert rep.stage("pages").detail["pages_live"] == 5
        assert rep.stage("pages").detail["pages_free"] == 59
        return TI._report(rep), _state(pa.arena)

    _both(run)


# ------------------------------------------------------------ hypothesis

@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2 ** 16), cache_blocks=st.integers(2, 6),
       block_bytes=st.sampled_from([256, 512]),
       n_shards=st.sampled_from([1, 3]),
       mode=st.sampled_from(["partly", "full"]),
       commit_mode=st.sampled_from(MODES),
       ops=st.lists(st.sampled_from(["append", "delete", "pop", "commit",
                                     "crash", "drop"]),
                    min_size=4, max_size=14))
def test_random_dll_traces_on_tiny_caches(seed, cache_blocks, block_bytes,
                                          n_shards, mode, commit_mode, ops):
    """Random DLL traces on tiny caches, crashes and ``drop_clean`` at
    random points: images, FlushStats, every counter after each op and
    the recovered order are the reference's."""
    def run(pkg):
        D = PKG[pkg][3]
        a = _open(pkg, None, D.DoublyLinkedList.layout(128, mode),
                  n_shards=n_shards, commit_mode=commit_mode,
                  **_kw(cache_blocks, block_bytes))
        d = D.DoublyLinkedList(a, 128, mode)
        rng = np.random.default_rng(seed)
        out, live = [], []
        for op in ops:
            if op == "append" and len(live) < 100:
                m = int(rng.integers(1, 9))
                ids = _host(d.append_batch(rng.integers(0, 99, (m, 7))))
                live.extend(int(i) for i in ids)
            elif op == "delete" and live:
                k = int(rng.integers(1, min(6, len(live)) + 1))
                pick = sorted(rng.choice(len(live), k, replace=False),
                              reverse=True)
                d.delete_batch(np.asarray([live.pop(i) for i in pick],
                                          np.int64))
            elif op == "pop" and live:
                m = int(rng.integers(1, min(4, len(live)) + 1))
                gone = set(_host(d.pop_front_batch(m)).tolist())
                live = [x for x in live if x not in gone]
            elif op == "commit":
                a.commit()
            elif op == "drop":
                out.append(a.cache.drop_clean())
            elif op == "crash":
                a.crash()
                a.reopen()
                d.reconstruct()
                live = _host(d.order()).tolist()
            out.append(_state(a))
        a.commit()
        a.crash()
        a.reopen()
        d.reconstruct()
        out.append((_state(a), _dll_fingerprint(d)))
        return out, TI._image(a)

    _both(run)


# ------------------------------------------------- the pool's gathers

@pytest.mark.parametrize("n_shards", [1, 3])
def test_translated_gather_from_pool_equals_resident(n_shards):
    """A drain's grouped gather and ``gather_rows`` over a block pool, by
    translated index, give the rows a resident region's gather gives."""
    data = np.random.default_rng(9).integers(-99, 99, (300, 8))
    rows = np.unique(np.random.default_rng(10).integers(0, 300, 90))
    got = {}
    for paged in (False, True):
        a = _open("port", None, {"r": (np.int64, (300, 8), ("seg", 8)),
                                 "s": (np.int64, (40, 8))},
                  n_shards=n_shards, integrity=False,
                  **(_kw(cache_blocks=3) if paged else {"paged": False}))
        r, s = a.regions["r"], a.regions["s"]
        r.write_rows(np.arange(300), data)
        s.write_rows(np.arange(40), data[:40])
        staged = a.writeset.gather([(r, rows), (s, rows[rows < 40])])
        got[paged] = ([x.copy() for x in staged], gather_rows(r, rows))
        assert r.is_paged == paged and (not paged or r.paged_active)
    for x, y in zip(got[False][0], got[True][0]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got[True][1], data[rows])
    assert WriteSet.gathers > 0


def test_pool_stays_within_twice_the_budget():
    """A whole-column read of a region many times the budget goes in
    chunks: the pool never grows past twice the cache's blocks."""
    a = _open("port", None, {"r": (np.int64, (4096, 8))}, integrity=False,
              **_kw(cache_blocks=5, block_bytes=512))
    r = a.regions["r"]
    col = r.read_col(7)
    assert tuple(col.shape) == (4096,)
    assert a.cache.peak_pool_bytes <= 2 * a.cache.capacity_bytes
    assert a.cache.evictions > 0 and a.cache.faults == r.total_blocks


# ---------------------------------------------- the command-line module

def test_paged_arena_module_matches_example():
    """``python -m repro_torch.paged_arena --device cpu`` prints the pool,
    the per-stage block faults and the totals of the reference example."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    outs = {}
    for name, cmd in (("ref", [sys.executable, "examples/paged_arena.py"]),
                      ("port", [sys.executable, "-m",
                                "repro_torch.paged_arena", "--device",
                                "cpu"])):
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
        outs[name] = [_strip_ms(ln) for ln in res.stdout.splitlines()]
    assert outs["port"] == outs["ref"]
    assert any("blocks faulted" in ln for ln in outs["port"])


def _strip_ms(line: str) -> str:
    """A printed line without its timings (``12.3 ms`` and ``in 4.5 ms``)."""
    words = line.split()
    keep = [w for i, w in enumerate(words)
            if not (i + 1 < len(words) and words[i + 1].startswith("ms"))
            and not w.startswith("ms")]
    return " ".join(keep)
