"""repro_torch sharded arenas (barrier commit, DESIGN.md §7) on the CPU,
against the JAX package's reference.

Each barrier cell of ``tests/test_sharded_arena.py`` runs through both
packages with the same operations: the per-shard images (``.s{k}`` files,
their ``.layout`` sidecars) and the manifest must be byte-identical,
``FlushStats`` equal (aggregate and per shard), and the recovered state
and recovery reports equal (timing fields aside).  Also: the routers
against the reference's, the layouts' router entries in every structure
and serving layout, ``persist_range`` / ``persist_all``, interop of
sharded arenas both ways, the engine's slot-per-shard token log and its
per-shard-group re-prefill, and the journal and the feature store at four
shards.  Integer state throughout, compared exactly.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arena as RA
from repro.core import recovery as RR
from repro.pstruct import bptree as RB
from repro.pstruct import dll as RD
from repro.pstruct import hashmap as RH
from repro.serve import journal as RJ
from repro_torch.core import arena as TA
from repro_torch.core import recovery as TR
from repro_torch.core import reconstruct as TC
from repro_torch.pstruct import bptree as TB
from repro_torch.pstruct import dll as TD
from repro_torch.pstruct import hashmap as TH
from repro_torch.serve import journal as TJ

PKG = {"ref": (RA, RR, RD, RB, RH), "port": (TA, TR, TD, TB, TH)}
TIMING = {"seconds", "t_start", "t_end", "ready_at", "queue_wait",
          "first_admission_s", "last_admission_s"}
ROUTERS = (("seg", 4), ("seg", 64), ("hash",), ("hash", 8), ("range",),
           ("shard", 2), None)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # integrity resolves on by default in both packages; paging stays off
    monkeypatch.delenv("REPRO_INTEGRITY", raising=False)
    monkeypatch.delenv("REPRO_PAGED", raising=False)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _open(pkg, path, layout, n_shards, **kw):
    if pkg == "port":
        kw["device"] = "cpu"
    return PKG[pkg][0].open_arena(path, layout, n_shards=n_shards, **kw)


def _image(a):
    """Every persistent byte of an arena: each shard's image and the
    manifest (a plain arena: its one image)."""
    if not hasattr(a, "shards"):
        return (bytes(np.asarray(a._mm)),)
    return tuple(bytes(np.asarray(sh._mm)) for sh in a.shards) + (
        bytes(np.asarray(a._man)),)


def _files(prefix):
    """The bytes of every file an arena at ``prefix`` wrote."""
    d, base = os.path.split(prefix)
    return {f[len(base):]: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.startswith(base)}


def _stats(a):
    shards = [dataclasses.asdict(s) for s in a.shard_stats()] \
        if hasattr(a, "shard_stats") else []
    return dataclasses.asdict(a.stats), shards


def _report(rep):
    return {"valid": rep.valid, "generation": rep.generation,
            "quarantined": list(rep.quarantined),
            "degraded": list(rep.degraded),
            "stages": [(s.name, s.quarantined, s.degraded,
                        {k: v for k, v in s.detail.items()
                         if k not in TIMING}) for s in rep.stages]}


# ---------------------------------------------------------- mixed arenas

def _mixed(pkg, n_shards, mode="partly", path=None, **kw):
    _, _, D, B, H = PKG[pkg]
    layout = {}
    layout.update(D.DoublyLinkedList.layout(256, mode, name="dll"))
    layout.update(B.BPTree.layout(256, 1024, mode, name="bt"))
    layout.update(H.Hashmap.layout(512, mode, name="hm"))
    a = _open(pkg, path, layout, n_shards, **kw)
    return (a, D.DoublyLinkedList(a, 256, mode, name="dll"),
            B.BPTree(a, 256, 1024, mode, name="bt"),
            H.Hashmap(a, 512, mode, name="hm"))


def _trace(a, d, t, h, n_ops=9, seed=7):
    rng = np.random.default_rng(seed)
    key = 0
    for i in range(n_ops):
        m = int(rng.integers(2, 7))
        vals = rng.integers(0, 1 << 30, (m, 7)).astype(np.int64)
        keys = np.arange(key, key + m, dtype=np.int64)
        key += m
        if i % 3 == 0:
            d.append_batch(vals)
        elif i % 3 == 1:
            t.insert_batch(keys, vals)
        else:
            h.insert_batch(keys, vals)
        a.commit()


def _recover(pkg, a, d, t, h, concurrency=1):
    mgr = PKG[pkg][1].RecoveryManager(a)
    mgr.add("dll", "pstruct.dll", d, regions=("dll.nodes", "dll.header"))
    mgr.add("bt", "pstruct.bptree", t,
            regions=("bt.nodes", "bt.records", "bt.header"))
    mgr.add("hm", "pstruct.hashmap", h,
            regions=("hm.entries", "hm.header"))
    return mgr.recover(concurrency=concurrency)


def _fingerprint(a, d, t, h):
    """The reference test's fingerprint: every region's volatile copy and
    the structures' volatile redundancy."""
    fp = {f"region:{nm}": _host(r.vol).tolist()
          for nm, r in a.regions.items()}
    fp["dll.prev"] = _host(d.prev).tolist()
    fp["dll.order"] = _host(d.order()).tolist()
    fp["dll.free"] = sorted(int(x) for x in d._free)
    fp["hm.n_buckets"] = int(h.n_buckets)
    fp["hm.buckets"] = _host(h.buckets).tolist()
    fp["hm.chain"] = _host(h.chain).tolist()
    fp["bt.leaf_prev"] = _host(t.leaf_prev).tolist()
    fp["bt.free_nodes"] = sorted(int(x) for x in t._free_nodes)
    return fp


# -------------------------------------------------------------- routers

@pytest.mark.parametrize("router", ROUTERS, ids=str)
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_router_partitions_rows_exactly(router, n_shards):
    shard_of = TA.route_rows(router, 103, n_shards)
    np.testing.assert_array_equal(shard_of,
                                  RA.route_rows(router, 103, n_shards))
    assert shard_of.shape == (103,)
    assert ((shard_of >= 0) & (shard_of < n_shards)).all()
    blk = TA.router_block(router)
    assert blk == RA.router_block(router)
    if blk:             # block routers are constant within each block
        for b in range(103 // blk):
            assert len(set(shard_of[b * blk:(b + 1) * blk])) == 1
    for n in (3, 8, 9, 103):
        assert TA.normalize_router(router, n, n_shards, 5) == \
            RA.normalize_router(router, n, n_shards, 5)


@pytest.mark.parametrize("router", ROUTERS, ids=str)
def test_roundtrip_epoch_commit_crash_reopen(router):
    out = {}
    data = np.random.default_rng(0).integers(0, 99, (103, 8))
    for pkg in PKG:
        a = _open(pkg, None, {"r": (np.int64, (103, 8), router),
                              "r.header": (np.int64, (1, 8))}, 3)
        r, hdr = a.regions["r"], a.regions["r.header"]
        r.write_rows(np.arange(103), data)
        hdr.write_at([0], 0, 42)
        with a.epoch():
            r.mark_rows(np.arange(103))
            hdr.mark_rows(np.array([0]))
        a.commit()
        a.crash()
        assert (_host(r.vol) == 0).all()
        a.reopen()
        np.testing.assert_array_equal(_host(r.vol), data)
        assert int(_host(hdr.vol)[0, 0]) == 42
        assert a.header_valid() and a.header_generation() == 1
        a.crash()
        a.reopen(concurrency=3)             # pooled reopen: the same
        np.testing.assert_array_equal(_host(r.vol), data)
        out[pkg] = (_image(a), _stats(a), r.shard_of.tolist())
    assert out["port"] == out["ref"]


def test_local_global_maps_are_bijective():
    layout = {"r": (np.int64, (257, 8), ("hash", 4))}
    r = _open("port", None, layout, 4).regions["r"]
    ref = _open("ref", None, layout, 4).regions["r"]
    np.testing.assert_array_equal(r.shard_of, ref.shard_of)
    np.testing.assert_array_equal(r.local_of, ref.local_of)
    seen = np.zeros(257, bool)
    for s, sl in enumerate(r.slices):
        if sl is None:
            assert ref.slices[s] is None
            continue
        np.testing.assert_array_equal(sl._gidx, ref.slices[s]._gidx)
        assert (r.shard_of[sl._gidx] == s).all()
        assert (r.local_of[sl._gidx] == np.arange(sl._gidx.size)).all()
        assert not seen[sl._gidx].any()
        seen[sl._gidx] = True
    assert seen.all()


# ------------------------------------------------------------ accounting

def test_aggregate_accounting_matches_single_arena():
    """Sharding changes where bytes land, never how many lines the medium
    is charged: the same B+Tree trace at 1 and 4 shards, both packages."""
    stats = {}
    for pkg in PKG:
        B = PKG[pkg][3]
        for ns in (1, 4):
            rng = np.random.default_rng(11)
            a = _open(pkg, None, B.BPTree.layout(256, 1024), ns)
            t = B.BPTree(a, 256, 1024)
            keys = rng.permutation(500).astype(np.int64)
            vals = rng.integers(0, 1 << 30, (500, 7)).astype(np.int64)
            for i in range(0, 500, 97):
                t.insert_batch(keys[i:i + 97], vals[i:i + 97])
            t.delete_batch(keys[:100])
            a.commit()
            s = a.stats
            stats[pkg, ns] = ((s.lines, s.bytes, s.saved_lines,
                               s.dedup_rows, s.epochs), _stats(a),
                              _image(a))
    assert stats["port", 1][0] == stats["port", 4][0]
    assert stats["port", 1] == stats["ref", 1]
    assert stats["port", 4] == stats["ref", 4]


def test_per_shard_stats_sum_to_aggregate():
    out = {}
    for pkg in PKG:
        D = PKG[pkg][2]
        rng = np.random.default_rng(3)
        a = _open(pkg, None, D.DoublyLinkedList.layout(256), 3)
        d = D.DoublyLinkedList(a, 256)
        # 200 rows = 4 segment blocks of 64 -> shards 0, 1, 2, 0
        d.append_batch(rng.integers(0, 9, (200, 7)))
        a.commit()
        agg, per = a.stats, a.shard_stats()
        assert agg.lines == sum(s.lines for s in per)
        assert agg.bytes == sum(s.bytes for s in per)
        assert all(s.lines > 0 for s in per)
        out[pkg] = (_stats(a), _image(a))
    assert out["port"] == out["ref"]


# ------------------------------------------------ shard-count invariance

@pytest.mark.parametrize("mode", ["partly", "full"])
def test_shard_count_invariant_fingerprints(mode):
    """The same committed trace recovers to the same structure state at
    1, 3 and 4 shards; at each count the port's images, stats, reports
    and state equal the reference's."""
    fps = {}
    for ns in (1, 3, 4):
        got = {}
        for pkg in PKG:
            a, d, t, h = _mixed(pkg, ns, mode)
            _trace(a, d, t, h)
            a.crash()
            rep = _recover(pkg, a, d, t, h, concurrency=2 if ns > 1 else 1)
            assert rep.valid and rep.generation == 9
            got[pkg] = (_fingerprint(a, d, t, h), _report(rep), _image(a),
                        _stats(a))
        assert got["port"] == got["ref"], ns
        fps[ns] = got["port"][0]
    assert fps[3] == fps[1] and fps[4] == fps[1]


# ------------------------------------------------ inter-shard commit window

@pytest.mark.parametrize("crash_after_shard", [0, 1, 2, 3])
def test_intershard_commit_window_recovers_agreed_generation(
        crash_after_shard):
    """Power fails after shard k of 4 committed generation g + 1 but
    before the manifest: recovery lands where a flushed-but-uncommitted
    crash lands, at the generation every shard reached, in both
    packages."""
    def build(pkg):
        a, d, t, h = _mixed(pkg, 4)
        _trace(a, d, t, h, n_ops=6)
        d.append_batch(np.ones((3, 7), np.int64))   # its commit fails
        return a, d, t, h

    out = {}
    for pkg in PKG:
        a0, d0, t0, h0 = build(pkg)
        gen0 = a0.header_generation()
        a0.crash()
        _recover(pkg, a0, d0, t0, h0)
        want = _fingerprint(a0, d0, t0, h0)
        a, d, t, h = build(pkg)
        a.commit(_crash_after_shard=crash_after_shard)
        torn = _image(a)
        rep = _recover(pkg, a, d, t, h)
        assert rep.generation == gen0 == 6 and rep.valid
        got = _fingerprint(a, d, t, h)
        assert got == want
        a.commit()                  # not wedged: gen 7 everywhere
        assert a.header_generation() == 7 and a.header_valid()
        out[pkg] = (torn, _report(rep), got, _image(a), _stats(a))
    assert out["port"] == out["ref"]


def test_manifest_is_written_last_on_disk(tmp_path):
    out = {}
    for pkg in PKG:
        D = PKG[pkg][2]
        path = str(tmp_path / pkg)
        a = _open(pkg, path, D.DoublyLinkedList.layout(128), 3)
        d = D.DoublyLinkedList(a, 128)
        d.append_batch(np.arange(21, dtype=np.int64).reshape(3, 7))
        a.commit()
        for k in range(3):
            assert os.path.exists(f"{path}.s{k}")
        assert os.path.exists(path + ".manifest")
        a.close()
        a2 = _open(pkg, path, D.DoublyLinkedList.layout(128), 3)
        d2 = D.DoublyLinkedList(a2, 128)
        rep = PKG[pkg][1].RecoveryManager(a2).add(
            "dll", "pstruct.dll", d2).recover()
        assert rep.valid and rep.generation == 1 and d2.count == 3
        out[pkg] = (_files(path), _report(rep))
    assert out["port"] == out["ref"]


def test_reopening_with_wrong_shard_count_fails_loudly(tmp_path):
    path = str(tmp_path / "arena")
    a = _open("port", path, TD.DoublyLinkedList.layout(128), 2)
    a.commit()
    a.close()
    for pkg in PKG:
        D = PKG[pkg][2]
        with pytest.raises(ValueError, match="2 shards, opened with 4"):
            _open(pkg, path, D.DoublyLinkedList.layout(128), 4)


def test_shard_header_ahead_of_manifest_is_still_valid():
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, 2)
        _trace(a, d, t, h, n_ops=4)
        a.commit(_crash_after_shard=0)
        ahead = a.header_valid()
        a.shards[1].generation = 0          # a shard BEHIND: corruption
        a.shards[1]._write_header(valid=True)
        out[pkg] = (ahead, a.header_valid(), _image(a))
    assert out["port"] == out["ref"]
    assert out["port"][:2] == (True, False)


# ----------------------------------------- global data-before-metadata

def test_data_before_metadata_barrier_is_global():
    """Data pinned to shard 1, header to shard 0: a torn flush persists
    shard 1's data and drops shard 0's header mark."""
    out = {}
    for pkg in PKG:
        a = _open(pkg, None, {"r": (np.int64, (64, 8), ("shard", 1)),
                              "r.header": (np.int64, (1, 8), ("shard", 0))},
                  2)
        r, hdr = a.regions["r"], a.regions["r.header"]
        with a.epoch():
            r.write_rows([5], np.full((1, 8), 7))
            r.mark_rows(np.array([5]))
            hdr.write_at([0], 0, 99)
            hdr.mark_rows(np.array([0]))
            a.writeset.flush(include_meta=False)
            assert not a.writeset
            a.crash()
        a.reopen()
        assert int(_host(r.vol)[5, 0]) == 7         # data half landed
        assert int(_host(hdr.vol)[0, 0]) == 0       # metadata half dropped
        out[pkg] = (_image(a), _stats(a))
    assert out["port"] == out["ref"]


# ------------------------------------- dependency-counter scheduler

def test_scheduler_has_no_level_barrier():
    """``child`` depends only on ``fast``: it starts while ``slow`` (fast's
    level sibling) still runs."""
    if "test.sleepy" not in TC.names():
        @TC.register("test.sleepy")
        def _sleepy(secs):
            time.sleep(secs)
            return {}

    mgr = TR.RecoveryManager()
    mgr.add("slow", "test.sleepy", 0.25)
    mgr.add("fast", "test.sleepy", 0.01)
    mgr.add("child", "test.sleepy", 0.01, depends=("fast",))
    rep = mgr.recover(reopen=False, concurrency=3)
    slow, child = rep.stage("slow"), rep.stage("child")
    assert child.t_start < slow.t_end - 0.05
    assert child.ready_at >= rep.stage("fast").t_end - 1e-6
    assert [s.name for s in rep.stages] == ["slow", "fast", "child"]


def test_stage_reports_expose_ready_at_and_queue_wait():
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, 3)
        _trace(a, d, t, h, n_ops=5)
        a.crash()
        rep = _recover(pkg, a, d, t, h, concurrency=2)
        names = [s.name for s in rep.stages]
        assert names[0] == "reopen"
        assert {n for n in names if n.startswith("load:")} == \
            {"load:bt.nodes", "load:bt.records"}
        assert names[-3:] == ["dll", "bt", "hm"]
        for s in rep.stages:
            assert s.t_start >= s.ready_at >= 0.0
            dd = s.as_dict()
            assert "ready_at" in dd and dd["queue_wait"] >= 0.0
        out[pkg] = (_report(rep), _fingerprint(a, d, t, h))
    assert out["port"] == out["ref"]
    assert out["port"][0]["stages"][0][3]["shards"] == [3]


def test_same_named_regions_across_arenas_all_reload():
    out = {}
    for pkg in PKG:
        D = PKG[pkg][2]
        rng = np.random.default_rng(5)
        arenas, dlls = [], []
        for k in range(2):
            a = _open(pkg, None, D.DoublyLinkedList.layout(2048), 2)
            d = D.DoublyLinkedList(a, 2048)
            d.append_batch(rng.integers(1, 9, (64 * (k + 1), 7)))
            a.commit()
            arenas.append(a)
            dlls.append(d)
        for a in arenas:
            a.crash()
        mgr = PKG[pkg][1].RecoveryManager(*arenas)
        mgr.add("d0", "pstruct.dll", dlls[0],
                regions=("dll.nodes", "dll.header"))
        mgr.add("d1", "pstruct.dll", dlls[1],
                regions=("dll.nodes", "dll.header"))
        rep = mgr.recover(concurrency=2)
        assert "load:dll.nodes" in [s.name for s in rep.stages]
        assert dlls[0].count == 64 and dlls[1].count == 128
        for d in dlls:
            assert (_host(d.data)[_host(d.to_list())] != 0).all()
        out[pkg] = (_report(rep), [_host(d.to_list()).tolist()
                                   for d in dlls])
    assert out["port"] == out["ref"]


def test_serial_and_concurrent_sharded_recovery_bit_identical():
    a, d, t, h = _mixed("port", 4)
    _trace(a, d, t, h)
    a.crash()
    _recover("port", a, d, t, h, concurrency=1)
    fp1 = _fingerprint(a, d, t, h)
    a.crash()
    _recover("port", a, d, t, h, concurrency=4)
    assert _fingerprint(a, d, t, h) == fp1


def test_single_shard_sharded_arena_matches_plain():
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 9, (20, 7))
    a1 = _open("port", None, TD.DoublyLinkedList.layout(128), 1)
    assert isinstance(a1, TA.Arena)
    sh = TA.ShardedArena(None, n_shards=1, device="cpu")
    for name, spec in TD.DoublyLinkedList.layout(128).items():
        sh.region(name, spec[0], spec[1],
                  router=spec[2] if len(spec) > 2 else None)
    sh.finalize()
    d1 = TD.DoublyLinkedList(a1, 128)
    d2 = TD.DoublyLinkedList(sh, 128)
    d1.append_batch(vals)
    d2.append_batch(vals)
    a1.commit()
    sh.commit()
    assert a1.stats.lines == sh.stats.lines
    # the one shard's image is the plain arena's, byte for byte
    assert _image(sh)[0] == _image(a1)[0]
    a1.crash(), sh.crash()
    a1.reopen(), sh.reopen()
    d1.reconstruct(), d2.reconstruct()
    np.testing.assert_array_equal(_host(d1.to_list()), _host(d2.to_list()))


# -------------------------------------------------------- interop, API

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_sharded_arena_files_cross_both_ways(tmp_path, writer):
    """A sharded arena one package wrote recovers in the other to the same
    state, and the reader's next commit writes the writer's bytes."""
    reader = "port" if writer == "ref" else "ref"
    path = str(tmp_path / "a")
    a, d, t, h = _mixed(writer, 4, path=path)
    _trace(a, d, t, h, n_ops=8, seed=3)
    want = _fingerprint(a, d, t, h)
    a.close()
    out = {}
    for pkg in (writer, reader):
        b, d2, t2, h2 = _mixed(pkg, 4, path=path)
        rep = _recover(pkg, b, d2, t2, h2)
        out[pkg] = (_report(rep), _fingerprint(b, d2, t2, h2))
        b.close()
    assert out[reader] == out[writer]
    assert out[reader][1]["dll.order"] == want["dll.order"]


@pytest.mark.parametrize("n_shards", [1, 4])
def test_persist_range_and_all_match_reference(n_shards):
    out = {}
    data = np.random.default_rng(2).integers(0, 1 << 40, (300, 8))
    for pkg in PKG:
        a = _open(pkg, None, {"r": (np.int64, (300, 8), ("seg", 64)),
                              "s": (np.int32, (130, 3), ("hash", 8))},
                  n_shards)
        r, s = a.regions["r"], a.regions["s"]
        r.write_rows(np.arange(300), data)
        s.write_rows(np.arange(130), data[:130, :3].astype(np.int32))
        r.persist_range(17, 203)
        s.persist_all()
        first = (_image(a), _stats(a))
        r.persist_range(5, 5)               # empty: nothing moves
        r.persist_all()
        out[pkg] = (first, _image(a), _stats(a),
                    {n: _host(x.vol).tolist() for n, x in a.regions.items()
                     if x.integ})
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("snapshot", [False, True])
@pytest.mark.parametrize("integrity", [False, True])
def test_layouts_carry_reference_routers(monkeypatch, snapshot, integrity):
    """Every layout the port builds names the reference's router for every
    region, entry by entry; the serving arenas route every region alike."""
    from repro.serve.feature_store import FeatureConfig as RFC
    from repro.serve.feature_store import FeatureStore as RFS
    from repro.serve.kvcache import PagedAllocator as RPA
    from repro.serve.kvcache import PagedConfig as RPC
    from repro_torch.serve.feature_store import FeatureConfig as TFC
    from repro_torch.serve.feature_store import FeatureStore as TFS
    from repro_torch.serve.kvcache import PagedAllocator as TPA
    from repro_torch.serve.kvcache import PagedConfig as TPC
    monkeypatch.setenv("REPRO_INTEGRITY", str(int(integrity)))
    for mode in ("partly", "full"):
        pairs = [
            (RD.DoublyLinkedList.layout(300, mode, snapshot=snapshot),
             TD.DoublyLinkedList.layout(300, mode, snapshot=snapshot)),
            (RH.Hashmap.layout(400, mode, snapshot=snapshot),
             TH.Hashmap.layout(400, mode, snapshot=snapshot)),
            (RB.BPTree.layout(256, 1024, mode),
             TB.BPTree.layout(256, 1024, mode)),
            (RJ.RequestJournal.layout(64, standalone=True),
             TJ.RequestJournal.layout(64, standalone=True))]
        for ref, port in pairs:
            assert list(port) == list(ref)
            for name in ref:
                assert (np.dtype(port[name][0]), tuple(port[name][1])) == \
                    (np.dtype(ref[name][0]), tuple(ref[name][1])), name
                assert port[name][2:] == ref[name][2:], name
        cfg = dict(n_pages=256, mode=mode, snapshot=snapshot, n_shards=2)
        fcfg = dict(n_keys=256, n_samples=256, mode=mode,
                    snapshot=snapshot, n_shards=2)
        for ref, port in ((RPA(RPC(**cfg)).arena,
                           TPA(TPC(**cfg), device="cpu").arena),
                          (RFS(RFC(**fcfg)).arena,
                           TFS(TFC(**fcfg), device="cpu").arena)):
            assert list(port.regions) == list(ref.regions)
            for name, r in ref.regions.items():
                assert port.regions[name].router == r.router, name
                np.testing.assert_array_equal(port.regions[name].shard_of,
                                              r.shard_of)
            assert _image(port) == _image(ref)


# ------------------------------------------------------ serving, journal

def test_journal_at_four_shards_matches_reference():
    """A standalone request journal on a four-shard arena: the same
    admissions, completions and crash give the same files, stats and
    journal state in both packages."""
    out = {}
    for pkg, J in (("ref", RJ), ("port", TJ)):
        a = _open(pkg, None, J.RequestJournal.layout(64, standalone=True),
                  4)
        jr = J.RequestJournal(a, 64)
        for rid in range(20):
            with a.epoch():
                jr.log(J.OP_ADMIT, rid)
                a.commit()
            if rid % 3 == 0:
                with a.epoch():
                    jr.log(J.OP_COMPLETE, rid)
                    a.commit()
        jr.retire_completed()
        with a.epoch():                     # a torn append
            jr.log(J.OP_ADMIT, 99)
            a.writeset.flush(include_meta=False)
            a.crash()
        rep = PKG[pkg][1].RecoveryManager(a).add(
            "jr", "serve.journal", jr,
            regions=("jr.jrnl", "jr.jrnlheader")).recover()
        out[pkg] = (_report(rep), sorted(jr.must_retry()), jr.classify(),
                    (jr.head, jr.tail), _image(a), _stats(a))
    assert out["port"] == out["ref"]
    assert out["port"][1] == [r for r in range(20) if r % 3]


def test_feature_store_at_four_shards_matches_reference(tmp_path):
    from repro.serve.feature_store import FeatureConfig as RFC
    from repro.serve.feature_store import FeatureStore as RFS
    from repro_torch.serve.feature_store import FeatureConfig as TFC
    from repro_torch.serve.feature_store import FeatureStore as TFS
    rng = np.random.default_rng(4)
    reqs = [(rid, rng.choice(512, 6, replace=False).astype(np.int64),
             rng.integers(-9, 10, (6, 3)).astype(np.int64))
            for rid in range(40)]
    out = {}
    for pkg, C, S in (("ref", RFC, RFS), ("port", TFC, TFS)):
        cfg = C(n_keys=512, n_samples=256, dim=3, n_shards=4)
        kw = {"device": "cpu"} if pkg == "port" else {}
        fs = S(cfg, path=str(tmp_path / pkg), **kw)
        for rid, keys, d in reqs[:30]:
            assert fs.apply(rid, keys, d)
        fs.crash()
        fs.recover(concurrency=2)
        replay = [fs.apply(rid, keys, d) for rid, keys, d in reqs]
        out[pkg] = (replay, _host(fs.lookup(np.arange(512))).tolist(),
                    _report(fs.last_recovery), _files(str(tmp_path / pkg)),
                    _stats(fs.arena))
    assert out["port"] == out["ref"]
    assert out["port"][0] == [False] * 30 + [True] * 10


@pytest.fixture(scope="module")
def models():
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.models.model import build as jbuild
    from repro_torch.configs import base as tbase
    from repro_torch.configs import registry as treg
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.model import build as tbuild
    jm = jbuild(jbase.reduced(jreg.get("llama3.2-3b")),
                compute_dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = tbuild(tbase.reduced(treg.get("llama3.2-3b")),
                compute_dtype=torch.float32)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         "cpu")


def test_engine_stripes_tokens_and_admits_per_shard_group(models, tmp_path,
                                                          monkeypatch):
    """Two prompts of one length on different token-log shards re-prefill
    as two groups (one arena would batch them once); the port's engine
    files, stats, report and tokens equal the reference's."""
    from repro.serve import engine as RE
    from repro_torch.serve import engine as TE
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    jm, jp, tm, tp = models
    out = {}
    for pkg, E, m, p in (("ref", RE, jm, jp), ("port", TE, tm, tp)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        eng = E.ServingEngine(m, p, E.EngineConfig(
            max_batch=2, s_max=16, max_requests=16, n_shards=2),
            arena_path=str(tmp_path / pkg), **kw)
        assert eng.arena.n_shards == 2
        np.testing.assert_array_equal(
            eng.arena.region_shards("tokens", np.array([0, 1])), [0, 1])
        eng.add_request(7, np.array([1, 2, 3], np.int64))
        eng.add_request(8, np.array([4, 5, 6], np.int64))
        out0 = dict(eng.step())
        eng.crash()
        eng.recover()
        det = eng.last_recovery.stage("engine").detail
        assert det["prefill_groups"] == 2 and det["shard_groups"] == 2
        out1 = dict(eng.step())
        out[pkg] = (sorted(out0), sorted(out1),
                    _report(eng.last_recovery),
                    _files(str(tmp_path / pkg)), _stats(eng.arena))
    assert out["port"] == out["ref"]
    assert out["port"][:2] == ([7, 8], [7, 8])
