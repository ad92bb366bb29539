"""repro_torch shadow commit on sharded arenas (DESIGN.md §9 over §7), on
the CPU against the JAX reference.

Both packages run the same seeded operations; the port runs with
``device="cpu"``.  After every commit every shard file (or in-memory shard
image), the manifest and ``FlushStats`` (aggregate and per shard) must be
byte- and field-equal, and the recovered state equal.  The cases:

* the ``("shadow", k)`` cells, k = -1..3, of
  ``tests/test_sharded_arena.py::test_commit_window_sweep_both_modes`` and
  ``test_shadow_gc_crash_is_idempotent[4]``;
* each structure at 3 and 4 shards (3: the routers' non-power-of-two
  partition), both modes, integrity off and on;
* a non-commit epoch marking rows on some shards only: only the shards
  with work fold, and ``saved_lines`` counts the fold;
* a torn manifest (a crash after shard k's flip, k = 0..2): every shard
  re-anchors to the manifest's generation and the next drain targets the
  bank its parity dooms;
* the ``("shadow", 4)`` cells of ``tests/test_integrity.py``'s GRID
  (through ``tests/test_torch_integrity.py``'s helpers) and of
  ``tests/test_async_recovery.py``'s FS_GRID;
* the boundary sweep, the snapshot ``MODES`` and the journal scenarios at
  four shards (parametrized here: the port's tests read no
  ``REPRO_N_SHARDS``);
* a sharded shadow image written by either package recovering in the
  other; one grouped gather per drain at any shard count; a flip in a
  remapped row on shard 3 that scrub names alone.

Integer and byte results, compared exactly (tolerance 0).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_torch_integrity as TI
import test_torch_journal as TJT
import test_torch_shadow as TSH
import test_torch_shadow_recovery as TSR
import test_torch_sharded as TSD
import test_torch_snapshot as TS
from repro.serve.feature_store import FeatureConfig as JConfig
from repro.serve.feature_store import FeatureStore as JStore
from repro_torch import feature_recover as FR
from repro_torch.core.writeset import WriteSet
from repro_torch.interop import arena_from_image
from repro_torch.serve.feature_store import FeatureConfig as TConfig
from repro_torch.serve.feature_store import FeatureStore as TStore

PKG = TI.PKG
SHADOW4 = {"n_shards": 4, "commit_mode": "shadow"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # integrity resolves on by default in both packages; paging stays off
    monkeypatch.delenv("REPRO_INTEGRITY", raising=False)
    monkeypatch.delenv("REPRO_PAGED", raising=False)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _images(a):
    """Every shard's image, then the manifest."""
    return tuple(bytes(np.asarray(sh._mm)) for sh in a.shards) + (
        bytes(np.asarray(a._man)),)


def _bank_state(a):
    """Each shard's volatile shadow bookkeeping: generation, authoritative
    bank, counts, collapsed flags and masks."""
    return [(sh.generation, sh._shadow_auth_bank, list(sh._shadow_counts),
             list(sh._shadow_collapsed),
             [{k: np.flatnonzero(v).tolist() for k, v in sorted(m.items())}
              for m in sh._shadow_masks]) for sh in a.shards]


# ------------------------------------------------------- the commit window

def _window_build(pkg):
    a, d, t, h = TSD._mixed(pkg, 4, commit_mode="shadow")
    TSD._trace(a, d, t, h, n_ops=6)
    d.append_batch(np.ones((3, 7), np.int64))
    return a, d, t, h


@pytest.mark.parametrize("crash_after_shard", [-1, 0, 1, 2, 3])
def test_commit_window_sweep_shadow(crash_after_shard):
    """``test_commit_window_sweep_both_modes[shadow-k]``: -1 crashes after
    every shard sealed and before any flip, k >= 0 after shard k's flip
    and before the manifest.  Recovery lands on the manifest's generation
    where a drained-but-uncommitted crash lands, and the next commit seals
    generation 7 everywhere; both packages' bytes agree at each step."""
    out = {}
    for pkg in PKG:
        a0, d0, t0, h0 = _window_build(pkg)
        gen0 = a0.header_generation()
        a0.crash()
        TSD._recover(pkg, a0, d0, t0, h0)
        want = TSD._fingerprint(a0, d0, t0, h0)
        a, d, t, h = _window_build(pkg)
        a.commit(_crash_after_shard=crash_after_shard)
        torn = (_images(a), TSD._stats(a))
        rep = TSD._recover(pkg, a, d, t, h)
        assert rep.valid and rep.generation == gen0 == 6
        got = TSD._fingerprint(a, d, t, h)
        assert got == want, pkg
        heads = [sh.header_generation() for sh in a.shards]
        assert heads == [7 if s <= crash_after_shard else 6
                         for s in range(4)]
        assert all(sh.generation == 6 for sh in a.shards)
        a.commit()
        assert a.header_generation() == 7 and a.header_valid()
        out[pkg] = (torn, TSD._report(rep), got, heads, _images(a),
                    TSD._stats(a), _bank_state(a))
    assert out["port"] == out["ref"]


def test_shadow_gc_crash_is_idempotent_four_shards():
    """``test_shadow_gc_crash_is_idempotent[4]``: every shard's fold is cut
    after one region, power fails, recovery reruns, twice; the committed
    state never moves, the packages agree byte for byte, and the arena
    commits afterwards."""
    out = {}
    for pkg in PKG:
        a, d, t, h = TSD._mixed(pkg, 4, commit_mode="shadow")
        TSD._trace(a, d, t, h, n_ops=6)
        a.crash()
        TSD._recover(pkg, a, d, t, h)
        want = TSD._fingerprint(a, d, t, h)
        runs = []
        for _ in range(2):
            for sh in a.shards:
                sh._shadow_collapse(limit=1)
            a.crash()
            rep = TSD._recover(pkg, a, d, t, h)
            assert rep.valid and rep.generation == 6
            assert TSD._fingerprint(a, d, t, h) == want
            runs.append((_images(a), TSD._stats(a), _bank_state(a)))
        d.append_batch(np.ones((2, 7), np.int64))
        a.commit()
        assert a.header_generation() == 7 and a.header_valid()
        out[pkg] = (runs, _images(a), TSD._stats(a), want)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("crash_after_shard", [0, 1, 2])
def test_torn_manifest_next_drain_targets_manifest_bank(crash_after_shard):
    """Shards 0..k flipped their headers to 7, the manifest stayed at 6.
    Recovery parses every shard's bank under the manifest's generation:
    each shard's next drain targets bank (6 + 1) % 2, so the flipped
    shards overwrite the bank their own headers name.  Two more epochs
    (one uncommitted between them) then commit, crash and recover with
    the reference's bytes."""
    out = {}
    for pkg in PKG:
        a, d, t, h = _window_build(pkg)
        a.commit(_crash_after_shard=crash_after_shard)
        TSD._recover(pkg, a, d, t, h)
        for s, sh in enumerate(a.shards):
            assert sh.header_generation() == (
                7 if s <= crash_after_shard else 6)
            assert sh.generation == 6 and sh._shadow_auth_bank == 0
            assert sh._shadow_target_bank() == 1
        steps = []
        with a.epoch():
            d.append_batch(np.full((5, 7), 3, np.int64))
            t.insert_batch(np.arange(900, 906, dtype=np.int64),
                           np.full((6, 7), 4, np.int64))
        steps.append((_images(a), TSD._stats(a), _bank_state(a)))
        with a.epoch():
            h.insert_batch(np.arange(700, 709, dtype=np.int64),
                           np.full((9, 7), 5, np.int64))
        a.commit()
        assert a.header_generation() == 7
        steps.append((_images(a), TSD._stats(a), _bank_state(a)))
        a.crash()
        rep = TSD._recover(pkg, a, d, t, h)
        assert rep.valid and rep.generation == 7
        out[pkg] = (steps, TSD._report(rep), TSD._fingerprint(a, d, t, h),
                    _images(a), TSD._stats(a))
    assert out["port"] == out["ref"]


# ------------------------------------------------------------ structures

@pytest.mark.parametrize("n_shards", [3, 4])
@pytest.mark.parametrize("integrity", [False, True])
@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("kind", ["dll", "bptree", "hashmap"])
def test_structure_files_stats_and_recovery_match(tmp_path, kind, mode,
                                                  integrity, n_shards):
    """Each structure on a sharded shadow arena: every shard file, its
    ``.layout``, the manifest, and FlushStats aggregate and per shard
    after every step (some epochs drain uncommitted), then equal
    recovery."""
    built = {pkg: TSH._structure(pkg, kind, mode, str(tmp_path / pkg),
                                 integrity=integrity, n_shards=n_shards,
                                 commit_mode="shadow")
             for pkg in PKG}
    rngs = {pkg: np.random.default_rng(5) for pkg in PKG}
    for i in range(9):
        for pkg, (a, s) in built.items():
            with a.epoch():
                TSH._ops(kind, s, rngs[pkg], i)
            if i % 3 != 1:
                a.commit()
        (pa, _), (ra, _) = built["port"], built["ref"]
        assert TSD._stats(pa) == TSD._stats(ra), i
        assert _images(pa) == _images(ra), i
    assert TSD._files(str(tmp_path / "port")) == \
        TSD._files(str(tmp_path / "ref"))
    out = {}
    for pkg, (a, s) in built.items():
        a.crash()
        mgr = PKG[pkg][2].RecoveryManager(a)
        mgr.add(kind, {"dll": "pstruct.dll", "bptree": "pstruct.bptree",
                       "hashmap": "pstruct.hashmap"}[kind], s,
                regions=tuple(a.regions))
        rep = mgr.recover(concurrency=2)
        out[pkg] = (TI._report(rep), TSH._state(kind, s), TI._scrub(a),
                    a.generation, _bank_state(a))
    assert out["port"] == out["ref"]


def _seg_arena(pkg, integrity):
    """A bare four-shard shadow arena: 256 rows in ("seg", 64) segments
    (shard s holds rows 64s..64s+63), a header (pinned to shard 1) and a
    snapshot ring (pinned to shard 2)."""
    A = PKG[pkg][0]
    kw = {"device": "cpu"} if pkg == "port" else {}
    return A.open_arena(None, {"x.data": (np.int64, (256, 8), ("seg", 64)),
                               "x.header": (np.int64, (1, 8)),
                               "x.snap": (np.int64, (16, 8))},
                        integrity=integrity, **SHADOW4, **kw)


@pytest.mark.parametrize("integrity", [False, True])
def test_only_shards_with_work_fold(integrity):
    """A committed epoch rewrites rows on every shard; the next epoch
    drains without a commit and marks rows of shard 1 only (its data rows,
    one of them fresh as well, two fresh only, and the header): shard 1 folds its committed bank and
    the others do not, so their FlushStats stay put until the commit,
    where they fold.  Saved lines count shard 1's fold.  Per-shard
    FlushStats and images equal the reference's at each step."""
    out = {}
    for pkg in PKG:
        a = _seg_arena(pkg, integrity)
        x = a.regions["x.data"]
        x.write_rows(np.arange(256), np.arange(2048).reshape(256, 8))
        with a.epoch():
            x.mark_rows(np.arange(0, 256, 5))
            a.regions["x.header"].mark_rows([0])
            a.regions["x.snap"].mark_rows([1, 2])
        a.commit()
        steps = [(_images(a), TSD._stats(a))]
        before = a.shard_stats()
        with a.epoch():
            x.write_rows(np.arange(64, 80), np.full((16, 8), 9))
            x.mark_rows(np.arange(64, 78))
            x.mark_rows(np.array([70, 78, 79]), fresh=True)
            a.regions["x.header"].mark_rows([0])
        after = a.shard_stats()
        for s in (0, 2, 3):
            assert after[s] == before[s], s
            assert not a.shards[s]._shadow_collapsed[a.shards[s].generation
                                                     % 2]
        assert after[1].lines > before[1].lines
        assert a.shards[1]._shadow_collapsed[a.shards[1].generation % 2]
        steps.append((_images(a), TSD._stats(a), _bank_state(a)))
        a.commit()
        assert all(sh._shadow_collapsed[1 - sh.generation % 2]
                   for sh in a.shards)
        steps.append((_images(a), TSD._stats(a), _bank_state(a)))
        out[pkg] = steps
    assert out["port"] == out["ref"]


# --------------------------------------- one gather a drain, any shard count

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_one_gather_per_drain_at_any_shard_count(monkeypatch, n_shards):
    """The port's sharded shadow drain stages every shard's fresh and
    rewritten rows in ONE grouped gather; a commit pays one more drain's
    gather at most (its snapshot rows) and ONE fence."""
    calls = []
    real = WriteSet.gather

    def spy(self, plan):
        calls.append(len(plan))
        return real(self, plan)
    monkeypatch.setattr(WriteSet, "gather", spy)
    a, d, t, h = TI._mixed("port", None, "partly", n_shards=n_shards,
                           commit_mode="shadow")
    for i, op in enumerate(TI._script(6, seed=8)):
        del calls[:]
        with a.epoch():
            TI._apply(d, t, h, op)
        assert len(calls) == 1 and calls[0] >= 2, calls
        s0 = a.stats.snapshot()
        del calls[:]
        a.commit()
        assert len(calls) <= 1
        assert a.stats.delta(s0).fences == 1
    if n_shards > 1:
        assert all(sh.stats.fences == 0 for sh in a.shards)


# --------------------------------- integrity GRID: the ("shadow", 4) cells

@pytest.mark.parametrize("target", [("dll.nodes", 2, "order"),
                                    ("bt.nodes", 0, "leaves"),
                                    ("hm.entries", 3, None),
                                    ("bt.records", 4, None)])
def test_scrub_names_flip_and_stuck_line_sharded_shadow(tmp_path, target):
    TI._scrub_names(tmp_path, target, **SHADOW4)


def test_scrub_under_traffic_no_false_positives_sharded_shadow(tmp_path):
    TI._scrub_under_traffic(tmp_path, **SHADOW4)


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("boundary", [3, 7])
def test_corruption_crash_double_failure_sharded_shadow(tmp_path, torn,
                                                        boundary):
    TI._double_failure(tmp_path, torn, boundary, **SHADOW4)


@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("victim", ["dll", "bt", "hm"])
def test_mixed_salvage_matches_reference_sharded_shadow(tmp_path, mode,
                                                        victim):
    TI._mixed_salvage(tmp_path, mode, victim, **SHADOW4)


def test_remapped_fault_on_shard_3_is_named_alone(tmp_path):
    """A flip in a DLL row that shard 3's authoritative bank remaps:
    ``committed_row_offset`` resolves it to shard 3's mirror slot in that
    bank, scrub names that row alone, and salvage cuts only the DLL."""
    out = {}
    for pkg in PKG:
        a, d, t, h = TI._mixed(pkg, str(tmp_path / pkg), **SHADOW4)
        TI._run(a, d, t, h, TI._script(6, seed=1))
        # DLL rows 192..255 are shard 3's ("seg", 64); deleting 200 and
        # 230 rewrites their live neighbours through shard 3's bank
        d.append_batch(np.arange(210 * 7).reshape(210, 7))
        a.commit()
        with a.epoch():
            d.delete_batch(np.array([200, 230]))
            t.delete_batch(_host(t.keys_in_order())[1:3])
        a.commit()
        region = a.regions["dll.nodes"]
        sl, sh = region.slices[3], a.shards[3]
        remapped = sl._gidx[np.flatnonzero(
            sh._shadow_masks[sh._shadow_auth_bank]["dll.nodes"])]
        live = np.intersect1d(remapped, _host(d.to_list()))
        assert live.size, "no live dll.nodes row in shard 3's bank"
        row = int(live[0])
        before = TI._fingerprint(d, t, h)
        a.crash()
        F = PKG[pkg][1]
        owner, off, rb = F.committed_row_offset(a, "dll.nodes", row)
        bank = sh.header_generation() % 2
        assert owner is sh
        assert off == sl._shadow_off[bank] + int(region.local_of[row]) * rb
        F.flip_bits(a, "dll.nodes", row, byte=8, mask=0x40)
        a.reopen()
        bad = TI._scrub(a)
        assert bad == {"dll.nodes": [row]}
        rep = TI._manager(pkg, a, d, t, h).recover(salvage=True)
        assert rep.quarantined + rep.degraded == ["dll"]
        after = TI._fingerprint(d, t, h)
        for k in ("bt.keys", "hm.keys", "hm.values"):
            assert after[k] == before[k], k
        out[pkg] = (row, off, bad, TI._report(rep), after, TI._image(a))
    assert out["port"] == out["ref"]


# ------------------------------------------- FS_GRID: the ("shadow", 4) cells

def _store_cfg(cls, **kw):
    return cls(n_keys=64, dim=3, n_samples=512, **SHADOW4, **kw)


@pytest.mark.parametrize("torn", [False, True])
def test_feature_store_exactly_once_every_boundary_sharded_shadow(
        monkeypatch, torn):
    """``test_journal_exactly_once_every_boundary[shadow-4]``: at every
    epoch boundary, a crash (torn inside a request, or clean between),
    recovery and a replay of the whole script refuse exactly the
    completed requests; the effects equal the uninterrupted twin's, which
    equal the reference's four-shard shadow store's."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    ops = FR.oracle_script(6, seed=13)
    cfg = dataclasses.replace(FR.oracle_config(), **SHADOW4)
    want = FR.run_twin(cfg, ops, "cpu")
    ref = JStore(_store_cfg(JConfig, journal=True))
    for op in ops:
        assert ref.apply(*op)
    np.testing.assert_array_equal(want["effects"]["vectors"],
                                  ref.lookup(np.arange(64)))
    np.testing.assert_array_equal(want["effects"]["counts"], ref.counts)
    assert want["effects"]["classify"] == ref.journal.classify()
    assert want["stats"] == dataclasses.asdict(
        ref.arena.stats.delta(type(ref.arena.stats)()))
    last = len(ops) if not torn else len(ops) - 1
    for boundary in range(last + 1):
        out = FR.twin(cfg, ops, boundary, torn=torn, device="cpu",
                      concurrency=2, want=want)
        assert out["refused"] == boundary


@pytest.mark.parametrize("mode", ["partly", "full"])
def test_feature_store_files_and_recovery_sharded_shadow(monkeypatch,
                                                         tmp_path, mode):
    """Every shard file and FlushStats after every request, recovery stage
    details and state after a torn request, then more requests: both
    packages' four-shard shadow stores."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    ref = JStore(_store_cfg(JConfig, mode=mode, journal=True),
                 str(tmp_path / "ref"))
    port = TStore(_store_cfg(TConfig, mode=mode, journal=True),
                  str(tmp_path / "port"), device="cpu")
    ops = FR.oracle_script(12, seed=3)

    def same():
        assert TSD._files(str(tmp_path / "ref")) == \
            TSD._files(str(tmp_path / "port"))
        assert TSD._stats(port.arena) == TSD._stats(ref.arena)
        keys = np.arange(64)
        np.testing.assert_array_equal(port.lookup(keys).numpy(),
                                      ref.lookup(keys))

    for op in ops[:8]:
        assert ref.apply(*op) == port.apply(*op) is True
        same()
    ref.apply(*ops[8], _torn_crash=True)
    port.apply(*ops[8], _torn_crash=True)
    rr, pr = ref.recover(concurrency=2), port.recover(concurrency=2)
    assert TSD._report(pr) == TSD._report(rr)
    same()
    for op in ops[8:]:
        assert port.apply(*op) == ref.apply(*op)
    same()


# -------------------- boundary sweep, snapshot MODES, journal at four shards

@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("torn", [False, True])
def test_crash_fuzz_every_boundary_sharded_shadow(monkeypatch, mode, torn):
    """``test_crash_fuzz_every_boundary`` at four shards, shadow commit,
    recovered at concurrency 4 (per-region load stages): the committed
    generation's state at every boundary, and both packages' bytes,
    counters and reports equal."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    ops = TI._script(8, seed=3)
    for boundary in range(len(ops)):
        out = {}
        for pkg in PKG:
            (a, d, t, h), want = TSR._crashed(pkg, ops, boundary, torn,
                                              mode, **SHADOW4)
            mgr = PKG[pkg][2].RecoveryManager(a)
            mgr.add("dll", "pstruct.dll", d, regions=("dll.nodes",
                                                     "dll.header"))
            mgr.add("bt", "pstruct.bptree", t,
                    regions=("bt.nodes", "bt.records", "bt.header"))
            mgr.add("hm", "pstruct.hashmap", h,
                    regions=("hm.entries", "hm.header"))
            rep = mgr.recover(concurrency=4)
            assert rep.valid and rep.generation == boundary + 1
            got = TI._fingerprint(d, t, h)
            assert got == want, (pkg, boundary)
            out[pkg] = (TI._report(rep), got, _images(a), TSD._stats(a))
        assert out["port"] == out["ref"], boundary


@pytest.mark.parametrize("mode", ["partly", "full"])
def test_snapshot_images_and_stats_after_every_commit_sharded_shadow(mode):
    """The snapshot ``MODES`` on four-shard shadow arenas: records sealed
    at commits and at plain drains, a crash and snapshot adoption, then
    more steps on the resumed providers."""
    sides = {pkg: TS._build(pkg, mode, **SHADOW4) for pkg in PKG}
    ops = {pkg: TS._Ops(21) for pkg in PKG}
    snaps = {pkg: [] for pkg in PKG}
    for phase in range(2):
        for i in range(12):
            for pkg, (a, d, h) in sides.items():
                ops[pkg].step(d, h, i)
                if i % 3 != 1:
                    a.commit()
                    snaps[pkg].append((_images(a), TSD._stats(a)))
        for pkg, (a, d, h) in sides.items():
            a.crash()
            a.reopen()
            snaps[pkg].append(TS._reconstruct(pkg, d, h))
    assert snaps["port"][-1][1]["chain"] == "snapshot"
    assert snaps["port"] == snaps["ref"]
    TS._assert_same(TS._state(*sides["ref"][1:], ops["ref"].keys),
                    TS._state(*sides["port"][1:], ops["port"].keys))


REF4 = SimpleNamespace(**{**vars(TJT.REF), "image": _images,
                          "kw": dict(SHADOW4)})
PORT4 = SimpleNamespace(**{**vars(TJT.PORT), "image": _images,
                           "kw": {"device": "cpu", **SHADOW4}})


@pytest.mark.parametrize("scenario", TJT.SCENARIOS, ids=lambda f: f.__name__)
def test_journal_matches_reference_sharded_shadow(monkeypatch, scenario):
    """Every journal scenario on a four-shard shadow arena: the same
    events, classes, head and tail, shard images and flush counters."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    ra, rj, rev = scenario(REF4)
    ta, tj, tev = scenario(PORT4)
    assert ta.commit_mode == ra.commit_mode == "shadow"
    assert ta.n_shards == ra.n_shards == 4
    assert tev == rev
    assert tj.classify() == rj.classify()
    assert tj.must_retry() == rj.must_retry()
    assert (tj.head, tj.tail, tj.space()) == (rj.head, rj.tail, rj.space())
    assert _images(ra) == _images(ta)
    assert TSD._stats(ta) == TSD._stats(ra)


# ----------------------------------------------------------- interop

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_sharded_shadow_files_recover_in_the_other_package(tmp_path,
                                                           writer):
    """Four-shard shadow files written by either package, the last epoch
    drained into the target banks but never flipped, recover in the other
    to the writer's committed state; then a commit from the reader gives
    the files the writer's own next commit gives."""
    reader = "port" if writer == "ref" else "ref"
    ops = TI._script(10, seed=4)
    a, d, t, h = TI._mixed(writer, str(tmp_path / "w"), **SHADOW4)
    TI._run(a, d, t, h, ops[:9])
    with a.epoch():
        d.pop_front_batch(2)
        TI._apply(d, t, h, ops[9])
    a.crash()
    TI._manager(writer, a, d, t, h).recover()
    want = TI._fingerprint(d, t, h)
    a.close()
    b, d2, t2, h2 = TI._mixed(reader, str(tmp_path / "w"), **SHADOW4)
    rep = TI._manager(reader, b, d2, t2, h2).recover()
    assert rep.valid and rep.generation == 9
    assert TI._fingerprint(d2, t2, h2) == want
    assert b.scrub() == {}
    # each shard's image alone, through interop: a plain shadow arena
    # whose committed bank's rows load over its home rows
    for sh in b.shards:
        c = arena_from_image(np.asarray(sh._mm), sh._meta, "cpu",
                             commit_mode="shadow")
        assert c.generation == 9
        for name, r in c.regions.items():
            np.testing.assert_array_equal(_host(r.vol),
                                          sh._pimage(sh.regions[name]))
