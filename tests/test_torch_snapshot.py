"""repro_torch order snapshots and staged recovery vs the reference.

The same seeded operations run in both packages (both pinned to
``integrity=False``; snapshots on unless a test says otherwise; the port on
CPU tensors, where every kernel wrapper takes its plain version):

* the ``None`` resolution of ``snapshot=`` / ``integrity=`` follows the
  reference's env axes;
* snapshot records pack, parse and checksum alike;
* after every commit: byte-identical images (snapshot regions included),
  equal FlushStats (``snapshot_lines`` included), equal layouts;
* torn-record, suffix-replay, clean, restart and snapshot-off recoveries
  reach equal state with equal stage detail (``chain``, ``replayed``);
* RecoveryManager reports agree minus their timing fields;
* an arena file written by either package recovers in the other through
  RecoveryManager by adopting its snapshot.

Integer state throughout, compared exactly (tolerance 0)."""
import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import arena as RA, reconstruct as RREC, recovery as R
from repro.pstruct import dll as RD, hashmap as RH
from repro_torch import snapshot_recovery
from repro_torch.core import arena as TA, reconstruct as TREC, recovery as TR
from repro_torch.pstruct import dll as TD, hashmap as TH

MODES = ("partly", "full")
PKG = {"ref": (RA, RD, RH, R), "port": (TA, TD, TH, TR)}
TIMING = {"seconds", "t_start", "t_end", "ready_at", "queue_wait",
          "total_seconds", "wall_ms", "total_ms", "critical_path_ms"}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _build(pkg, mode="partly", snapshot=True, path=None, dll_cap=64,
           hm_cap=1024, **arena_kw):
    A, D, H, _ = PKG[pkg]
    layout = {}
    layout.update(D.DoublyLinkedList.layout(dll_cap, mode, name="dll",
                                            snapshot=snapshot))
    layout.update(H.Hashmap.layout(hm_cap, mode, name="hm",
                                   snapshot=snapshot))
    kw = {"device": "cpu"} if pkg == "port" else {}
    a = A.open_arena(path, layout, integrity=False, **kw, **arena_kw)
    return (a, D.DoublyLinkedList(a, dll_cap, mode, name="dll",
                                  snapshot=snapshot),
            H.Hashmap(a, hm_cap, mode, name="hm", snapshot=snapshot))


class _Ops:
    """Seeded DLL appends / pops / deletes and hashmap inserts (with
    duplicates and updates) / removes; called identically on both
    packages."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.ids = []            # DLL order as the workload sees it
        self.appended = 0
        self.keys = {}           # hashmap: live key -> value row

    def step(self, d, h, i):
        rng = self.rng
        new = d.append_batch(rng.integers(0, 1 << 40,
                                          (int(rng.integers(1, 12)), 7)))
        self.ids.extend(_np(new).tolist())
        self.appended += len(new)
        if len(self.ids) > 8:
            popped = _np(d.pop_front_batch(int(rng.integers(1, 8)))).tolist()
            del self.ids[:len(popped)]
        if i % 3 == 2 and len(self.ids) > 4:
            gone = rng.choice(self.ids, int(rng.integers(1, 4)),
                              replace=False)
            d.delete_batch(gone)
            self.ids = [x for x in self.ids if x not in set(gone.tolist())]
        m = int(rng.integers(3, 30))
        ks = rng.integers(0, 400, m).astype(np.int64)
        vs = rng.integers(0, 1 << 40, (m, 7)).astype(np.int64)
        h.insert_batch(ks, vs)
        for k, v in zip(ks.tolist(), vs):
            self.keys[k] = v
        if i % 4 == 3:
            gone = rng.integers(0, 400, int(rng.integers(2, 12)))
            h.remove_batch(gone.astype(np.int64))
            for k in gone.tolist():
                self.keys.pop(k, None)


def _state(d, h, keys):
    order = _np(d.to_list())
    probe = np.concatenate([np.fromiter(keys, np.int64, len(keys)),
                            np.arange(1000, 1010)])
    ok, vals = h.find_batch(probe)
    return {"order": order, "data": _np(d.nodes.vol)[order, :7],
            "prev": _np(d.prev), "ring": _np(d.order()),
            "free": list(d._free), "hm_size": int(_np(h.header.vol)[0, 1]),
            "hm_ok": _np(ok), "hm_vals": _np(vals),
            "buckets": _np(h.buckets), "chain": _np(h.chain),
            "n_buckets": h.n_buckets}


def _logical(st):
    """What a recovery must restore: order, data and finds (the bucket
    basis, PREV of dead rows and the free-list order are volatile
    redundancy a rebuild derives afresh)."""
    return {k: st[k] for k in ("order", "data", "ring", "hm_size", "hm_ok",
                               "hm_vals")}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _image(a):
    return np.array(a._mm)


def _stats(a):
    return dataclasses.asdict(a.stats)


def _recs(region):
    """(seq, slot) of the intact records in a loaded record ring."""
    return [(r[1], s) for s in range(RA.SNAP_SLOTS)
            if (r := RA.snap_record_parse(_np(region.vol)[s])) is not None]


def _tear(d, h, how):
    """Garble snapshot bytes as loaded: the newest record ("record"), or
    every record and half of each mirror ("all")."""
    if how == "record":
        for reg in (d.snaprec, h.snaprec):
            if _recs(reg):
                reg.vol[max(_recs(reg))[1], 3:] = -777
    else:
        for reg in (d.snaprec, h.snaprec):
            reg.vol[:, 2:] = -777
        d.snapring.vol[::2] = 2 ** 40
        h.snapchain.vol[::2] = 2 ** 40


def _reconstruct(pkg, d, h):
    _, D, H, _ = PKG[pkg]
    return D._reconstruct_dll(d), H._reconstruct_hashmap(h)


def _strip(report):
    """A report's as_dict() without its timing fields."""
    out = {k: v for k, v in report.as_dict().items() if k not in TIMING}
    out["stages"] = [{k: v for k, v in st.items() if k not in TIMING}
                     for st in out["stages"]]
    return out


# ------------------------------------------------------------- repairs

@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("mode", MODES)
def test_snapshot_none_resolves_like_reference(monkeypatch, env, mode):
    """``snapshot=None`` follows REPRO_SNAPSHOT (default on) in both
    packages: equal layouts, and the structures declare them alike."""
    if env is None:
        monkeypatch.delenv("REPRO_SNAPSHOT", raising=False)
    else:
        monkeypatch.setenv("REPRO_SNAPSHOT", env)
    assert TA.snapshot_enabled(None) == RA.snapshot_enabled(None)
    assert TA.snapshot_enabled(None) == (env != "0")
    for flag in (True, False):
        assert TA.snapshot_enabled(flag) == flag
    for cls in ("DoublyLinkedList", "Hashmap"):
        want = getattr(RD if cls[0] == "D" else RH, cls).layout(64, mode)
        got = getattr(TD if cls[0] == "D" else TH, cls).layout(64, mode)
        assert list(got) == list(want)
        for name in got:
            assert got[name][:2] == want[name][:2]
    a, d, h = _build("port", mode, snapshot=None)
    ra, rd, rh = _build("ref", mode, snapshot=None)
    assert list(a.regions) == list(ra.regions)
    assert d.snapshot == rd.snapshot == h.snapshot == (env != "0")


@pytest.mark.parametrize("env", [None, "0"])
def test_integrity_none_never_builds_another_layout(monkeypatch, env):
    """``integrity=None`` resolves as in the reference: where the reference
    resolves it on and builds a checksum sidecar, the port builds the same
    sidecar layout; where it resolves off, both build the same layout
    without one."""
    if env is None:
        monkeypatch.delenv("REPRO_INTEGRITY", raising=False)
    else:
        monkeypatch.setenv("REPRO_INTEGRITY", env)
    layout = TD.DoublyLinkedList.layout(32, snapshot=False)
    ref = RA.open_arena(None, layout)
    sidecars = [n for n in ref.regions if n.endswith(".integ")]
    assert TA.integrity_enabled(None) == RA.integrity_enabled(None)
    port = TA.open_arena(None, layout, device="cpu")
    assert list(port.regions) == list(ref.regions)
    assert port._meta == ref._meta
    assert port.integrity == ref.integrity == bool(sidecars)
    assert bool(sidecars) == (env is None)
    assert TA.Arena(None, device="cpu").integrity == (env is None)
    assert TA.Arena(None, device="cpu", integrity=True).integrity


# ------------------------------------------------------------- records

def test_record_pack_and_checksum_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        f = rng.integers(-(1 << 62), 1 << 62, 6).tolist()
        np.testing.assert_array_equal(TA.snap_record_pack(*f),
                                      RA.snap_record_pack(*f))
        assert TA.snap_record_parse(RA.snap_record_pack(*f)) == tuple(f)
    for shape in [(8,), (5, 8), (7, 3), (2, 4, 8)]:
        w = rng.integers(-(1 << 63), (1 << 63) - 1, shape, dtype=np.int64)
        np.testing.assert_array_equal(TA.mix_checksums(w),
                                      RA.mix_checksums(w))
        np.testing.assert_array_equal(TA.mix_checksums(w.view(np.uint64)),
                                      RA.mix_checksums(w.view(np.uint64)))


def test_record_checksum_rejects_bitflips():
    rec = TA.snap_record_pack(3, 7, 10, 20, 30)
    assert TA.snap_record_parse(rec) == (3, 7, 10, 20, 30, 0)
    for w in range(8):
        for bit in (0, 17, 63):
            bad = rec.copy()
            bad[w] ^= np.int64(1) << np.int64(bit)
            assert TA.snap_record_parse(bad) is None
            assert RA.snap_record_parse(bad) is None
    assert TA.snap_record_parse(np.zeros(8, np.int64)) is None
    assert TA.snap_record_parse(rec[:7]) is None


# --------------------------------------------------------------- bytes

@pytest.mark.parametrize("mode", MODES)
def test_images_and_stats_identical_after_every_commit(mode):
    """Appends, pops, deletes and ring compaction on the DLL, inserts with
    updates and removes on the hashmap; commits after some steps only, so
    records are also sealed at plain epoch drains; then a crash, recovery
    (snapshot adoption) and more steps on the resumed providers."""
    sides = {pkg: _build(pkg, mode) for pkg in PKG}
    ops = {pkg: _Ops(21) for pkg in PKG}
    snaps = {pkg: [] for pkg in PKG}
    for phase in range(2):
        for i in range(26):
            for pkg, (a, d, h) in sides.items():
                ops[pkg].step(d, h, i)
                if i % 3 != 1:
                    a.commit()
                    snaps[pkg].append((_image(a), _stats(a)))
        if phase == 0:                 # r1 only grows, unless compacted
            assert sides["port"][1]._r1 < ops["port"].appended
        for pkg, (a, d, h) in sides.items():
            a.crash()
            a.reopen()
            snaps[pkg].append(_reconstruct(pkg, d, h))
    assert snaps["port"][-1][1]["chain"] == "snapshot"
    assert len(snaps["ref"]) == len(snaps["port"])
    for want, got in zip(snaps["ref"], snaps["port"]):
        if isinstance(want[0], np.ndarray):
            np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert snaps["port"][-2][1]["snapshot_lines"] > 0
    _assert_same(_state(*sides["ref"][1:], ops["ref"].keys),
                 _state(*sides["port"][1:], ops["port"].keys))
    assert list(sides["port"][0]._meta) == list(sides["ref"][0]._meta)


@pytest.mark.parametrize("mode", MODES)
def test_hashmap_growth_resync_parity(mode):
    """A recovery whose records are all torn rebuilds with a small bucket
    count; later inserts grow it twice, and each growth re-mirrors the
    whole chain state at the next drain."""
    rng = np.random.default_rng(12)
    keys = rng.choice(10 ** 6, 320, replace=False).astype(np.int64)
    vals = rng.integers(0, 1 << 40, (320, 7)).astype(np.int64)
    got = {}
    for pkg in PKG:
        a, d, h = _build(pkg, mode, hm_cap=400)
        h.insert_batch(keys[:60], vals[:60])
        a.commit()
        h.snaprec._pview()[:] = 0                 # no record survives
        a.crash()
        a.reopen()
        det = _reconstruct(pkg, d, h)[1]
        assert det["chain"] == "rebuild" and h.n_buckets == 128
        for i in range(60, 320, 50):
            h.insert_batch(keys[i:i + 50], vals[i:i + 50])
            a.commit()
        assert h.n_buckets == 512
        h.remove_batch(keys[::7])
        a.commit()
        a.crash()
        a.reopen()
        det = _reconstruct(pkg, d, h)[1]
        got[pkg] = (_image(a), _stats(a), det, _np(h.buckets), _np(h.chain))
    for w, g in zip(got["ref"], got["port"]):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    assert got["port"][2]["chain"] == "snapshot"


# ------------------------------------------------------------ recovery

def _script(n_ops, seed=0):
    """The reference's torn-record workload: every op one epoch + commit."""
    rng = np.random.default_rng(seed)
    ops, key = [], 0
    for i in range(n_ops):
        m = int(rng.integers(2, 7))
        vals = rng.integers(0, 1 << 30, (m, 7)).astype(np.int64)
        keys = np.arange(key, key + m, dtype=np.int64)
        key += m
        ops.append((("dll", "hm", "dll_del")[i % 3], keys, vals))
    return ops


def _apply(d, h, op, dll_ids):
    kind, keys, vals = op
    if kind == "hm":
        h.insert_batch(keys, vals)
    elif kind == "dll_del" and len(dll_ids) >= 2:
        doomed = np.asarray(dll_ids[::7][:2], np.int64)
        d.delete_batch(doomed)
        for x in doomed.tolist():
            dll_ids.remove(x)
    else:
        dll_ids.extend(_np(d.append_batch(vals)).tolist())


@pytest.mark.parametrize("tear", ["record", "all"])
def test_torn_snapshot_record_sweep(tear):
    """Crash mid-snapshot-append at EVERY commit boundary: the newest
    record lands garbled, or every record and half of each mirror.  Both
    packages recover equal state with equal stage detail."""
    ops = _script(12)
    for boundary in range(len(ops)):
        out = {}
        for pkg in PKG:
            a, d, h = _build(pkg, dll_cap=256)
            hm_keys, dll_ids = [], []
            for i in range(boundary + 1):
                _apply(d, h, ops[i], dll_ids)
                if ops[i][0] == "hm":
                    hm_keys.extend(ops[i][1].tolist())
                a.commit()
            want = _state(d, h, hm_keys)
            a.crash()
            a.reopen()
            _tear(d, h, tear)
            det = _reconstruct(pkg, d, h)
            got = _state(d, h, hm_keys)
            _assert_same(_logical(want), _logical(got))
            out[pkg] = (det, got)
        assert out["port"][0] == out["ref"][0]
        if tear == "all":
            assert out["port"][0][0].get("chain", "double") in (
                "double", "contract")
            assert out["port"][0][1]["chain"] == "rebuild"
        _assert_same(out["ref"][1], out["port"][1])


def test_suffix_replay_length_matches_delta():
    """Tear only the newest record: both packages seed from the previous
    record and replay exactly the rows committed after it."""
    for mode in MODES:
        dets = {}
        for pkg in PKG:
            a, d, h = _build(pkg, mode, dll_cap=256)
            d.append_batch(np.arange(280).reshape(40, 7).astype(np.int64))
            a.commit()
            k = np.arange(50, dtype=np.int64)
            h.insert_batch(k, np.tile(k[:, None], (1, 7)))
            a.commit()
            d.append_batch(np.ones((9, 7), np.int64))
            a.commit()
            h.insert_batch(k + 100, np.zeros((50, 7), np.int64))
            a.commit()
            keys = k.tolist() + (k + 100).tolist()
            want = _state(d, h, keys)
            a.crash()
            a.reopen()
            _tear(d, h, "record")
            dets[pkg] = _reconstruct(pkg, d, h)
            _assert_same(_logical(want), _logical(_state(d, h, keys)))
        assert dets["port"] == dets["ref"]
        assert dets["port"][0]["chain"] == "snapshot"
        assert dets["port"][0]["replayed"] == 9
        assert dets["port"][1]["chain"] == "snapshot"
        assert dets["port"][1]["replayed"] == 50


def test_clean_recovery_adopts_without_replay():
    dets = {}
    for pkg in PKG:
        a, d, h = _build(pkg)
        d.append_batch(np.arange(70).reshape(10, 7).astype(np.int64))
        k = np.arange(30, dtype=np.int64)
        h.insert_batch(k, np.tile(k[:, None], (1, 7)))
        a.commit()
        a.crash()
        a.reopen()
        dets[pkg] = _reconstruct(pkg, d, h)
    assert dets["port"] == dets["ref"]
    assert dets["port"][0] == {"mode": "partly", "count": 10,
                               "chain": "snapshot", "replayed": 0}
    assert dets["port"][1]["chain"] == "snapshot"
    assert dets["port"][1]["replayed"] == 0


def test_persisted_record_tear_survives_restart():
    """Tear the record at the PERSISTED layer and reconstruct through the
    structures' own reload."""
    dets = {}
    for pkg in PKG:
        a, d, h = _build(pkg)
        d.append_batch(np.arange(70).reshape(10, 7).astype(np.int64))
        a.commit()
        d.append_batch(np.ones((5, 7), np.int64))
        a.commit()
        want = _np(d.to_list()).copy()
        d.snaprec._pview()[max(_recs(d.snaprec))[1], 4:] = -777
        a.crash()
        a.reopen()
        dets[pkg] = TD._reconstruct_dll(d) if pkg == "port" \
            else RD._reconstruct_dll(d)
        np.testing.assert_array_equal(_np(d.to_list()), want)
    assert dets["port"] == dets["ref"]
    assert dets["port"]["chain"] == "snapshot"
    assert dets["port"]["replayed"] == 5


def test_snapshot_off_recovery_identical_states():
    """Recovered state is identical with snapshots on and off, in both
    packages: the snapshot is pure derivable redundancy."""
    states = {}
    for pkg in PKG:
        for snap in (True, False):
            a, d, h = _build(pkg, snapshot=snap, dll_cap=256)
            hm_keys, dll_ids = [], []
            for op in _script(8):
                _apply(d, h, op, dll_ids)
                if op[0] == "hm":
                    hm_keys.extend(op[1].tolist())
                a.commit()
            a.crash()
            a.reopen()
            _reconstruct(pkg, d, h)
            st = _state(d, h, hm_keys)
            for k in ("buckets", "chain", "n_buckets"):
                st.pop(k)        # the bucket basis differs by design
            states[pkg, snap] = st
    for key in states:
        _assert_same(states["ref", True], states[key])


@pytest.mark.parametrize("mode", MODES)
def test_torn_epoch_recovers_alike(mode):
    """A torn epoch after a commit: the data phase linked the last
    committed node onward to rows the header never counted.  The committed
    count bounds the verify (the host semantics), so both packages reach
    the same outcome, state and detail."""
    dets, states = {}, {}
    for pkg in PKG:
        a, d, h = _build(pkg, mode)
        d.append_batch(np.arange(84).reshape(12, 7).astype(np.int64))
        h.insert_batch(np.arange(20), np.ones((20, 7), np.int64))
        a.commit()
        with a.epoch():
            d.append_batch(np.ones((6, 7), np.int64))
            h.insert_batch(np.arange(20, 30), np.ones((10, 7), np.int64))
            a.writeset.flush(include_meta=False)
            a.crash()
        a.reopen()
        dets[pkg] = _reconstruct(pkg, d, h)
        states[pkg] = _state(d, h, list(range(20)))
        assert states[pkg]["order"].size == 12
    assert dets["port"] == dets["ref"]
    _assert_same(states["ref"], states["port"])


def test_chain_order_snapshot_matches_host_primitive():
    """chain_order(snapshot=) against the reference host primitive: a
    valid candidate, one whose tail links onward (the host adopts where
    the device variant would not), a short one, a wrong head, an
    out-of-range id and a broken link."""
    n = 300
    perm = np.random.default_rng(1).permutation(n)[:120]
    nxt = np.full(n, -1, np.int64)
    nxt[perm[:-1]] = perm[1:]
    head = int(perm[0])
    oob = perm.copy()
    oob[40] = n + 5
    broken = perm.copy()
    broken[5] = broken[6]
    cases = {"valid": (perm, 120), "prefix": (perm[:80], 80),
             "short": (perm[:119], 120), "head": (perm[1:], 119),
             "oob": (oob, 120), "broken": (broken, 120),
             "torn_2_32": (np.where(perm == perm[7], 2 ** 32 + perm[7],
                                    perm), 120)}
    outcomes = {}
    for name, (cand, count) in cases.items():
        rs, ts = R.ChainSnapshot(cand, 3), TR.ChainSnapshot(cand, 3)
        want = R.chain_order(nxt, head, count, snapshot=rs)
        got = TR.chain_order(torch.from_numpy(nxt), head, count,
                             snapshot=ts)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (ts.outcome, ts.replayed) == (rs.outcome, rs.replayed), name
        outcomes[name] = ts.outcome
    assert outcomes["valid"] == outcomes["prefix"] == "snapshot"
    assert all(outcomes[k] == "double" for k in
               ("short", "head", "oob", "broken", "torn_2_32"))


# ------------------------------------------------------ RecoveryManager

@pytest.mark.parametrize("concurrency", [1, 4])
def test_manager_orders_by_dependency_and_times_stages(concurrency):
    reports = {}
    for pkg in PKG:
        A, D, _, M = PKG[pkg]
        kw = {"device": "cpu"} if pkg == "port" else {}
        a = A.open_arena(None, D.DoublyLinkedList.layout(64, "partly"),
                         integrity=False, **kw)
        d = D.DoublyLinkedList(a, 64, "partly")
        d.append_batch(np.random.default_rng(0).integers(0, 9, (10, 7)))
        a.commit()
        a.crash()
        ran = []

        @(RREC if pkg == "ref" else TREC).register("test.probe")
        def _probe(tag):
            ran.append(tag)
            return {"tag": tag}

        mgr = M.RecoveryManager(a)
        # registered out of order: declared dependencies must win
        mgr.add("late", "test.probe", "late", depends=("dll", "early"))
        mgr.add("early", "test.probe", "early")
        mgr.add("dll", "pstruct.dll", d, depends=("early",))
        assert mgr.order() == ["early", "dll", "late"]
        assert mgr.levels() == [["early"], ["dll"], ["late"]]
        landed = []
        mgr.add_listener(lambda st: landed.append(st.name))
        report = mgr.recover(concurrency=concurrency)
        assert ran == ["early", "late"] and d.count == 10
        assert landed == ["reopen", "early", "dll", "late"]
        assert all(s.seconds >= 0 for s in report.stages)
        assert report.valid and report.generation == 1
        reports[pkg] = _strip(report)
    assert reports["port"] == reports["ref"]
    assert [s["name"] for s in reports["port"]["stages"]] == [
        "reopen", "early", "dll", "late"]


def test_manager_reports_committed_generation_across_processes(tmp_path):
    """The report's generation comes from the persisted header, so a
    recovery through fresh objects still names the committed generation."""
    out = {}
    for pkg in PKG:
        A, D, _, M = PKG[pkg]
        kw = {"device": "cpu"} if pkg == "port" else {}
        path = str(tmp_path / f"{pkg}.arena")
        layout = D.DoublyLinkedList.layout(32, "partly")
        a = A.open_arena(path, layout, integrity=False, **kw)
        d = D.DoublyLinkedList(a, 32, "partly")
        rng = np.random.default_rng(1)
        for _ in range(3):
            d.append_batch(rng.integers(0, 9, (2, 7)))
            a.commit()
        a.close()
        a2 = A.open_arena(path, layout, integrity=False, **kw)
        d2 = D.DoublyLinkedList(a2, 32, "partly")
        report = M.RecoveryManager(a2).add("dll", "pstruct.dll",
                                           d2).recover()
        assert report.valid and report.generation == 3
        assert a2.generation == 3 and d2.count == 6
        out[pkg] = _strip(report)
    assert out["port"] == out["ref"]


def test_manager_rejects_unknown_and_cyclic_dependencies():
    for M in (R, TR):
        mgr = M.RecoveryManager()
        with pytest.raises(KeyError):
            mgr.add("x", "no.such.reconstructor", None)
        mgr.add("a", "schedule", 0, depends=("b",))
        with pytest.raises(KeyError):
            mgr.order()                       # b unregistered
        mgr.add("b", "schedule", 0, depends=("a",))
        with pytest.raises(ValueError, match="cycle"):
            mgr.order()
        with pytest.raises(ValueError, match="already"):
            mgr.add("a", "schedule", 0)
    # salvage is ported: an empty manager salvages to the same empty report
    got, want = (M.RecoveryManager().recover(salvage=True) for M in (TR, R))
    assert (got.stages, got.quarantined, got.degraded) == \
        (want.stages, want.quarantined, want.degraded) == ([], [], [])


@pytest.mark.parametrize("concurrency", [1, 4])
def test_manager_reports_uncommitted_arena_invalid(concurrency):
    out = {}
    for pkg in PKG:
        A, D, _, M = PKG[pkg]
        kw = {"device": "cpu"} if pkg == "port" else {}
        a = A.open_arena(None, D.DoublyLinkedList.layout(32, "partly"),
                         integrity=False, **kw)
        d = D.DoublyLinkedList(a, 32, "partly")
        d.append_batch(np.random.default_rng(2).integers(0, 9, (4, 7)))
        a.crash()                              # commit() never ran
        report = M.RecoveryManager(a).add("dll", "pstruct.dll",
                                          d).recover(concurrency=concurrency)
        assert not report.valid and d.count == 4
        out[pkg] = _strip(report)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("concurrency", [1, 4])
def test_manager_stage_detail_reports_chain(concurrency):
    out = {}
    for pkg in PKG:
        a, d, h = _build(pkg)
        d.append_batch(np.arange(70).reshape(10, 7).astype(np.int64))
        k = np.arange(20, dtype=np.int64)
        h.insert_batch(k, np.tile(k[:, None], (1, 7)))
        a.commit()
        a.crash()
        mgr = PKG[pkg][3].RecoveryManager(a, a)      # deduped by identity
        mgr.add("dll", "pstruct.dll", d)
        mgr.add("hm", "pstruct.hashmap", h, depends=("dll",))
        report = mgr.recover(concurrency=concurrency)
        details = {s.name: s.detail for s in report.stages}
        assert details["dll"]["chain"] == details["hm"]["chain"] == \
            "snapshot"
        assert details["dll"]["replayed"] == details["hm"]["replayed"] == 0
        out[pkg] = _strip(report)
    assert out["port"] == out["ref"]


def test_manager_counter_scheduler_under_thread_stress():
    """More workers than cores and a tiny switch interval: every stage of
    a random DAG runs exactly once, after all of its dependencies ended,
    and the report keeps topological order."""
    import sys
    import threading
    rng = np.random.default_rng(4)
    names = [f"s{i}" for i in range(48)]
    deps = {n: [names[j] for j in rng.choice(i, min(i, 3), replace=False)]
            if i else [] for i, n in enumerate(names)}
    lock, ran = threading.Lock(), {}

    @TREC.register("test.stress")
    def _stage(tag):
        with lock:
            ran[tag] = ran.get(tag, 0) + 1
        return {"tag": tag}

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mgr = TR.RecoveryManager()
        for n in reversed(names):               # registration order != deps
            mgr.add(n, "test.stress", n, depends=deps[n])
        report = mgr.recover(concurrency=32)
    finally:
        sys.setswitchinterval(old)
    assert ran == {n: 1 for n in names}
    st = {s.name: s for s in report.stages}
    for n in names:
        for d in deps[n]:
            assert st[n].t_start >= st[d].t_end
    assert [s.name for s in report.stages] == mgr.order()


# ----------------------------------------------------- cross-recovery

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_recovery_adopts_snapshot(writer, mode, tmp_path):
    """An arena file written with snapshots on by one package recovers in
    the other through RecoveryManager by adopting the snapshot, to the
    same state the writer's own recovery reaches."""
    path = str(tmp_path / "x.arena")
    a, d, h = _build(writer, mode, path=path)
    ops = _Ops(5)
    for i in range(8):
        ops.step(d, h, i)
        a.commit()
    a.close()
    out = {}
    for pkg in (writer, "port" if writer == "ref" else "ref"):
        a2, d2, h2 = _build(pkg, mode, path=path)
        mgr = PKG[pkg][3].RecoveryManager(a2)
        mgr.add("dll", "pstruct.dll", d2)
        mgr.add("hm", "pstruct.hashmap", h2)
        report = mgr.recover()
        for name in ("dll", "hm"):
            assert report.stage(name).detail["chain"] == "snapshot"
        out[pkg] = (_strip(report), _state(d2, h2, ops.keys))
        np.testing.assert_array_equal(out[pkg][1]["order"],
                                      np.asarray(ops.ids))
        a2.close()
    assert out["port"][0] == out["ref"][0]
    _assert_same(out["ref"][1], out["port"][1])


# --------------------------------------------------------- entry point

def test_snapshot_recovery_entry_point_matches_example(capsys, monkeypatch):
    base = 3000
    snapshot_recovery.main(["--device", "cpu", "--base", str(base)])
    port = re.findall(r"chain=(\w+) replayed=(\d+) \(of (\d+)",
                      capsys.readouterr().out)
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    example = Path(__file__).resolve().parents[1] / "examples" / \
        "snapshot_recovery.py"
    spec = importlib.util.spec_from_file_location("snap_example", example)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ref.BASE = base
    ref.main()
    want = re.findall(r"chain=(\w+) replayed=(\d+) \(of (\d+)",
                      capsys.readouterr().out)
    assert len(port) == 3 and port == want
    assert port[0][:2] == ("snapshot", "0")
    assert port[1][:2] == ("snapshot", str(snapshot_recovery.SUFFIX))
