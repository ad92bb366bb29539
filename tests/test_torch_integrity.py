"""repro_torch integrity sidecars, scrub, fault injection and salvage
recovery (DESIGN.md §13), on the CPU against the JAX package's reference.

Every barrier / one-arena cell of ``tests/test_integrity.py`` runs through
both packages with the same operations and the same faults, and the port
must give the reference's results exactly: byte-identical images, the
``.integ`` sidecars included; equal ``FlushStats`` (``integrity_lines``
included); the same rows named by ``scrub``; the same recovered state and
the same salvage reports (stage details, ``quarantined``/``degraded``,
quarantined keys and rids), timing fields aside.  Also: the checksum
helpers over random words, interop of integrity images both ways,
``CheckpointCatalog``, the public methods this slice ports, and the
port's kernel-path DLL salvage prefix (``salvage_prefix``) against the
reference's scalar walk on random chains.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import arena as RA
from repro.core import faultinject as RF
from repro.core import recovery as RR
from repro.pstruct import bptree as RB
from repro.pstruct import dll as RD
from repro.pstruct import hashmap as RH
from repro_torch.core import arena as TA
from repro_torch.core import faultinject as TF
from repro_torch.core import recovery as TR
from repro_torch.interop import arena_from_image, image_of
from repro_torch.pstruct import bptree as TB
from repro_torch.pstruct import dll as TD
from repro_torch.pstruct import hashmap as TH

PKG = {"ref": (RA, RF, RR, RD, RB, RH), "port": (TA, TF, TR, TD, TB, TH)}
TIMING = {"seconds", "t_start", "t_end", "ready_at", "queue_wait",
          "first_admission_s", "last_admission_s"}


@pytest.fixture(autouse=True)
def _integrity_default(monkeypatch):
    # integrity resolves on by default in both packages
    monkeypatch.delenv("REPRO_INTEGRITY", raising=False)
    monkeypatch.delenv("REPRO_PAGED", raising=False)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------- helpers

def _layout(pkg, mode="partly"):
    _, _, _, D, B, H = PKG[pkg]
    layout = {}
    layout.update(D.DoublyLinkedList.layout(256, mode, name="dll"))
    layout.update(B.BPTree.layout(256, 1024, mode, name="bt"))
    layout.update(H.Hashmap.layout(512, mode, name="hm"))
    return layout


def _mixed(pkg, path=None, mode="partly", **kw):
    A, _, _, D, B, H = PKG[pkg]
    if pkg == "port":
        kw["device"] = "cpu"
    a = A.open_arena(path, _layout(pkg, mode), **kw)
    return (a, D.DoublyLinkedList(a, 256, mode, name="dll"),
            B.BPTree(a, 256, 1024, mode, name="bt"),
            H.Hashmap(a, 512, mode, name="hm"))


def _script(n_ops, seed=0):
    rng = np.random.default_rng(seed)
    ops, key = [], 0
    for i in range(n_ops):
        m = int(rng.integers(2, 7))
        vals = rng.integers(0, 1 << 30, (m, 7)).astype(np.int64)
        keys = np.arange(key, key + m, dtype=np.int64)
        key += m
        ops.append(("dll" if i % 3 == 0 else ("bt" if i % 3 == 1 else "hm"),
                    keys, vals))
    return ops


def _apply(d, t, h, op):
    kind, keys, vals = op
    if kind == "dll":
        d.append_batch(vals)
    elif kind == "bt":
        t.insert_batch(keys, vals)
    else:
        h.insert_batch(keys, vals)


def _run(a, d, t, h, ops):
    for op in ops:
        with a.epoch():
            _apply(d, t, h, op)
        a.commit()


def _manager(pkg, a, d, t, h):
    mgr = PKG[pkg][2].RecoveryManager(a)
    mgr.add("dll", "pstruct.dll", d)
    mgr.add("bt", "pstruct.bptree", t)
    mgr.add("hm", "pstruct.hashmap", h)
    return mgr


def _fingerprint(d, t, h):
    """Logical state of the three structures, and their quarantine sets."""
    fp = {"dll": _host(d.to_list()).tolist(),
          "dll.order": _host(d.order()).tolist(),
          "bt.keys": _host(t.keys_in_order()).tolist(),
          "bt.quarantined": sorted(t.quarantined),
          "hm.quarantined": sorted(h.quarantined)}
    fresh = int(_host(h.header.vol)[0, 2])
    ks = _host(h.keys)[:fresh]
    vs = _host(h.values)[:fresh]
    live = ks != TH.KEY_NULL
    o = np.argsort(ks[live], kind="stable")
    fp["hm.keys"] = ks[live][o].tolist()
    fp["hm.values"] = vs[live][o].tolist()
    return fp


def _report(rep):
    return {"valid": rep.valid, "generation": rep.generation,
            "quarantined": list(rep.quarantined),
            "degraded": list(rep.degraded),
            "stages": [(s.name, s.quarantined, s.degraded,
                        {k: v for k, v in s.detail.items()
                         if k not in TIMING}) for s in rep.stages]}


def _scrub(a):
    return {k: v.tolist() for k, v in a.scrub().items()}


def _image(a):
    """Every persistent byte: a plain arena's image, or each shard's image
    and the manifest of a sharded one."""
    if hasattr(a, "shards"):
        return b"".join([bytes(np.asarray(sh._mm)) for sh in a.shards]
                        + [bytes(np.asarray(a._man))])
    return bytes(np.asarray(a._mm))


def _stats(a):
    return dataclasses.asdict(a.stats)


# ------------------------------------------------------ checksum helpers

words = st.lists(st.integers(-(1 << 63), (1 << 63) - 1), min_size=8,
                 max_size=8 * 12)


@settings(max_examples=60, deadline=None)
@given(w=words, chunks=st.sampled_from([1, 2, 4]))
def test_checksum_helpers_match_reference(w, chunks):
    per = 8 * chunks
    m = len(w) // per
    if m == 0:
        return
    arr = np.asarray(w[:m * per], np.int64).reshape(m, per)
    got = TA.sidecar_checksums(arr, chunks)
    want = RA.sidecar_checksums(arr, chunks)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert (got != 0).all()
    np.testing.assert_array_equal(TA.mix_checksums(arr[:, :7]),
                                  RA.mix_checksums(arr[:, :7]))
    assert TA._integ_chunks(per * 8) == RA._integ_chunks(per * 8) == chunks


@pytest.mark.parametrize("rowbytes", [8, 16, 24, 32, 64, 128, 256])
def test_checksum_zero_is_reserved_sentinel(rowbytes):
    z = np.zeros((4, rowbytes // 8), np.int64)
    chunks = TA._integ_chunks(rowbytes)
    assert chunks == RA._integ_chunks(rowbytes)
    got = TA.sidecar_checksums(z, chunks)
    assert (got != 0).all()
    np.testing.assert_array_equal(got, RA.sidecar_checksums(z, chunks))


# ----------------------------------------------------------------- layout

@pytest.mark.parametrize("mode", ["partly", "full"])
def test_integrity_on_layout_and_meta(tmp_path, mode):
    arenas = {pkg: _mixed(pkg, str(tmp_path / f"{pkg}.pm"), mode)[0]
              for pkg in PKG}
    port, ref = arenas["port"], arenas["ref"]
    assert port.integrity and ref.integrity
    assert list(port.regions) == list(ref.regions)
    assert port._meta == ref._meta
    assert (tmp_path / "port.pm.layout").read_text() == \
        (tmp_path / "ref.pm.layout").read_text()
    for name, r in ref.regions.items():
        p = port.regions[name]
        assert (p.integ, p.offset, p.rowbytes) == (r.integ, r.offset,
                                                   r.rowbytes)
        assert (p._integ is None) == (r._integ is None)
        if r._integ is not None:
            assert p._integ.name == r._integ.name
            assert tuple(p._integ.shape) == tuple(r._integ.shape)
    assert _image(port) == _image(ref)


def test_integrity_off_layout_and_bytes_are_unchanged(tmp_path):
    """Integrity off lays out exactly the integrity-free image (the
    sidecars are a pure suffix), with the reference's bytes."""
    ops = _script(10, seed=3)
    out = {}
    for pkg in PKG:
        for integ in (False, True):
            a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}{integ}.pm"),
                                integrity=integ)
            _run(a, d, t, h, ops)
            out[pkg, integ] = a
    for pkg in PKG:
        off, on = out[pkg, False], out[pkg, True]
        assert {n: r.offset for n, r in off.regions.items()} == \
            {n: r.offset for n, r in on.regions.items() if not r.integ}
        assert not any(r.integ for r in off.regions.values())
        for n, r in off.regions.items():
            np.testing.assert_array_equal(on._pimage(on.regions[n]),
                                          off._pimage(r), err_msg=n)
        assert off.stats.integrity_lines == 0 < on.stats.integrity_lines
        assert on.stats.lines == off.stats.lines
    for integ in (False, True):
        assert _image(out["port", integ]) == _image(out["ref", integ])
        assert _stats(out["port", integ]) == _stats(out["ref", integ])


@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("seed", [0, 1])
def test_images_and_flushstats_match_reference(tmp_path, mode, seed):
    """The same script gives the same bytes, sidecars included, and the
    same FlushStats after every commit, and the same recovery."""
    built = {pkg: _mixed(pkg, str(tmp_path / f"{pkg}.pm"), mode)
             for pkg in PKG}
    for op in _script(24, seed=seed):
        for a, d, t, h in built.values():
            with a.epoch():
                _apply(d, t, h, op)
            a.commit()
        (pa, *_), (ra, *_) = built["port"], built["ref"]
        assert _stats(pa) == _stats(ra)
        assert _image(pa) == _image(ra)
    # deletes and a pop rewrite committed rows and their checksums
    for a, d, t, h in built.values():
        d.pop_front_batch(3)
        t.delete_batch(np.arange(5, 12, dtype=np.int64))
        h.remove_batch(np.arange(20, 40, dtype=np.int64))
        a.commit()
    (pa, *_), (ra, *_) = built["port"], built["ref"]
    assert _stats(pa) == _stats(ra) and _image(pa) == _image(ra)
    assert pa.stats.integrity_lines > 0
    reps = {}
    for pkg, (a, d, t, h) in built.items():
        a.crash()
        reps[pkg] = (_report(_manager(pkg, a, d, t, h).recover()),
                     _fingerprint(d, t, h), _scrub(a))
    assert reps["port"] == reps["ref"]
    # the sidecars' volatile tensors hold the persistent checksums
    for r in pa.regions.values():
        if r.integ:
            np.testing.assert_array_equal(_host(r.vol), r._pview())


def test_sidecar_volatile_copy_tracks_each_drain():
    a, d, t, h = _mixed("port")
    for op in _script(9, seed=4):
        with a.epoch():
            _apply(d, t, h, op)
        for r in a.regions.values():
            if r.integ:
                np.testing.assert_array_equal(_host(r.vol), r._pview(),
                                              err_msg=r.name)


# -------------------------------------------------------------- detection

@pytest.mark.parametrize("target", [("dll.nodes", 2, "order"),
                                    ("bt.nodes", 0, "leaves"),
                                    ("hm.entries", 3, None),
                                    ("bt.records", 4, None)])
def test_scrub_names_flip_and_stuck_line(tmp_path, target):
    _scrub_names(tmp_path, target, n_shards=1)


@pytest.mark.parametrize("target", [("dll.nodes", 2, "order"),
                                    ("bt.nodes", 0, "leaves"),
                                    ("hm.entries", 3, None),
                                    ("bt.records", 4, None)])
def test_scrub_names_flip_and_stuck_line_sharded(tmp_path, target):
    """The ("barrier", 4) cell: a row's fault lands in its own shard."""
    _scrub_names(tmp_path, target, n_shards=4)


def _scrub_names(tmp_path, target, **kw):
    reg, idx, how = target
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}.pm"), **kw)
        _run(a, d, t, h, _script(12, seed=1))
        row = idx if how is None else int(_host(
            d.order() if how == "order" else t.leaves())[idx])
        a.crash()
        F = PKG[pkg][1]
        off = F.flip_bits(a, a.regions[reg], row, byte=8, mask=0x01)
        a.reopen()
        first = _scrub(a)
        assert list(first) == [reg] and row in first[reg]
        F.flip_bits(a, a.regions[reg], row, byte=8, mask=0x01)   # undo
        assert _scrub(a) == {}, "flip_bits is not an involution"
        lo_hi = F.stuck_line(a, a.regions["hm.entries"], 2, line=0,
                             value=0xAB)
        second = _scrub(a)
        with pytest.raises(PKG[pkg][0].CorruptLineError) as ei:
            a.scrub(raise_on_error=True)
        out[pkg] = (row, off, first, lo_hi, second, str(ei.value),
                    F.committed_row_offset(a, reg, row)[1:], _image(a))
    assert out["port"] == out["ref"]


def test_scrub_under_traffic_no_false_positives(tmp_path):
    """Data and sidecar move in the same flush phase, so a scrub between
    any two commits, and after a crash, comes back clean."""
    _scrub_under_traffic(tmp_path, n_shards=1)


def test_scrub_under_traffic_no_false_positives_sharded(tmp_path):
    _scrub_under_traffic(tmp_path, n_shards=4)


def _scrub_under_traffic(tmp_path, **kw):
    a, d, t, h = _mixed("port", str(tmp_path / "a.pm"), **kw)
    for i, op in enumerate(_script(10, seed=4)):
        with a.epoch():
            _apply(d, t, h, op)
            assert a.scrub() == {}, f"false positive inside epoch {i}"
        a.commit()
        assert a.scrub() == {}, f"false positive after commit {i}"
    a.crash()
    _manager("port", a, d, t, h).recover()
    assert a.scrub() == {}


def test_mid_scrub_crash_is_harmless(tmp_path):
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}.pm"))
        _run(a, d, t, h, _script(8, seed=5))
        covered = [n for n, r in a.regions.items() if r._integ is not None]
        assert len(covered) >= 2
        for n in covered[: len(covered) // 2]:     # half a scrub...
            assert a.verify_region(n).size == 0
        a.crash()                                  # ...then power loss
        rep = _manager(pkg, a, d, t, h).recover()
        assert rep.valid and a.scrub() == {}
        out[pkg] = (covered, _report(rep), _fingerprint(d, t, h))
    assert out["port"] == out["ref"]


TARGETS = [("dll.nodes", 1), ("bt.nodes", 0), ("hm.entries", 0),
           ("dll.nodes", 200), ("hm.entries", 400)]


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("boundary", [3, 7])
def test_corruption_crash_double_failure(tmp_path, torn, boundary):
    """A crash (power loss or torn data phase) composed with a one-byte
    fault: the port must be detected-or-harmless as the reference is, and
    give the reference's reports and state for every target."""
    _double_failure(tmp_path, torn, boundary, n_shards=1)


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("boundary", [3, 7])
def test_corruption_crash_double_failure_sharded(tmp_path, torn, boundary):
    _double_failure(tmp_path, torn, boundary, n_shards=4)


def _double_failure(tmp_path, torn, boundary, **kw):
    ops = _script(8, seed=6)
    stage_of = {"dll.nodes": "dll", "bt.nodes": "bt", "hm.entries": "hm"}

    def crash(a, d, t, h):
        _run(a, d, t, h, ops[: boundary + 1])
        if boundary + 1 < len(ops):
            with a.epoch():
                _apply(d, t, h, ops[boundary + 1])
                if torn:
                    a.writeset.flush(include_meta=False)
                a.crash()
        else:
            a.crash()

    twin = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / f"tw{pkg}.pm"), **kw)
        crash(a, d, t, h)
        _manager(pkg, a, d, t, h).recover()
        twin[pkg] = _fingerprint(d, t, h)
    assert twin["port"] == twin["ref"]
    for j, (reg, row) in enumerate(TARGETS):
        got = {}
        for pkg in PKG:
            b, d2, t2, h2 = _mixed(pkg, str(tmp_path / f"b{pkg}{j}.pm"),
                                   **kw)
            crash(b, d2, t2, h2)
            PKG[pkg][1].flip_bits(b, b.regions[reg], row, byte=3, mask=0x80)
            rep = _manager(pkg, b, d2, t2, h2).recover(salvage=True)
            got[pkg] = (_report(rep), _fingerprint(d2, t2, h2), _scrub(b),
                        _image(b))
        assert got["port"] == got["ref"], (reg, row)
        rep, fp, bad, _ = got["port"]
        named = set(rep["quarantined"]) | set(rep["degraded"])
        if named:                                  # detected
            assert named == {stage_of[reg]}, (reg, row, named)
            assert reg in bad and row in bad[reg]
        else:                                      # or harmless
            assert fp == twin["port"] and bad == {}


# ------------------------------------------------------ typed media losses

@pytest.mark.parametrize("nbytes", [0, 64, -4096])
def test_shard_loss_on_truncated_file(tmp_path, nbytes):
    """A backing file shorter than its layout is media loss, raised before
    it is mapped (mapping would re-extend it with zeros); a removed file is
    a fresh arena, in both packages."""
    path = str(tmp_path / "s.pm")
    a, d, t, h = _mixed("port", path)
    _run(a, d, t, h, _script(8, seed=7))
    size = os.path.getsize(path)
    a.close()
    cut = nbytes if nbytes >= 0 else size + nbytes
    assert TF.truncate_shard(a, 0, cut) == path
    for pkg, A in (("port", TA), ("ref", RA)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        with pytest.raises(A.ShardLossError, match="truncated"):
            A.open_arena(path, _layout(pkg), **kw)
        assert os.path.getsize(path) == cut      # nothing re-extended it
    assert TF.remove_shard(a) == path and not os.path.exists(path)
    for pkg, A in (("port", TA), ("ref", RA)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        assert A.open_arena(path, _layout(pkg), **kw).header_generation() \
            == 0
        os.remove(path)


@pytest.mark.parametrize("salvage", [False, True])
def test_manifest_error_on_corrupt_header(tmp_path, salvage):
    for pkg in PKG:
        A, F = PKG[pkg][:2]
        a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}.pm"))
        _run(a, d, t, h, _script(6, seed=8))
        a.crash()
        F.corrupt_header(a)
        with pytest.raises(A.ManifestError):
            a.verify_header()
        # garbage magic is fatal even under salvage
        with pytest.raises(A.ManifestError):
            _manager(pkg, a, d, t, h).recover(salvage=salvage)
        assert not getattr(a, "_salvage", False)
        for cls in (A.ManifestError, A.CorruptLineError, A.ShardLossError):
            assert issubclass(cls, A.IntegrityError)
    with pytest.raises(ValueError, match="sharded"):
        TF.corrupt_manifest(a)        # a plain arena has no manifest


def test_shard_loss_errors(tmp_path):
    """A four-shard arena: a truncated or removed shard file raises
    ShardLossError from the manifest's check, in both packages."""
    for pkg, (A, F, *_) in PKG.items():
        path = str(tmp_path / f"{pkg}.pm")
        a, d, t, h = _mixed(pkg, path, n_shards=4)
        _run(a, d, t, h, _script(8, seed=7))
        a.close()
        kw = {"device": "cpu"} if pkg == "port" else {}
        assert F.truncate_shard(path, shard=2, nbytes=64) == path + ".s2"
        with pytest.raises(A.ShardLossError):
            A.open_arena(path, _layout(pkg), n_shards=4, **kw)
        assert F.remove_shard(path, shard=2) == path + ".s2"
        with pytest.raises(A.ShardLossError, match="shard 2"):
            A.open_arena(path, _layout(pkg), n_shards=4, **kw)


@pytest.mark.parametrize("salvage", [False, True])
def test_manifest_errors_sharded(tmp_path, salvage):
    """The reference's ``test_manifest_errors[4]``: a scribbled manifest
    magic is fatal, salvage or not; so is one shard's scribbled header."""
    for pkg in PKG:
        A, F = PKG[pkg][:2]
        a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}.pm"), n_shards=4)
        _run(a, d, t, h, _script(6, seed=8))
        a.crash()
        F.corrupt_manifest(a)
        with pytest.raises(A.ManifestError, match="manifest"):
            a.verify_header()
        with pytest.raises(A.ManifestError):
            _manager(pkg, a, d, t, h).recover(salvage=salvage)
        assert not getattr(a, "_salvage", False)
        b, *rest = _mixed(pkg, str(tmp_path / f"{pkg}2.pm"), n_shards=4)
        _run(b, *rest, _script(6, seed=8))
        F.corrupt_header(b, shard=3)
        with pytest.raises(A.ManifestError, match="header"):
            b.verify_header()


# ----------------------------------------------------------------- salvage

@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("victim", ["dll", "bt", "hm"])
def test_mixed_salvage_matches_reference(tmp_path, mode, victim):
    """One corrupted slab of a mixed arena: the port quarantines or
    degrades exactly what the reference does, recovers the same state and
    names the same keys; the other structures recover exactly."""
    _mixed_salvage(tmp_path, mode, victim, n_shards=1)


@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("victim", ["dll", "bt", "hm"])
def test_mixed_salvage_matches_reference_sharded(tmp_path, mode, victim):
    _mixed_salvage(tmp_path, mode, victim, n_shards=4)


def _mixed_salvage(tmp_path, mode, victim, **kw):
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}.pm"), mode, **kw)
        _run(a, d, t, h, _script(30, seed=9))
        before = _fingerprint(d, t, h)
        leaves = _host(t.leaves())
        a.crash()
        reg = {"dll": "dll.nodes", "bt": "bt.nodes",
               "hm": "hm.entries"}[victim]
        row = {"dll": before["dll.order"][1], "bt": int(leaves[1]),
               "hm": 3}[victim]
        PKG[pkg][1].flip_bits(a, a.regions[reg], row, byte=8, mask=0x40)
        rep = _manager(pkg, a, d, t, h).recover(salvage=True)
        after = _fingerprint(d, t, h)
        out[pkg] = (_report(rep), after, _scrub(a), _image(a),
                    _stats(a))
        # the other two structures recover exactly
        for other, keys in (("dll", ("dll", "dll.order")),
                            ("bt", ("bt.keys",)),
                            ("hm", ("hm.keys", "hm.values"))):
            if other != victim:
                assert all(after[k] == before[k] for k in keys), other
                assert other not in rep.quarantined + rep.degraded
        assert victim in rep.quarantined + rep.degraded
        if victim == "dll":
            got = after["dll.order"]
            assert got == before["dll.order"][:len(got)]
        elif victim == "bt" and mode == "partly":
            assert set(after["bt.keys"]) <= set(before["bt.keys"])
            assert set(after["bt.quarantined"]).isdisjoint(after["bt.keys"])
        elif victim == "hm":
            assert after["hm.quarantined"]
    assert out["port"] == out["ref"]


def test_full_mode_tree_quarantines_wholesale(tmp_path):
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}.pm"), "full")
        _run(a, d, t, h, _script(30, seed=10))
        order = _host(d.order()).tolist()
        leaf = int(_host(t.leaves())[0])
        a.crash()
        PKG[pkg][1].flip_bits(a, a.regions["bt.nodes"], leaf, byte=8,
                              mask=0x40)
        rep = _manager(pkg, a, d, t, h).recover(salvage=True)
        assert rep.quarantined == ["bt"]
        assert _host(d.order()).tolist() == order
        st_bt = rep.stage("bt")
        assert st_bt.detail["error"] == "CorruptLineError"
        out[pkg] = _report(rep)
    assert out["port"] == out["ref"]


def test_salvage_off_aborts_nothing_silently(tmp_path):
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}.pm"))
        _run(a, d, t, h, _script(12, seed=11))
        row = int(_host(d.order())[1])
        a.crash()
        PKG[pkg][1].flip_bits(a, a.regions["dll.nodes"], row, byte=8,
                              mask=0x40)
        rep = _manager(pkg, a, d, t, h).recover()   # no verify
        bad = _scrub(a)                              # ...but scrub names it
        assert "dll.nodes" in bad and row in bad["dll.nodes"]
        assert rep.quarantined == rep.degraded == []
        out[pkg] = (_report(rep), bad, _fingerprint(d, t, h))
    assert out["port"] == out["ref"]


def test_quarantined_dependents_skip(tmp_path):
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}.pm"), "full")
        _run(a, d, t, h, _script(12, seed=12))
        leaf = int(_host(t.leaves())[0])
        a.crash()
        PKG[pkg][1].flip_bits(a, a.regions["bt.nodes"], leaf, byte=8,
                              mask=0x40)
        mgr = PKG[pkg][2].RecoveryManager(a)
        mgr.add("bt", "pstruct.bptree", t)
        mgr.add("dll", "pstruct.dll", d, depends=("bt",))
        mgr.add("hm", "pstruct.hashmap", h, depends=("dll",))
        rep = mgr.recover(salvage=True, concurrency=2)
        st_ = {s.name: s for s in rep.stages}
        assert st_["bt"].quarantined and st_["dll"].degraded
        assert st_["dll"].detail["skipped"] == "quarantined dependency"
        assert st_["hm"].detail["tainted_deps"] == ["dll"]
        assert rep.quarantined == ["bt"] and rep.degraded == ["dll", "hm"]
        out[pkg] = _report(rep)
    assert out["port"] == out["ref"]


def test_dll_salvage_quarantines_an_empty_prefix(tmp_path):
    """A corrupt head leaves no prefix: the stage quarantines, its rows
    stay out of the free list, and appends after recovery match."""
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}.pm"))
        _run(a, d, t, h, _script(12, seed=13))
        head = d.head
        a.crash()
        PKG[pkg][1].flip_bits(a, a.regions["dll.nodes"], head, byte=0)
        rep = _manager(pkg, a, d, t, h).recover(salvage=True)
        assert rep.quarantined == ["dll"]
        d.append_batch(np.full((3, 7), 5, np.int64))
        a.commit()
        out[pkg] = (_report(rep), _fingerprint(d, t, h), list(d._free),
                    _image(a))
    assert head not in out["port"][2]
    assert out["port"] == out["ref"]


# ------------------------------------------------------ serving quarantine

def _stores(tmp_path):
    from repro.serve.feature_store import FeatureConfig as JC
    from repro.serve.feature_store import FeatureStore as JS
    from repro_torch.serve.feature_store import FeatureConfig as TC
    from repro_torch.serve.feature_store import FeatureStore as TS
    kw = dict(n_keys=64, dim=3, n_samples=256)
    return {"ref": JS(JC(**kw), str(tmp_path / "ref.fs")),
            "port": TS(TC(**kw), str(tmp_path / "port.fs"), device="cpu")}


@pytest.mark.parametrize("case", ["table_value_word", "log_record"])
def test_feature_store_refuses_only_quarantined_keys(tmp_path, case):
    stores = _stores(tmp_path)
    out = {}
    for pkg, fs in stores.items():
        A, F = PKG[pkg][:2]
        rng = np.random.default_rng(13)
        for rid in range(8):
            fs.apply(rid, np.array([rid * 3, rid * 3 + 1], np.int64),
                     rng.integers(0, 100, (2, 3)))
        keep = _host(fs.lookup(np.array([3], np.int64))).copy()
        fs.crash()
        if case == "table_value_word":
            slot = int(_host(fs.table._find_slots(
                torch.tensor([0]) if pkg == "port" else
                np.array([0], np.int64)))[0])
            F.flip_bits(fs.arena, fs.arena.regions["emb.entries"], slot,
                        byte=16, mask=0x20)    # a VALUE word: key readable
        else:
            F.flip_bits(fs.arena, fs.arena.regions["sx.records"], 4,
                        byte=24, mask=0x08)
        rep = fs.recover(salvage=True)
        lost = sorted(fs.quarantined_keys)
        assert lost
        with pytest.raises(A.QuarantinedError):
            fs.lookup(np.array(lost[:1], np.int64))
        with pytest.raises(A.QuarantinedError):
            fs.apply(99, np.array(lost[:1], np.int64),
                     np.zeros((1, 3), np.int64))
        if case == "table_value_word":
            assert 0 in lost
            np.testing.assert_array_equal(
                _host(fs.lookup(np.array([3], np.int64))), keep)
        ok = np.array([k for k in range(24) if k not in lost], np.int64)
        vals = _host(fs.lookup(ok)).tolist()
        fs.readmit(lost)
        assert not fs.quarantined_keys
        fs.lookup(np.array(lost, np.int64))    # a fresh start, no raise
        assert fs.apply(100, np.array(lost[:1], np.int64),
                        np.ones((1, 3), np.int64))
        out[pkg] = (_report(rep), lost, vals,
                    _host(fs.lookup(np.arange(30))).tolist(),
                    _image(fs.arena), _stats(fs.arena))
    assert out["port"] == out["ref"]


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


@pytest.mark.parametrize("region,row,byte", [("tokens", 0, 4),
                                              ("req.entries", None, 16)])
def test_engine_rejects_only_quarantined_rids(models, tmp_path, region,
                                              row, byte):
    from repro.serve import engine as RE
    from repro_torch.serve import engine as TE
    jm, jp, tm, tp = models
    kw = dict(max_batch=3, s_max=16, max_requests=16)
    engines = {"ref": RE.ServingEngine(jm, jp, RE.EngineConfig(**kw),
                                       arena_path=str(tmp_path / "ref")),
               "port": TE.ServingEngine(tm, tp, TE.EngineConfig(**kw),
                                        arena_path=str(tmp_path / "port"),
                                        device="cpu")}
    out = {}
    for pkg, eng in engines.items():
        A, F = PKG[pkg][:2]
        eng.add_request(7, np.array([1, 2, 3], np.int64))
        eng.add_request(8, np.array([4, 5, 6, 9, 2], np.int64))
        eng.step()
        r = row
        if r is None:                          # rid 7's table entry
            keys = _host(eng.table.keys)
            r = int(np.nonzero(keys == 7)[0][0])
        eng.crash()
        F.flip_bits(eng.arena, eng.arena.regions[region], r, byte=byte,
                    mask=0x10)
        eng.recover(salvage=True)
        assert eng.quarantined_rids == {7}
        st_ = eng.last_recovery.stage("engine")
        if region == "tokens":
            assert st_.degraded and st_.detail["quarantined_rids"] == [7]
        steps = [eng.step() for _ in range(2)]
        assert all(8 in s and 7 not in s for s in steps)
        with pytest.raises(A.QuarantinedError):
            eng.add_request(7, np.array([1, 2, 3], np.int64))
        eng.add_request(9, np.array([2, 2], np.int64))  # others admit
        eng.readmit([7])
        assert eng.quarantined_rids == set()
        out[pkg] = (_report(eng.last_recovery), steps, eng.step(),
                    eng.journal.state_of(7), _stats(eng.arena),
                    (tmp_path / pkg).read_bytes())
    assert out["port"] == out["ref"]


# ------------------------------------------------------------------ interop

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_interop_with_sidecars_both_ways(tmp_path, writer):
    """An integrity arena written by either package recovers in the other
    to the same state and the same scrub result, by file and, for the
    reference's in-memory arenas, through ``arena_from_image``."""
    reader = "port" if writer == "ref" else "ref"
    path = str(tmp_path / "a.pm")
    a, d, t, h = _mixed(writer, path)
    _run(a, d, t, h, _script(15, seed=14))
    row = int(_host(d.order())[4])
    want = _fingerprint(d, t, h)
    a.crash()
    PKG[writer][1].flip_bits(a, a.regions["dll.nodes"], row, byte=8)
    bad = _scrub(a)
    a.close()
    out = {}
    for pkg in (writer, reader):
        b, d2, t2, h2 = _mixed(pkg, path)
        assert _scrub(b) == bad
        rep = _manager(pkg, b, d2, t2, h2).recover(salvage=True)
        out[pkg] = (_report(rep), _fingerprint(d2, t2, h2), _scrub(b))
        b.close()
    assert out["port"] == out["ref"]
    assert out["port"][1]["bt.keys"] == want["bt.keys"]
    if writer == "ref":
        ra, rd, rt, rh = _mixed("ref", None)
        _run(ra, rd, rt, rh, _script(15, seed=14))
        pa = arena_from_image(np.array(ra._mm), ra._meta, "cpu")
        assert pa.integrity and pa._meta == ra._meta
        assert image_of(pa).tobytes() == _image(ra)
        assert _scrub(pa) == _scrub(ra) == {}
        pa.regions["dll.nodes"]._pview()[row, 0] ^= 4
        ra.regions["dll.nodes"]._pview()[row, 0] ^= 4
        assert _scrub(pa) == _scrub(ra) == {"dll.nodes": [row]}


# ------------------------------------------------------------------ catalog

@pytest.mark.parametrize("steps", [(10, 20, 30), tuple(range(5, 400, 7))])
def test_catalog_matches_reference(tmp_path, steps):
    from repro.ckpt import CheckpointCatalog as RC
    from repro_torch.ckpt import CheckpointCatalog as TC
    out = {}
    for pkg, C in (("ref", RC), ("port", TC)):
        path = str(tmp_path / f"{pkg}.cat")
        kw = {"device": "cpu"} if pkg == "port" else {}
        cat = C(path, **kw)
        assert cat.arena.integrity
        for s in steps:
            cat.record(s, s // 10, 1000 * s, 5)
        first = (cat.latest(), _host(cat.steps()).tolist())
        cat.arena.crash()
        cat2 = C(path, **kw)
        assert cat2.last_recovery is not None
        out[pkg] = (first, cat2.latest(), _host(cat2.steps()).tolist(),
                    _report(cat2.last_recovery),
                    (tmp_path / f"{pkg}.cat").read_bytes(),
                    _stats(cat.arena))
    assert out["port"] == out["ref"]
    assert out["port"][2] == list(steps)
    assert out["port"][1][0] == steps[-1]


# ---------------------------------------------------- newly public methods

def test_public_methods_match_reference(tmp_path):
    out = {}
    for pkg in PKG:
        A, _, R, D, B, H = PKG[pkg]
        a, d, t, h = _mixed(pkg)
        assert t.max_key() is None
        assert _host(t.keys_in_order()).tolist() == []
        _run(a, d, t, h, _script(15, seed=15))
        t.delete_batch(np.arange(3, 9, dtype=np.int64))
        a.commit()
        ref = {int(k): _host(v).tolist() for k, v in zip(
            *(_host(x) for x in (h.keys[:int(_host(h.header.vol)[0, 2])],
                                 h.values[:int(_host(h.header.vol)[0, 2])]))
            ) if k != H.KEY_NULL}
        ref = {k: np.asarray(v, np.int64) for k, v in ref.items()}
        wrong = dict(ref)
        wrong[next(iter(wrong))] = np.zeros(7, np.int64)
        nxt = _host(d.next).copy()
        order = D.order_from_next(
            torch.from_numpy(nxt) if pkg == "port" else nxt, d.head,
            d.count)
        # direct range flushes write home with their sidecar checksums
        d.nodes.write_rows([4], np.full((1, d.nodes.shape[1]), 77))
        d.nodes.persist_range(2, 9)
        t.records.persist_all()
        persisted = (_image(a), _stats(a))
        a.invalidate()
        valid_after = a.header_valid()
        out[pkg] = {
            "data": _host(d.data).tolist(), "next": nxt.tolist(),
            "tail": d.tail, "order_from_next": _host(order).tolist(),
            "dll.flush_stats": dataclasses.asdict(d.flush_stats()),
            "check": (h.check_against(ref), h.check_against(wrong),
                      h.check_against({})),
            "hm.flush_stats": dataclasses.asdict(h.flush_stats()),
            "keys_in_order": _host(t.keys_in_order()).tolist(),
            "max_key": t.max_key(),
            "bt.flush_stats": dataclasses.asdict(t.flush_stats()),
            "persist_range_all": persisted,
            "valid_after_invalidate": valid_after,
            "generation": a.header_generation()}
        assert out[pkg]["check"][:2] == (True, False)
    assert out["port"] == out["ref"]


# ------------------------------------------- the salvage prefix on kernels

def _reference_walk(nxt, head, count, bad):
    """The reference's salvage loop (``repro.pstruct.dll``), verbatim."""
    badset = set(bad.tolist())
    seen, prefix = set(), []
    cur = head
    while ((count is None or len(prefix) < count) and 0 <= cur < nxt.size
           and cur not in badset and cur not in seen):
        prefix.append(cur)
        seen.add(cur)
        cur = int(nxt[cur])
    return prefix


@st.composite
def chains(draw):
    n = draw(st.integers(1, 300))
    perm = draw(st.permutations(range(n)))
    nxt = np.full(n, -1, np.int64)
    nxt[np.asarray(perm[:-1], np.int64)] = perm[1:]
    # damage: out-of-range pointers, a loop back among verified rows
    for _ in range(draw(st.integers(0, 3))):
        i = draw(st.integers(0, n - 1))
        nxt[i] = draw(st.sampled_from([-1, -7, n, n + 5, 2 ** 33 + 1,
                                       draw(st.integers(0, n - 1))]))
    bad = np.asarray(sorted(draw(st.sets(st.integers(0, n - 1),
                                         max_size=6))), np.int64)
    head = draw(st.sampled_from([int(perm[0]), -1, n,
                                 draw(st.integers(0, n - 1))]))
    count = draw(st.sampled_from([None, n, n + 10,
                                  draw(st.integers(0, n))]))
    return nxt, head, count, bad


@settings(max_examples=120, deadline=None)
@given(case=chains(), method=st.sampled_from(["double", "contract"]))
def test_salvage_prefix_matches_reference_walk(case, method):
    nxt, head, count, bad = case
    want = _reference_walk(nxt, head, count, bad)
    got = TR.salvage_prefix(torch.from_numpy(nxt), head, count,
                            torch.from_numpy(bad), method=method)
    assert got.tolist() == want


@pytest.mark.parametrize("method", ["double", "contract"])
def test_salvage_prefix_edges(method):
    nxt = np.array([1, 2, 3, 1, -1], np.int64)       # 1 -> 2 -> 3 -> 1
    walk = lambda h, c, b: TR.salvage_prefix(      # noqa: E731
        torch.from_numpy(nxt), h, c, torch.tensor(b, dtype=torch.int64),
        method=method).tolist()
    for h, c, b in ((0, None, []), (0, 2, []), (0, 10, [3]), (0, 10, [0]),
                    (5, 10, []), (-1, 3, []), (4, 0, []), (4, None, [])):
        assert walk(h, c, b) == _reference_walk(nxt, h, c,
                                                np.asarray(b, np.int64))
