"""repro_torch arena + write set vs the reference: the same mark / epoch /
commit / crash sequences give byte-identical persistent images and equal
FlushStats (every field).  The port runs on CPU tensors, with every epoch
drain gathering through ``pack_rows`` (its plain version here)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import arena as RA
from repro_torch.core import arena as TA

LAYOUT = {"a": (np.int64, (64, 8)),       # 64 B rows: one line each
          "b": (np.int64, (64, 2)),       # 16 B rows: four per line
          "c": (np.int32, (40, 5)),       # 20 B rows: straddle lines
          "w": (np.int32, (16, 64)),      # 256 B rows (B+Tree nodes)
          "x.header": (np.int64, (1, 8))}


def _ref(path=None, **kw):
    return RA.open_arena(path, LAYOUT, integrity=False, **kw)


def _port(path=None, **kw):
    return TA.open_arena(path, LAYOUT, device="cpu", integrity=False, **kw)


def _put(arena, name, rows, vals):
    r = arena.regions[name]
    if isinstance(r.vol, torch.Tensor):
        r.vol[torch.as_tensor(rows)] = torch.as_tensor(vals, dtype=r.vol.dtype)
    else:
        r.vol[rows] = vals


def _stats(a):
    return dataclasses.asdict(a.stats)


def _scenario(a, rng):
    """A mixed sequence; returns the images + stats after each commit."""
    out = []
    for step in range(6):
        with a.epoch():
            for name in ("a", "b", "c", "w"):
                n, width = LAYOUT[name][1]
                for _ in range(3):    # overlapping marks: dedup + coalesce
                    rows = rng.choice(n, rng.integers(1, 9), replace=False)
                    _put(a, name, rows, rng.integers(
                        -999, 999, (rows.size, width)))
                    a.regions[name].mark_rows(rows)
            _put(a, "x.header", [0], rng.integers(0, 99, (1, 8)))
            a.regions["x.header"].mark_rows(np.array([0]))
            if step == 2:
                with a.epoch():       # nested epoch flushes at outermost
                    a.regions["a"].mark_rows(np.array([5, 6]))
        if step == 3:
            # outside any epoch: immediate per-call persists
            a.regions["b"].mark_rows(np.array([1, 2, 3]))
            a.regions["c"].persist_rows(np.array([9, 3, 4, 3]))
        a.commit()
        out.append((np.array(a._mm), _stats(a), a.header_generation()))
    return out


def test_scenario_images_and_stats_identical():
    got = _scenario(_port(), np.random.default_rng(1))
    want = _scenario(_ref(), np.random.default_rng(1))
    for (gi, gs, gg), (wi, ws, wg) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gs == ws
        assert gg == wg


def _count_gathers(monkeypatch):
    """Record the per-region row counts of every grouped gather."""
    from repro_torch.core import writeset
    calls = []
    real = writeset.pack_rows_grouped

    def counting(srcs, idx, counts):
        calls.append(list(counts))
        return real(srcs, idx, counts)

    monkeypatch.setattr(writeset, "pack_rows_grouped", counting)
    return calls


def test_every_drain_gathers_through_pack_rows(monkeypatch):
    """The port's drain has no non-kernel gather: one grouped pack_rows
    gather per drain holds every region it writes, data and metadata
    phase alike; persist_rows outside an epoch is a gather of one."""
    from repro_torch.core.writeset import WriteSet
    calls = _count_gathers(monkeypatch)
    a = _port()
    before = WriteSet.gathers
    with a.epoch():
        a.regions["a"].mark_rows(np.array([1, 2, 2]))
        a.regions["w"].mark_rows(np.array([3]))
        a.regions["x.header"].mark_rows(np.array([0]))
    assert calls == [[2, 1, 1]]
    assert WriteSet.gathers == before + 1
    a.regions["b"].persist_rows(np.array([4, 5]))    # outside any epoch
    assert calls[-1] == [2]
    assert WriteSet.gathers == before + 2


def test_flush_without_meta_gathers_no_metadata_row(monkeypatch):
    """flush(include_meta=False) gathers and writes only the data phase:
    the header's persisted bytes stay as the last commit left them, and
    the image and FlushStats equal the reference's."""
    calls = _count_gathers(monkeypatch)
    res = []
    for a in (_port(), _ref()):
        rng = np.random.default_rng(8)
        _scenario(a, rng)
        hdr = np.array(a.regions["x.header"]._pview())
        calls.clear()
        with a.epoch():
            _put(a, "a", [3, 40], rng.integers(0, 9, (2, 8)))
            a.regions["a"].mark_rows(np.array([3, 40]))
            _put(a, "c", [7], rng.integers(0, 9, (1, 5)))
            a.regions["c"].mark_rows(np.array([7]))
            _put(a, "x.header", [0], rng.integers(100, 200, (1, 8)))
            a.regions["x.header"].mark_rows(np.array([0]))
            a.writeset.flush(include_meta=False)
            assert not a.writeset
        np.testing.assert_array_equal(a.regions["x.header"]._pview(), hdr)
        res.append((np.array(a._mm), _stats(a)))
        if isinstance(a, TA.Arena):
            assert calls == [[2, 1]]          # regions a and c, no header
    np.testing.assert_array_equal(res[0][0], res[1][0])
    assert res[0][1] == res[1][1]


def test_grouped_gather_equals_per_region_gather():
    """The write set's one gather over several regions returns, per
    region, what the per-region gather (gather_rows) returns: the same
    dtype, shape and rows."""
    from repro_torch.core.writeset import gather_rows
    a = _port()
    rng = np.random.default_rng(9)
    _scenario(a, rng)
    plan = [(a.regions[name], np.sort(rng.choice(
        LAYOUT[name][1][0], k, replace=False)))
        for name, k in (("c", 7), ("a", 0), ("w", 3), ("b", 64),
                        ("x.header", 1))]
    for (region, rows), got in zip(plan, a.writeset.gather(plan)):
        want = gather_rows(region, rows)
        assert got.dtype == want.dtype == region.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(region.vol)[rows])


def test_torn_epoch_data_before_metadata():
    """flush(include_meta=False) writes the data half and drops the
    header marks: both packages leave the same bytes and stats."""
    res = []
    for a in (_port(), _ref()):
        rng = np.random.default_rng(3)
        _scenario(a, rng)
        with a.epoch():
            _put(a, "a", [9, 10], rng.integers(0, 9, (2, 8)))
            a.regions["a"].mark_rows(np.array([9, 10]))
            _put(a, "x.header", [0], rng.integers(0, 9, (1, 8)))
            a.regions["x.header"].mark_rows(np.array([0]))
            a.writeset.flush(include_meta=False)
            assert not a.writeset
            a.crash()
        a.reopen()
        res.append((np.array(a._mm), _stats(a), a.generation,
                    np.asarray(a.regions["x.header"].vol).copy()))
    np.testing.assert_array_equal(res[0][0], res[1][0])
    assert res[0][1] == res[1][1] and res[0][2] == res[1][2]
    np.testing.assert_array_equal(res[0][3], res[1][3])


def test_crash_drops_volatile_and_reopen_reloads():
    a = _port()
    _scenario(a, np.random.default_rng(4))
    a.crash()
    assert all(int(r.vol.abs().sum()) == 0 for r in a.regions.values())
    a.reopen()
    for r in a.regions.values():
        np.testing.assert_array_equal(r.vol.numpy(), r._pview())


def test_path_backed_file_and_layout_sidecar_identical(tmp_path):
    for mk, p in ((_port, tmp_path / "t.arena"), (_ref, tmp_path / "r.arena")):
        a = mk(str(p))
        _scenario(a, np.random.default_rng(5))
        a.close()
    assert (tmp_path / "t.arena").read_bytes() == \
        (tmp_path / "r.arena").read_bytes()
    assert json.loads((tmp_path / "t.arena.layout").read_text()) == \
        json.loads((tmp_path / "r.arena.layout").read_text())
    # a fresh process reopening the file reads the committed generation
    a = _port(str(tmp_path / "r.arena"))
    assert a.header_generation() == 6


def test_synthetic_latency_accounting_matches():
    got = _scenario(_port(synth_line_ns=5.0, synth_fence_ns=20.0),
                    np.random.default_rng(6))
    want = _scenario(_ref(synth_line_ns=5.0, synth_fence_ns=20.0),
                     np.random.default_rng(6))
    assert got[-1][1] == want[-1][1]
    assert got[-1][1]["fence_ns"] > 0


def test_device_and_feature_axes():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TA.Arena(None, integrity=False)   # no silent CPU fallback
    # paging is ported: a paged arena builds the reference's block cache
    # and pages the reference's regions
    port = TA.open_arena(None, LAYOUT, device="cpu", integrity=False,
                         paged=True, block_bytes=512, cache_blocks=4)
    ref = RA.open_arena(None, LAYOUT, integrity=False, paged=True,
                        block_bytes=512, cache_blocks=4)
    assert port.paged and ref.paged
    assert (port.cache.block_bytes, port.cache.capacity_bytes) == \
        (ref.cache.block_bytes, ref.cache.capacity_bytes)
    assert {n: r.is_paged for n, r in port.regions.items()} == \
        {n: getattr(r, "is_paged", False) for n, r in ref.regions.items()}
    assert np.array_equal(np.asarray(port._mm), np.asarray(ref._mm))
    # shadow commit on one arena is ported: the reference's layout (meta
    # line, two entry banks, a mirror per region per bank) and bytes
    port = TA.open_arena(None, LAYOUT, device="cpu", integrity=False,
                         commit_mode="shadow")
    ref = RA.open_arena(None, LAYOUT, integrity=False, commit_mode="shadow")
    assert port.commit_mode == ref.commit_mode == "shadow"
    assert (port._shadow_meta_off, port._shadow_ent_off,
            port._shadow_cap) == (ref._shadow_meta_off,
                                  ref._shadow_ent_off, ref._shadow_cap)
    assert {n: r._shadow_off for n, r in port.regions.items()} == \
        {n: r._shadow_off for n, r in ref.regions.items()}
    assert port._region_ids == ref._region_ids
    assert np.array_equal(np.asarray(port._mm), np.asarray(ref._mm))
    # integrity is ported: the port builds the reference's sidecar layout
    port = TA.open_arena(None, LAYOUT, device="cpu", integrity=True)
    ref = RA.open_arena(None, LAYOUT, integrity=True)
    assert port.integrity and ref.integrity
    assert port._meta == ref._meta
    assert any(n.endswith(".integ") for n in port.regions)
    assert np.array_equal(np.asarray(port._mm), np.asarray(ref._mm))
    # sharding is ported, in both commit modes: a sharded shadow arena's
    # shards carry the reference's shadow layout, and a commit of the same
    # rows gives every shard's bytes and the manifest
    assert TA.open_arena(None, LAYOUT, n_shards=2, device="cpu",
                         integrity=False).n_shards == 2
    port = TA.open_arena(None, LAYOUT, n_shards=2, device="cpu",
                         integrity=True, commit_mode="shadow")
    ref = RA.open_arena(None, LAYOUT, n_shards=2, integrity=True,
                        commit_mode="shadow")
    assert port.commit_mode == ref.commit_mode == "shadow"
    for psh, rsh in zip(port.shards, ref.shards):
        assert psh.commit_mode == rsh.commit_mode == "shadow"
        assert psh._meta == rsh._meta
        assert (psh._shadow_meta_off, psh._shadow_ent_off,
                psh._shadow_cap) == (rsh._shadow_meta_off,
                                     rsh._shadow_ent_off, rsh._shadow_cap)
    for a in (port, ref):
        for name, r in a.regions.items():
            if not r.integ:
                r.write_rows(np.arange(r.shape[0]), np.ones(
                    r.shape, r.dtype))
        with a.epoch():
            for name, r in a.regions.items():
                if not r.integ:
                    r.mark_rows(np.arange(r.shape[0]))
        a.commit()
    assert [bytes(np.asarray(sh._mm)) for sh in port.shards] + \
        [bytes(np.asarray(port._man))] == \
        [bytes(np.asarray(sh._mm)) for sh in ref.shards] + \
        [bytes(np.asarray(ref._man))]
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    # a sharded arena pages at the sharded level; its shards stay unpaged
    port = TA.open_arena(None, LAYOUT, n_shards=2, device="cpu",
                         integrity=False, paged=True, block_bytes=512)
    ref = RA.open_arena(None, LAYOUT, n_shards=2, integrity=False,
                        paged=True, block_bytes=512)
    assert {n: r.is_paged for n, r in port.regions.items()} == \
        {n: getattr(r, "is_paged", False) for n, r in ref.regions.items()}
    assert not any(sh.paged or sh.cache for sh in port.shards)
    assert port.cache.capacity_bytes == ref.cache.capacity_bytes


def test_paged_none_resolves_like_reference(monkeypatch):
    from repro.pstruct.dll import DoublyLinkedList as RDLL
    from repro_torch.pstruct.dll import DoublyLinkedList as TDLL
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    monkeypatch.setenv("REPRO_PAGED", "1")
    ref = RA.open_arena(None, RDLL.layout(4096, snapshot=False))
    assert ref.paged is True
    port = TA.open_arena(None, TDLL.layout(4096, snapshot=False),
                         device="cpu")
    assert port.paged is True and port.regions["dll.nodes"].is_paged
    # the same appends give the reference's image and cache counters
    rd = RDLL(ref, 4096, snapshot=False)
    td = TDLL(port, 4096, snapshot=False)
    vals = np.random.default_rng(1).integers(0, 99, (300, 7))
    for d in (rd, td):
        d.append_batch(vals)
        d.arena.commit()
    assert np.array_equal(np.array(ref._mm), np.array(port._mm))
    assert {k: getattr(port.cache, k) for k in ("faults", "hits",
                                                 "evictions")} == \
        {k: getattr(ref.cache, k) for k in ("faults", "hits", "evictions")}
    monkeypatch.delenv("REPRO_PAGED")
    ref = RA.open_arena(None, RDLL.layout(4096, snapshot=False))
    assert ref.paged is False
    port = TA.open_arena(None, TDLL.layout(4096, snapshot=False),
                         device="cpu")
    assert not TA.paged_enabled(None)
    assert np.array_equal(np.array(ref._mm), np.array(port._mm))


def test_not_ported_names_the_queue_only():
    msg = str(TA.not_ported("x"))
    assert "x" in msg and "ROADMAP Queue 1" in msg
    assert "Slice A" not in msg and "item" not in msg
    # a sharded shadow arena opens, paged too; a feature that still raises
    # (a variant the mLSTM layer lacks; every layer kind is ported) names
    # the queue alone
    assert TA.ShardedArena(None, n_shards=4, commit_mode="shadow",
                           device="cpu").commit_mode == "shadow"
    assert TA.ShardedArena(None, n_shards=4, commit_mode="shadow",
                           device="cpu", paged=True).cache is not None
    from repro_torch.configs import base, registry
    from repro_torch.models.backbone import apply_layer
    cfg = base.reduced(registry.get("llama3.2-3b"))
    with pytest.raises(NotImplementedError) as err:
        apply_layer(cfg, "mlstm:local", {}, torch.zeros(1, 4, cfg.d_model),
                    mode="prefill")
    msg = str(err.value)
    assert "mlstm:local" in msg and "ROADMAP Queue 1" in msg
    assert "item" not in msg
