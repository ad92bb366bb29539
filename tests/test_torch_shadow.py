"""repro_torch shadow commit on one arena (DESIGN.md §9), and the chain
kernels' packed layout at offsets with gaps, on the CPU against the JAX
reference.

* Gapped ``segments=``: the four chain kernels and ``chain_order`` by both
  methods on shard-major packings whose shard spans end in padding rows.
  ``jump_double`` and ``gather_next`` against the reference's Pallas
  kernels in interpret mode; ``walk_segments`` and ``expand_segments``
  against the port's global-layout plain versions on the same chain (the
  reference's packed walk and expand call ``pl.load``, which this jax
  lacks); ``chain_order`` against the reference's host ``chain_order`` on
  the global column.  The smallest input the port used to refuse, and the
  offsets it still refuses.
* Shadow commit: the same operations through both packages give
  byte-identical images (home rows, both remap banks, the mirrors and the
  meta line) and equal ``FlushStats`` after every commit, and recover to
  equal state, per structure in both modes, integrity off and on, with the
  reference behaviours that are easy to get wrong pinned one by one:
  direct persists write home, a row marked fresh and rewritten routes as a
  rewrite, snapshot and journal rows stay off the dedup ledger, the
  sidecar cascade, the deferred fold and its crash hook, one fence per
  commit, the parse re-anchoring the generation, a crash after the seal
  and before the flip, and fault injection through the authoritative bank.
* The reference's ``("shadow", 1)`` cells of ``tests/test_integrity.py``'s
  GRID, through ``tests/test_torch_integrity.py``'s two-package helpers.

Integer and byte results, compared exactly (tolerance 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_integrity as TI
from repro.core import recovery as RR
from repro.kernels import chain_order as jco
from repro_torch.core import arena as TA
from repro_torch.core import recovery as TR
from repro_torch.core.writeset import WriteSet
from repro_torch.interop import arena_from_image
from repro_torch.kernels import chain_order as tco

NULL = -1
PKG = TI.PKG
SHADOW = {"commit_mode": "shadow"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # integrity resolves on by default in both packages; paging stays off
    monkeypatch.delenv("REPRO_INTEGRITY", raising=False)
    monkeypatch.delenv("REPRO_PAGED", raising=False)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------- gapped packed layouts

def _gapped(m, B, N, seed, torn=False, fill=NULL):
    """A random chain of m nodes packed shard-major under ("seg", B) with
    0-3 padding rows after each shard's rows and 0-2 after the last span.
    Returns (global nxt, head, packed column, segments, position of each
    id); padding rows hold ``fill``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m)
    nxt = np.full(m, NULL, np.int64)
    nxt[perm[:-1]] = perm[1:]
    rows = np.bincount((np.arange(m) // B) % N, minlength=N)
    spans = rows + rng.integers(0, 4, N)
    segments = np.concatenate([[0], np.cumsum(spans)]).astype(np.int64)
    n = int(segments[-1] + rng.integers(0, 3))
    if torn and m > 3:
        # out of range of the packed array in both packages: terminates
        nxt[perm[m // 3]] = n + 5
        nxt[perm[m // 2]] = NULL
    pos = jco.packed_positions(np.arange(m, dtype=np.int64), B, segments)
    packed = np.full(n, fill, np.int64)
    packed[pos] = nxt
    return nxt, int(perm[0]), packed, segments, pos


GAPPED = [(6, 2, 2), (203, 8, 3), (256, 64, 4), (40, 16, 4), (700, 3, 5)]


def test_gapped_smallest_input_answers_as_reference():
    """The chain 0 -> ... -> 5 over seg_rows=2, two shards, packed at
    [0, 5, 7] (one padding row after shard 0): the reference answers
    [1, 2, 3, 4, 5, -1]; the port used to refuse the offsets."""
    segs = [0, 5, 7]
    pos = jco.packed_positions(np.arange(6, dtype=np.int64), 2,
                               np.asarray(segs))
    packed = np.full(7, NULL, np.int64)
    packed[pos] = [1, 2, 3, 4, 5, NULL]
    want = np.asarray(jco.gather_next(jnp.asarray(packed, jnp.int32),
                                      np.arange(6, dtype=np.int64),
                                      segments=np.asarray(segs), seg_rows=2,
                                      interpret=True))
    got = tco.gather_next(torch.from_numpy(packed.astype(np.int32)),
                          torch.arange(6), segments=segs, seg_rows=2)
    assert want.tolist() == got.tolist() == [1, 2, 3, 4, 5, -1]
    for method in ("double", "contract"):
        assert TR.chain_order(torch.from_numpy(packed), 0, method=method,
                              segments=segs, seg_rows=2).tolist() == \
            list(range(6))


@pytest.mark.parametrize("m,B,N", GAPPED)
@pytest.mark.parametrize("torn", [False, True])
def test_gapped_jump_double_matches_pallas(m, B, N, torn):
    """Every round of one launch (``rounds=r, keep=True``) and the counts
    against r reference calls at the same gapped offsets."""
    _, _, packed, segments, _ = _gapped(m, B, N, m + 1, torn)
    n = packed.shape[0]
    cnt = np.random.default_rng(m).integers(1, 5, n)
    rounds = max(1, m.bit_length())
    jump = np.where((packed >= 0) & (packed < n), packed, NULL)
    want_j = [jump.astype(np.int32)]
    rj, rc = jnp.asarray(jump, jnp.int32), jnp.asarray(cnt, jnp.int32)
    for _ in range(rounds):
        rj, rc = jco.jump_double(rj, rc, segments=segments, seg_rows=B,
                                 interpret=True)
        want_j.append(np.asarray(rj))
    levels, got_c = tco.jump_double(
        torch.from_numpy(jump.astype(np.int32)), torch.from_numpy(cnt),
        rounds=rounds, keep=True, segments=segments, seg_rows=B)
    np.testing.assert_array_equal(levels.numpy(), np.stack(want_j))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(rc))


@pytest.mark.parametrize("m,B,N", GAPPED)
def test_gapped_gather_next_matches_pallas(m, B, N):
    _, _, packed, segments, _ = _gapped(m, B, N, m + 2, torn=True)
    n = packed.shape[0]
    sane = np.where((packed >= 0) & (packed < n), packed, NULL)
    ids = np.concatenate([np.random.default_rng(m).integers(-2, m, 97),
                          [2 ** 32 + 3, -(2 ** 40), n]]).astype(np.int64)
    t_nxt = torch.from_numpy(sane.astype(np.int32))
    want = np.asarray(jco.gather_next(jnp.asarray(sane, jnp.int32), ids,
                                      segments=segments, seg_rows=B,
                                      interpret=True))
    got = tco.gather_next(t_nxt, torch.from_numpy(ids), segments=segments,
                          seg_rows=B)
    np.testing.assert_array_equal(got.numpy(), want)
    walk, length = tco.gather_next(t_nxt, torch.from_numpy(ids), hops=4,
                                   segments=segments, seg_rows=B)
    cols = [ids]
    for t in range(4):
        cols.append(np.asarray(jco.gather_next(
            jnp.asarray(sane, jnp.int32), cols[-1], segments=segments,
            seg_rows=B, interpret=True), np.int64))
        np.testing.assert_array_equal(walk[t].numpy(), cols[-1])
    assert length == sum(int(((c >= 0) & (c < m)).any()) for c in cols)


@pytest.mark.parametrize("m,B,N", GAPPED)
@pytest.mark.parametrize("torn", [False, True])
def test_gapped_walk_and_expand_match_global(m, B, N, torn):
    """The gapped packed walk (checkpoints included) and expand give what
    the global-layout plain versions give on the global column; padding
    rows hold garbage, which no id addresses."""
    nxt, head, packed, segments, _ = _gapped(m, B, N, m + 3, torn,
                                             fill=7)
    g32 = tco.sanitize32(torch.from_numpy(nxt))
    p32 = tco.sanitize32(torch.from_numpy(packed))
    k = 4
    starts = torch.cat([torch.arange(0, m, k), torch.tensor([head])]
                       ).to(torch.int32)
    kw = dict(k=k, head=head, n_mult=(m + k - 1) // k,
              promoted=head % k != 0, budget=64, marks=m)
    want = tco.walk_segments_plain(g32, starts, **kw)
    got = tco.walk_segments(p32, starts, segments=segments, seg_rows=B,
                            **kw)
    for w, g in zip(want[:3], got[:3]):
        assert torch.equal(w, g)
    assert torch.equal(want[3][0], got[3][0])
    assert torch.equal(want[3][1], got[3][1])
    rem = torch.full((starts.shape[0],), 5, dtype=torch.int32)
    posn = (torch.arange(starts.shape[0]) * 5).to(torch.int32)
    count = 5 * starts.shape[0]
    want_o = tco.expand_segments_plain(g32, starts, posn, rem, count)
    got_o = tco.expand_segments(p32, starts, posn, rem, count,
                                segments=segments, seg_rows=B)
    ref = tco.gather_next_plain(g32, starts.long(), hops=4)[0]
    cols = torch.cat([starts[None], ref]).t()
    ok = torch.zeros(count, dtype=torch.bool)
    for i in range(starts.shape[0]):
        ok[5 * i: 5 * i + int((cols[i] >= 0).cumprod(0).sum())] = True
    assert torch.equal(got_o[ok], want_o[ok])


@pytest.mark.parametrize("m,B,N", GAPPED + [(5000, 64, 4), (3001, 64, 3)])
@pytest.mark.parametrize("method", ["double", "contract"])
def test_gapped_chain_order_matches_host_reference(m, B, N, method):
    """chain_order(segments=) at gapped offsets, by both methods, equals
    the reference's host primitive on the global column, with and without
    a count and through the snapshot verify; padding rows hold garbage."""
    for torn in (False, True):
        nxt, head, packed, segments, _ = _gapped(m, B, N, m + 4, torn,
                                                 fill=3)
        want = RR.chain_order(nxt, head)
        tp = torch.from_numpy(packed)
        kw = dict(method=method, segments=segments, seg_rows=B)
        assert TR.chain_order(tp, head, **kw).tolist() == want.tolist()
        for count in (want.size, want.size // 2 + 1):
            assert TR.chain_order(tp, head, count, **kw).tolist() == \
                want[:count].tolist()
        with pytest.raises(ValueError, match="count exceeds"):
            TR.chain_order(tp, head, want.size + 1, **kw)
        snap = TR.ChainSnapshot(want)
        assert TR.chain_order(tp, head, want.size, snapshot=snap,
                              **kw).tolist() == want.tolist()
        assert snap.outcome == "snapshot"


def test_gapped_ids_past_a_span_read_null():
    """An id in [0, n) whose position falls past its shard's span
    addresses no row: as an input and as a value loaded it reads NULL in
    every kernel, so both methods agree on where the chain ends."""
    segs = [0, 5, 7]                          # id 6: shard 1, position 7
    packed = np.full(7, NULL, np.int64)
    pos = jco.packed_positions(np.arange(6, dtype=np.int64), 2,
                               np.asarray(segs))
    packed[pos] = [1, 2, 6, 4, 5, NULL]      # node 2 points at id 6
    p32 = torch.from_numpy(packed.astype(np.int32))
    kw = dict(segments=segs, seg_rows=2)
    assert tco.addressable(np.arange(-1, 8), 7, **kw).tolist() == \
        [False] + [True] * 6 + [False, False]
    assert tco.gather_next(p32, torch.tensor([6, 2]), **kw).tolist() == \
        [NULL, 6]
    jump, cnt = tco.jump_double(p32, torch.ones(7, dtype=torch.int64),
                                rounds=3, **kw)
    assert int(cnt[0]) == 3                  # 0, 1, 2: id 6 is no node
    for method in ("double", "contract"):
        assert TR.chain_order(torch.from_numpy(packed), 0, method=method,
                              **kw).tolist() == [0, 1, 2]
        assert TR.chain_order(torch.from_numpy(packed), 6, method=method,
                              **kw).tolist() == []


@pytest.mark.parametrize("segs", [[1, 3, 5], [0, 4, 3], [0, 3, 9], [0]])
def test_packing_refuses_bad_offsets(segs):
    nxt = torch.full((8,), NULL, dtype=torch.int32)
    with pytest.raises(ValueError, match="segments"):
        tco.gather_next(nxt, torch.tensor([0]), segments=segs, seg_rows=2)


def test_gapped_packing_caps_shards_and_partition_does_not():
    n_shards = tco.MAX_GAPPED_SHARDS + 1
    nxt = torch.full((2 * n_shards + 1,), NULL, dtype=torch.int32)
    part = tco.router_segments(nxt.shape[0], 1, n_shards)
    assert tco.gather_next(nxt, torch.tensor([0]), segments=part,
                           seg_rows=1).tolist() == [NULL]
    with pytest.raises(ValueError, match="at most"):
        tco.gather_next(nxt, torch.tensor([0]), segments=[0] * n_shards
                        + [1], seg_rows=1)


# ----------------------------------------------------------- shadow arena

def _layout(pkg, kind, mode, **kw):
    _, _, _, D, B, H = PKG[pkg]
    if kind == "dll":
        return D.DoublyLinkedList.layout(512, mode, **kw)
    if kind == "bptree":
        return B.BPTree.layout(256, 2048, mode)
    return H.Hashmap.layout(1024, mode, **kw)


def _structure(pkg, kind, mode, path=None, snapshot=True, **arena_kw):
    A, _, _, D, B, H = PKG[pkg]
    kw = {"snapshot": snapshot} if kind != "bptree" else {}
    if pkg == "port":
        arena_kw["device"] = "cpu"
    a = A.open_arena(path, _layout(pkg, kind, mode, **kw), **arena_kw)
    if kind == "dll":
        return a, D.DoublyLinkedList(a, 512, mode, **kw)
    if kind == "bptree":
        return a, B.BPTree(a, 256, 2048, mode)
    return a, H.Hashmap(a, 1024, mode, **kw)


def _ops(kind, s, rng, i):
    """Operation i of a structure's script: inserts, then deletes and
    rewrites of committed rows."""
    vals = rng.integers(0, 1 << 30, (9, 7)).astype(np.int64)
    keys = np.arange(9 * i, 9 * i + 9, dtype=np.int64)
    if kind == "dll":
        if i % 4 == 3 and s.count > 4:
            s.pop_front_batch(2)
            s.delete_batch(_host(s.to_list())[1:3])
        else:
            s.append_batch(vals)
    elif kind == "bptree":
        if i % 4 == 3:
            s.delete_batch(keys - 18)
        else:
            s.insert_batch(keys, vals)
    else:
        if i % 4 == 3:
            s.remove_batch(keys - 18)
        else:
            s.insert_batch(keys, vals)


def _state(kind, s):
    if kind == "dll":
        order = _host(s.to_list())
        return order.tolist(), _host(s.data)[order].tolist()
    if kind == "bptree":
        return _host(s.keys_in_order()).tolist()
    keys = np.arange(0, 200, dtype=np.int64)
    ok, vals = s.find_batch(keys)
    return _host(ok).tolist(), _host(vals)[_host(ok)].tolist()


@pytest.mark.parametrize("integrity", [False, True])
@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("kind", ["dll", "bptree", "hashmap"])
def test_structure_images_stats_and_recovery_match(tmp_path, kind, mode,
                                                   integrity):
    """Each structure under shadow commit: byte-identical images (banks,
    mirrors and meta line included) and equal FlushStats after every
    commit, epochs that drain between commits, then equal recovery."""
    built = {pkg: _structure(pkg, kind, mode, str(tmp_path / pkg),
                             integrity=integrity, **SHADOW)
             for pkg in PKG}
    rngs = {pkg: np.random.default_rng(5) for pkg in PKG}
    for i in range(12):
        for pkg, (a, s) in built.items():
            with a.epoch():
                _ops(kind, s, rngs[pkg], i)
            if i % 3 != 1:                 # some epochs drain uncommitted
                a.commit()
        (pa, _), (ra, _) = built["port"], built["ref"]
        assert TI._stats(pa) == TI._stats(ra), i
        assert TI._image(pa) == TI._image(ra), i
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()
    (pa, ps), (ra, rs) = built["port"], built["ref"]
    assert ps.arena._shadow_counts == rs.arena._shadow_counts
    out = {}
    for pkg, (a, s) in built.items():
        a.crash()
        mgr = PKG[pkg][2].RecoveryManager(a)
        mgr.add(kind, {"dll": "pstruct.dll", "bptree": "pstruct.bptree",
                       "hashmap": "pstruct.hashmap"}[kind], s)
        rep = mgr.recover()
        out[pkg] = (TI._report(rep), _state(kind, s), TI._scrub(a),
                    a.generation)
    assert out["port"] == out["ref"]
    assert out["port"][0]["stages"][0][3]["modes"] == ["shadow"]


def _region_arena(pkg, **kw):
    """A bare shadow arena of two data regions (one of them covered by a
    sidecar), a header, a snapshot ring and a journal ring."""
    A = PKG[pkg][0]
    if pkg == "port":
        kw["device"] = "cpu"
    return A.open_arena(None, {"x.data": (np.int64, (64, 8)),
                               "x.small": (np.int32, (40, 3)),
                               "x.header": (np.int64, (1, 8)),
                               "x.snap": (np.int64, (16, 8)),
                               "x.jrnl": (np.int64, (16, 8))},
                        commit_mode="shadow", **kw)


def _write(a, name, rows, seed):
    r = a.regions[name]
    vals = np.random.default_rng(seed).integers(
        0, 1 << 20, (len(rows),) + r.shape[1:]).astype(r.dtype)
    r.write_rows(np.asarray(rows, np.int64), vals)


def _drive_regions(a):
    """Marks of every kind across three commits: fresh and rewrite marks,
    a row marked both ways, duplicates, snapshot and journal rows, and
    direct persists outside any epoch."""
    for g in range(3):
        with a.epoch():
            _write(a, "x.data", range(8 * g, 8 * g + 12), g)
            a.regions["x.data"].mark_rows(np.arange(8 * g, 8 * g + 8),
                                          fresh=True)
            # rows 8g+4..8g+11 also as rewrites: 4..7 are marked both ways
            a.regions["x.data"].mark_rows(np.arange(8 * g + 4, 8 * g + 12))
            a.regions["x.data"].mark_rows(np.arange(8 * g + 4, 8 * g + 6))
            _write(a, "x.small", [1, 2, 3, 17], 10 + g)
            a.regions["x.small"].mark_rows([1, 2, 3, 17])
            _write(a, "x.header", [0], 20 + g)
            a.regions["x.header"].mark_rows([0])
            _write(a, "x.snap", [g, g + 1], 30 + g)
            a.regions["x.snap"].mark_rows([g, g + 1])
            a.regions["x.snap"].mark_rows([g + 1])
            _write(a, "x.jrnl", [g], 40 + g)
            a.regions["x.jrnl"].mark_rows([g], fresh=True)
        a.commit()
        # outside any epoch: straight home, bypassing the banks
        _write(a, "x.data", [60, 61], 50 + g)
        a.regions["x.data"].persist_rows([60, 61])
        _write(a, "x.small", range(30, 34), 60 + g)
        a.regions["x.small"].persist_range(30, 34)


@pytest.mark.parametrize("integrity", [False, True])
def test_write_set_routing_matches_reference(integrity):
    """The routing rules one by one, on bare regions: images and
    FlushStats after every step, the masks and counts of both banks."""
    arenas = {pkg: _region_arena(pkg, integrity=integrity) for pkg in PKG}
    for a in arenas.values():
        _drive_regions(a)
    pa, ra = arenas["port"], arenas["ref"]
    assert TI._image(pa) == TI._image(ra)
    assert TI._stats(pa) == TI._stats(ra)
    for b in (0, 1):
        assert pa._shadow_masks[b].keys() == ra._shadow_masks[b].keys()
        for name, m in ra._shadow_masks[b].items():
            np.testing.assert_array_equal(pa._shadow_masks[b][name], m)
    assert pa._shadow_counts == ra._shadow_counts
    auth = pa._shadow_auth_bank
    mask = pa._shadow_masks[auth]["x.data"]
    # marked both ways: a rewrite (in the bank); fresh only: home
    assert mask[[16 + 4, 16 + 7, 16 + 11]].all() and not mask[16:20].any()
    # direct persists went home and were never remapped
    assert not mask[60:62].any()
    np.testing.assert_array_equal(pa.regions["x.data"]._pview()[60:62],
                                  _host(pa.regions["x.data"].vol)[60:62])
    # snapshot and journal rows stay off the dedup/saved ledger
    assert pa.stats.snapshot_lines > 0 and pa.stats.journal_lines > 0
    assert pa.stats.dedup_rows == ra.stats.dedup_rows
    if integrity:
        sc = pa.regions["x.data.integ"]
        assert sc is pa.regions["x.data"]._integ
        rows = np.nonzero(mask)[0]
        # the cascade: the checksums of the remapped rows sit in the
        # sidecar's own mirror in the same bank, and nowhere at home yet
        np.testing.assert_array_equal(
            pa._shadow_masks[auth]["x.data.integ"], mask)
        np.testing.assert_array_equal(
            pa._shadow_mirror(sc, auth)[rows],
            TA.sidecar_checksums(_host(pa.regions["x.data"].vol)[rows],
                                 sc.shape[1]))
        np.testing.assert_array_equal(_host(sc.vol)[rows],
                                      pa._shadow_mirror(sc, auth)[rows])
        assert pa.stats.integrity_lines > 0


def test_fences_calls_and_one_gather_per_drain():
    """One fence and one call per shadow commit (a barrier epoch pays
    three fences); a drain stages every region's rows in ONE grouped
    gather."""
    for pkg in PKG:
        a = _region_arena(pkg, integrity=True)
        before = a.stats.snapshot()
        gathers = WriteSet.gathers
        with a.epoch():
            _write(a, "x.data", range(10), 1)
            a.regions["x.data"].mark_rows(np.arange(5), fresh=True)
            a.regions["x.data"].mark_rows(np.arange(5, 10))
            a.regions["x.small"].mark_rows([3])
            a.regions["x.header"].mark_rows([0])
        if pkg == "port":
            assert WriteSet.gathers == gathers + 1
        d = a.stats.delta(before)
        assert d.fences == 0 and d.epochs == 1
        s0 = a.stats.snapshot()
        a.commit()
        d = a.stats.delta(s0)
        assert d.fences == 1 and d.calls >= 1
        s1 = a.stats.snapshot()
        a.commit()              # nothing pending: folds the last bank home
        d = a.stats.delta(s1)
        assert d.fences == 1 and d.lines > 0
        s2 = a.stats.snapshot()
        a.commit()              # nothing to fold: the seal's line only
        d = a.stats.delta(s2)
        assert (d.fences, d.calls, d.lines) == (1, 2, 1)
    for pkg in PKG:
        A = PKG[pkg][0]
        kw = {"device": "cpu"} if pkg == "port" else {}
        b = A.open_arena(None, {"x.data": (np.int64, (64, 8)),
                                "x.header": (np.int64, (1, 8))},
                         integrity=False, **kw)
        s0 = b.stats.snapshot()
        with b.epoch():
            b.regions["x.data"].mark_rows([1])
            b.regions["x.header"].mark_rows([0])
        b.commit()
        assert b.stats.delta(s0).fences == 3


def test_parse_reanchors_generation_and_bank_targeting():
    """After a crash the committed bank is parsed from the image alone:
    the masks and counts of the authoritative bank come back, the other
    bank's are empty, and the next drain targets bank (gen + 1) % 2."""
    for pkg in PKG:
        a = _region_arena(pkg, integrity=True)
        _drive_regions(a)
        gen = a.generation
        auth = gen % 2
        masks = {k: v.copy() for k, v in a._shadow_masks[auth].items()}
        count = a._shadow_counts[auth]
        a.generation = 99                  # a stale in-memory counter
        a.crash()
        a.reopen()
        assert a.generation == gen == a.header_generation() == 3
        assert a._shadow_auth_bank == auth
        assert a._shadow_target_bank() == (gen + 1) % 2
        assert a._shadow_counts[auth] == count
        assert a._shadow_counts[1 - auth] == 0
        assert a._shadow_masks[auth].keys() == masks.keys()
        for k, v in masks.items():
            np.testing.assert_array_equal(a._shadow_masks[auth][k], v)
        assert a._shadow_collapsed[auth] == (count == 0)


def _mixed(pkg, path=None, mode="partly", **kw):
    return TI._mixed(pkg, path, mode, commit_mode="shadow", **kw)


def test_collapse_crash_hook_is_idempotent(tmp_path):
    """``test_shadow_gc_crash_is_idempotent[1]``: the fold of the
    committed bank is cut after one region (``limit=1``), power fails,
    recovery reruns, twice; the committed state never moves, the two
    packages agree byte for byte, and the arena commits afterwards."""
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / pkg))
        TI._run(a, d, t, h, TI._script(6, seed=2))
        a.crash()
        TI._manager(pkg, a, d, t, h).recover()
        want = TI._fingerprint(d, t, h)
        runs = []
        for _ in range(2):
            assert a._shadow_collapse(limit=1) is False
            a.crash()
            rep = TI._manager(pkg, a, d, t, h).recover()
            assert rep.valid and rep.generation == 6
            assert TI._fingerprint(d, t, h) == want
            runs.append((TI._image(a), TI._stats(a)))
        d.append_batch(np.ones((2, 7), np.int64))
        a.commit()
        assert a.header_generation() == 7 and a.header_valid()
        out[pkg] = (runs, TI._image(a), TI._stats(a), want)
    assert out["port"] == out["ref"]


def test_sealed_unflipped_discards_epoch(tmp_path):
    """``test_single_arena_sealed_unflipped_discards_epoch``: collapse,
    drain and seal, then a crash before the flip; the sealed bank is an
    orphan and the epoch vanishes whole, as if the commit never began."""
    out = {}
    for pkg in PKG:
        def build(tag):
            a, d, t, h = _mixed(pkg, str(tmp_path / f"{pkg}{tag}"))
            TI._run(a, d, t, h, TI._script(4, seed=3))
            d.append_batch(np.ones((3, 7), np.int64))   # drained on close
            return a, d, t, h
        a, d, t, h = build("twin")
        a.crash()
        TI._manager(pkg, a, d, t, h).recover()
        want = TI._fingerprint(d, t, h)
        a2, d2, t2, h2 = build("torn")
        a2._shadow_collapse()
        a2.writeset.flush()
        a2._shadow_seal()
        a2.crash()
        rep = TI._manager(pkg, a2, d2, t2, h2).recover()
        assert rep.valid and rep.generation == 4
        assert TI._fingerprint(d2, t2, h2) == want
        d2.append_batch(np.ones((2, 7), np.int64))
        a2.commit()
        assert a2.header_generation() == 5
        out[pkg] = (want, TI._image(a2), TI._stats(a2))
    assert out["port"] == out["ref"]


def _rewrite_all(a, d, t, h):
    """One committed epoch that rewrites committed rows of all three
    structures, so the authoritative bank remaps some of each."""
    order = _host(d.to_list())
    with a.epoch():
        d.delete_batch(order[2:4])
        t.delete_batch(_host(t.keys_in_order())[3:6])
        h.remove_batch(np.asarray(HM_KEYS[:4], np.int64))
    a.commit()


# keys the hashmap holds after TI._script(12, ...) (every third op, from 2)
HM_KEYS = [k for i, (kind, keys, _) in enumerate(TI._script(12, seed=1))
           if kind == "hm" for k in keys.tolist()]


def _remapped(a, region):
    rows = np.nonzero(a._shadow_masks[a._shadow_auth_bank].get(
        region, np.zeros(0, bool)))[0]
    assert rows.size, f"no {region} row in the authoritative bank"
    return int(rows[len(rows) // 2])


@pytest.mark.parametrize("region", ["dll.nodes", "bt.nodes", "hm.entries"])
def test_fault_injection_lands_in_the_authoritative_bank(tmp_path, region):
    """committed_row_offset resolves a remapped row to its mirror slot in
    the authoritative bank from persistent state only, so flip_bits and
    stuck_line hit what scrub reads: both packages name the same row, at
    the same offset, with the same bytes; salvage reports agree."""
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / pkg))
        TI._run(a, d, t, h, TI._script(12, seed=1))
        _rewrite_all(a, d, t, h)
        row = _remapped(a, region)
        a.crash()
        F = PKG[pkg][1]
        owner, off, rb = F.committed_row_offset(a, region, row)
        bank = a.header_generation() % 2
        assert off == a.regions[region]._shadow_off[bank] + row * rb
        F.flip_bits(a, region, row, byte=8, mask=0x01)
        a.reopen()
        first = TI._scrub(a)
        assert row in first[region]
        F.flip_bits(a, region, row, byte=8, mask=0x01)       # undo
        assert TI._scrub(a) == {}
        lo_hi = F.stuck_line(a, region, row, line=0, value=0xAB)
        second = TI._scrub(a)
        rep = TI._manager(pkg, a, d, t, h).recover(salvage=True)
        out[pkg] = (row, off, first, lo_hi, second, TI._report(rep),
                    TI._fingerprint(d, t, h), TI._image(a))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_shadow_image_recovers_in_the_other_package(tmp_path, writer):
    """An arena written by either package, its last epoch drained into the
    target bank but never flipped, recovers in the other to the writer's
    committed state."""
    reader = "port" if writer == "ref" else "ref"
    a, d, t, h = _mixed(writer, str(tmp_path / "w"))
    TI._run(a, d, t, h, TI._script(9, seed=4))
    with a.epoch():
        d.pop_front_batch(2)
        TI._apply(d, t, h, TI._script(10, seed=4)[9])
    a.crash()
    TI._manager(writer, a, d, t, h).recover()
    want = TI._fingerprint(d, t, h)
    b, d2, t2, h2 = _mixed(reader, str(tmp_path / "w"))
    rep = TI._manager(reader, b, d2, t2, h2).recover()
    assert rep.valid and rep.generation == 9
    assert TI._fingerprint(d2, t2, h2) == want
    # the image alone, through interop: the committed bank's rows load
    c = arena_from_image(np.asarray(a._mm), a._meta, "cpu", **SHADOW)
    assert c.generation == 9 and bytes(c._mm) == bytes(np.asarray(a._mm))
    for name, r in c.regions.items():
        np.testing.assert_array_equal(_host(r.vol),
                                      a._pimage(a.regions[name]))


# ------------------------------------ integrity GRID: the ("shadow", 1) cells

@pytest.mark.parametrize("target", [("dll.nodes", 2, "order"),
                                    ("bt.nodes", 0, "leaves"),
                                    ("hm.entries", 3, None),
                                    ("bt.records", 4, None)])
def test_scrub_names_flip_and_stuck_line_shadow(tmp_path, target):
    TI._scrub_names(tmp_path, target, **SHADOW)


def test_scrub_under_traffic_no_false_positives_shadow(tmp_path):
    TI._scrub_under_traffic(tmp_path, **SHADOW)


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("boundary", [3, 7])
def test_corruption_crash_double_failure_shadow(tmp_path, torn, boundary):
    TI._double_failure(tmp_path, torn, boundary, **SHADOW)


@pytest.mark.parametrize("mode", ["partly", "full"])
@pytest.mark.parametrize("victim", ["dll", "bt", "hm"])
def test_mixed_salvage_matches_reference_shadow(tmp_path, mode, victim):
    TI._mixed_salvage(tmp_path, mode, victim, **SHADOW)


def test_remapped_fault_verifies_like_reference(tmp_path):
    """The shadow case of the reference's commit-mode-parametrized fault
    check (``tests/test_integrity.py:176``): a flip on a DLL row the
    authoritative bank remaps is named by ``verify_region`` in both
    packages.  Its paged half (a demand fault refusing the block) waits
    for paging."""
    out = {}
    for pkg in PKG:
        a, d, t, h = _mixed(pkg, str(tmp_path / pkg))
        TI._run(a, d, t, h, TI._script(12, seed=1))
        _rewrite_all(a, d, t, h)
        row = _remapped(a, "dll.nodes")
        a.crash()
        PKG[pkg][1].flip_bits(a, a.regions["dll.nodes"], row, byte=8,
                              mask=0x04)
        a.reopen()
        bad = a.verify_region("dll.nodes")
        assert row in bad.tolist()
        out[pkg] = (row, bad.tolist())
    assert out["port"] == out["ref"]
