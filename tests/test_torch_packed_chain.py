"""The chain kernels' shard-major packed layout (``segments=``,
``seg_rows=``, DESIGN.md §7) in repro_torch, against the JAX reference.

A sharded region's NEXT column arrives as the shards' persistent views
concatenated; pointer values stay global ids.  On CPU tensors the four
wrappers take their plain versions, held here:

* ``jump_double`` and ``gather_next`` with ``segments`` against the
  reference's Pallas kernels in interpret mode (they steer through
  ``BlockSpec``), at the reference test's shapes (203, 8, 3),
  (256, 64, 4) and (40, 16, 4), torn pointers included;
* ``walk_segments`` and ``expand_segments`` with ``segments`` against the
  port's own global-layout plain versions on the same chain (the
  reference's packed contraction calls ``pl.load``, which this jax does
  not export), and the packed contraction and doubling rankings against
  the reference's HOST ``chain_order`` on the global column;
* ``packed_positions`` against the reference's, and packed-vs-global
  ranking, by hypothesis;
* the packed API on a sharded DLL's per-shard persistent views, as the
  reference's ``test_chain_order_device_segments_from_sharded_dll``.

Integer results, compared exactly (tolerance 0).  ``chip_smoke.py`` holds
the CUDA kernels against the same plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import recovery as RR
from repro.kernels import chain_order as jco
from repro_torch.core import arena as TA
from repro_torch.core import recovery as TR
from repro_torch.kernels import chain_order as tco
from repro_torch.pstruct import dll as TD

NULL = -1
SHAPES = [(203, 8, 3), (256, 64, 4), (40, 16, 4)]


def _pack(nxt, B, N):
    """(packed column, segments, packed position of each global id)."""
    n = nxt.shape[0]
    shard_of = (np.arange(n) // B) % N
    segments = np.zeros(N + 1, np.int64)
    packed = np.empty_like(nxt)
    off = 0
    for s in range(N):
        gidx = np.nonzero(shard_of == s)[0]
        packed[off:off + gidx.size] = nxt[gidx]
        segments[s] = off
        off += gidx.size
    segments[N] = off
    pos = jco.packed_positions(np.arange(n, dtype=np.int64), B, segments)
    return packed, segments, pos


def _chain(n, seed, torn=False):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    nxt = np.full(n, NULL, np.int64)
    nxt[perm[:-1]] = perm[1:]
    if torn:
        nxt[perm[n // 3]] = n + 5                # out of range: terminates
        nxt[perm[n // 2]] = NULL
    return nxt, int(perm[0])


@pytest.mark.parametrize("n,B,N", SHAPES)
def test_packed_positions_is_the_packing(n, B, N):
    nxt, _ = _chain(n, n)
    packed, segments, pos = _pack(nxt, B, N)
    ids = np.arange(-1, n, dtype=np.int64)
    np.testing.assert_array_equal(
        tco.packed_positions(ids, B, segments),
        jco.packed_positions(ids, B, segments))
    np.testing.assert_array_equal(
        tco.packed_positions(torch.from_numpy(ids), B, segments).numpy(),
        jco.packed_positions(ids, B, segments))
    np.testing.assert_array_equal(packed[pos], nxt)


@pytest.mark.parametrize("n,B,N", SHAPES)
@pytest.mark.parametrize("torn", [False, True])
def test_jump_double_packed_matches_pallas(n, B, N, torn):
    """Every round of one launch (``rounds=r, keep=True``) against r
    reference calls with the same segments, and the counts."""
    nxt, _ = _chain(n, n + 1, torn)
    packed, segments, _ = _pack(nxt, B, N)
    cnt = np.random.default_rng(n).integers(1, 5, n)
    rounds = n.bit_length()
    jump = np.where((packed >= 0) & (packed < n), packed, NULL)
    want_j, want_c = [jump.astype(np.int32)], None
    rj, rc = jnp.asarray(jump, jnp.int32), jnp.asarray(cnt, jnp.int32)
    for _ in range(rounds):
        rj, rc = jco.jump_double(rj, rc, segments=segments, seg_rows=B,
                                 interpret=True)
        want_j.append(np.asarray(rj))
    want_c = np.asarray(rc)
    levels, got_c = tco.jump_double(
        torch.from_numpy(jump.astype(np.int32)), torch.from_numpy(cnt),
        rounds=rounds, keep=True, segments=segments, seg_rows=B)
    np.testing.assert_array_equal(levels.numpy(), np.stack(want_j))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    # the plain version is what the wrapper took
    p_levels, p_c = tco.jump_double_plain(
        torch.from_numpy(jump.astype(np.int32)), torch.from_numpy(cnt),
        rounds=rounds, keep=True, segments=segments, seg_rows=B)
    assert torch.equal(p_levels, levels) and torch.equal(p_c, got_c)


@pytest.mark.parametrize("n,B,N", SHAPES)
def test_gather_next_packed_matches_pallas(n, B, N):
    nxt, _ = _chain(n, n + 2, torn=True)
    packed, segments, _ = _pack(nxt, B, N)
    sane = np.where((packed >= 0) & (packed < n), packed, NULL)
    ids = np.concatenate([np.random.default_rng(n).integers(-2, n + 3, 97),
                          [2 ** 32 + 3, -(2 ** 40)]]).astype(np.int64)
    want = np.asarray(jco.gather_next(jnp.asarray(sane, jnp.int32), ids,
                                      segments=segments, seg_rows=B,
                                      interpret=True))
    t_nxt = torch.from_numpy(sane.astype(np.int32))
    got = tco.gather_next(t_nxt, torch.from_numpy(ids), segments=segments,
                          seg_rows=B)
    np.testing.assert_array_equal(got.numpy(), want)
    # hops=h: each row is h one-hop reference calls
    walk, length = tco.gather_next(t_nxt, torch.from_numpy(ids), hops=5,
                                   segments=segments, seg_rows=B)
    cols = [ids]
    for t in range(5):
        cols.append(np.asarray(jco.gather_next(
            jnp.asarray(sane, jnp.int32), cols[-1], segments=segments,
            seg_rows=B, interpret=True), np.int64))
        np.testing.assert_array_equal(walk[t].numpy(), cols[-1])
    # the leading columns holding an in-range id in some lane
    assert length == sum(int(((c >= 0) & (c < n)).any()) for c in cols)


@pytest.mark.parametrize("n,B,N", SHAPES)
@pytest.mark.parametrize("torn", [False, True])
def test_walk_and_expand_packed_match_global(n, B, N, torn):
    """The packed walk (checkpoints included) and expand give what the
    global-layout plain versions give on the global column."""
    nxt, head = _chain(n, n + 3, torn)
    packed, segments, _ = _pack(nxt, B, N)
    g32 = tco.sanitize32(torch.from_numpy(nxt))
    p32 = tco.sanitize32(torch.from_numpy(packed))
    k = 8
    n_mult = (n + k - 1) // k
    starts = torch.cat([torch.arange(0, n, k), torch.tensor([head])]
                       ).to(torch.int32)
    kw = dict(k=k, head=head, n_mult=n_mult, promoted=head % k != 0,
              budget=64, marks=n)
    want = tco.walk_segments_plain(g32, starts, **kw)
    got = tco.walk_segments(p32, starts, segments=segments, seg_rows=B,
                            **kw)
    for w, g in zip(want[:3], got[:3]):
        assert torch.equal(w, g)
    assert torch.equal(want[3][0], got[3][0])
    assert torch.equal(want[3][1], got[3][1])
    # expand: runs from every spine node, up to 9 nodes each, tiling
    # disjoint output ranges
    rem = torch.full((starts.shape[0],), 9, dtype=torch.int32)
    posn = (torch.arange(starts.shape[0]) * 9).to(torch.int32)
    count = 9 * starts.shape[0]
    want_o = tco.expand_segments_plain(g32, starts, posn, rem, count)
    got_o = tco.expand_segments(p32, starts, posn, rem, count,
                                segments=segments, seg_rows=B)
    # positions past a run's chain end are never written: compare the
    # written ones
    ok = torch.zeros(count, dtype=torch.bool)
    ref = tco.gather_next_plain(g32, starts.long(), hops=8)[0]
    cols = torch.cat([starts[None], ref]).t()        # (lanes, 9) nodes
    for i in range(starts.shape[0]):
        live = int(((cols[i] >= 0).cumprod(0)).sum())
        ok[9 * i: 9 * i + live] = True
    assert torch.equal(got_o[ok], want_o[ok])


@pytest.mark.parametrize("n,B,N", SHAPES + [(5000, 64, 4), (3001, 64, 3)])
@pytest.mark.parametrize("method", ["double", "contract"])
def test_chain_order_packed_matches_host_reference(n, B, N, method):
    """chain_order(segments=) by both methods equals the reference's host
    primitive on the global column, with and without a count, with torn
    pointers, and adopts or refuses an order snapshot as it does."""
    for torn in (False, True):
        nxt, head = _chain(n, n + 4, torn)
        packed, segments, _ = _pack(nxt, B, N)
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
        bad = want.copy()
        bad[[0, -1]] = bad[[-1, 0]]
        snap = TR.ChainSnapshot(bad)
        assert TR.chain_order(tp, head, want.size, snapshot=snap,
                              **kw).tolist() == want.tolist()
        assert snap.outcome == method


@st.composite
def layouts(draw):
    n = draw(st.integers(1, 700))
    B = draw(st.sampled_from([1, 2, 3, 8, 16, 64]))
    N = draw(st.integers(1, 5))
    seed = draw(st.integers(0, 2 ** 16))
    return n, B, N, seed


@settings(max_examples=40, deadline=None)
@given(layouts())
def test_packed_ranking_matches_global_ranking(case):
    n, B, N, seed = case
    nxt, head = _chain(n, seed, torn=seed % 3 == 0)
    packed, segments, pos = _pack(nxt, B, N)
    ids = np.arange(-1, n + 1, dtype=np.int64)
    np.testing.assert_array_equal(tco.packed_positions(ids, B, segments),
                                  jco.packed_positions(ids, B, segments))
    np.testing.assert_array_equal(packed[pos], nxt)
    for method in ("double", "contract"):
        got = TR.chain_order(torch.from_numpy(packed), head, method=method,
                             k=4, segments=segments, seg_rows=B)
        want = TR.chain_order(torch.from_numpy(nxt), head, method=method,
                              k=4)
        assert torch.equal(got, want)


@pytest.mark.parametrize("method", ["double", "contract"])
def test_packed_api_on_sharded_dll_views(method, monkeypatch):
    """A sharded DLL's per-shard persistent NEXT views, concatenated with
    no host re-gather, rank to the DLL's order."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    a = TA.open_arena(None, TD.DoublyLinkedList.layout(256), n_shards=4,
                      device="cpu")
    d = TD.DoublyLinkedList(a, 256)
    rng = np.random.default_rng(3)
    ids = d.append_batch(rng.integers(0, 9, (180, 7)).astype(np.int64))
    d.delete_batch(ids[30:60])
    a.commit()
    region = a.regions["dll.nodes"]
    views = [sl._pview()[:, TD.DATA_WORDS] for sl in region.slices
             if sl is not None]
    segments = np.cumsum([0] + [v.shape[0] for v in views])
    got = TR.chain_order(torch.from_numpy(np.concatenate(views)), d.head,
                         d.count, method=method, k=16, segments=segments,
                         seg_rows=TD.SHARD_SEG)
    assert got.tolist() == d.to_list().tolist()
