"""Multi-step chain kernels of repro_torch vs the JAX reference.

``jump_double(rounds=r)`` runs r doubling rounds in one launch and
``gather_next(hops=h)`` walks h hops in one; ``chain_tables``,
``_absorb`` and ``chain_walk`` make one launch of them where they made
one per round or per column.  Here, on CPU tensors, the wrappers take
their plain versions, which are held against repeated calls of the
reference's Pallas kernels in interpret mode and against the reference's
host ``chain_walk``.  All results are integers, compared exactly
(tolerance 0).  ``chip_smoke.py`` holds the CUDA kernels against the same
plain versions on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import recovery as R
from repro.kernels import chain_order as jco
from repro_torch.core import recovery as TR
from repro_torch.kernels import _build, launch_counts, launch_steps
from repro_torch.kernels import chain_order as tco
from repro_torch.kernels import reset_launch_counts

NULL = -1


def _faulty_chain(n, seed):
    """int32 pointers over n nodes: a permutation chain with a NULL cut,
    values out of range at both ends of int32, and a short cycle."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    nxt = np.full(n, NULL, np.int64)
    nxt[perm[:-1]] = perm[1:]
    if n >= 6:
        nxt[perm[n // 3]] = NULL
        nxt[perm[n // 2]] = n + 7
        nxt[perm[2 * n // 3]] = 2 ** 31 - 1
        nxt[perm[-2]] = perm[-4]                 # cycle
    else:
        nxt[perm[-1]] = perm[0]                  # the whole chain cycles
    return nxt.astype(np.int32)


_levels_cache = {}


def _pallas_levels(n):
    """Levels 0..n.bit_length() of the reference's jump_double, one
    interpret-mode call per round, with their counts."""
    if n not in _levels_cache:
        jump = jnp.asarray(_faulty_chain(n, n))
        cnt = jnp.asarray(np.random.default_rng(n + 1).integers(
            1, 5, n).astype(np.int32))
        levels, counts = [np.asarray(jump)], [np.asarray(cnt)]
        for _ in range(n.bit_length()):
            jump, cnt = jco.jump_double(jump, cnt, interpret=True)
            levels.append(np.asarray(jump))
            counts.append(np.asarray(cnt))
        _levels_cache[n] = (np.stack(levels), np.stack(counts))
    return _levels_cache[n]


# ------------------------------------------------------------ jump_double

@pytest.mark.parametrize("n,r", [(1, 1), (61, 1), (61, 2), (61, 3),
                                 (61, 6), (512, 1), (512, 4), (512, 7),
                                 (512, 10)])
def test_jump_double_rounds_keep_matches_pallas_rounds(n, r):
    """rounds=r, keep=True: the (r + 1, n) table equals level 0 (the input,
    as given) and r successive reference calls; the counts equal the
    reference's after r rounds."""
    want_j, want_c = _pallas_levels(n)
    jump = torch.from_numpy(want_j[0].copy())
    cnt = torch.from_numpy(want_c[0].astype(np.int64))
    levels, c = tco.jump_double(jump, cnt, rounds=r, keep=True)
    assert levels.dtype == torch.int32 and levels.shape == (r + 1, n)
    np.testing.assert_array_equal(levels.numpy(), want_j[:r + 1])
    np.testing.assert_array_equal(c.numpy(), want_c[r])
    # without keep: the last level and the same counts
    j, c2 = tco.jump_double(jump, cnt, rounds=r)
    np.testing.assert_array_equal(j.numpy(), want_j[r])
    np.testing.assert_array_equal(c2.numpy(), want_c[r])
    # without counts: the jumps alone
    levels0, none = tco.jump_double(jump, rounds=r, keep=True)
    assert none is None
    np.testing.assert_array_equal(levels0.numpy(), want_j[:r + 1])


@pytest.mark.parametrize("n", [61, 512])
def test_jump_double_rounds_equal_repeated_single_rounds(n):
    """The plain version of r rounds is r applications of one round."""
    jump = torch.from_numpy(_faulty_chain(n, 3 * n))
    cnt = torch.from_numpy(np.random.default_rng(n).integers(
        1, 9, n).astype(np.int64))
    j, c = jump, cnt
    for r in range(1, n.bit_length() + 1):
        j, c = tco.jump_double(j, c)
        rj, rc = tco.jump_double(jump, cnt, rounds=r)
        np.testing.assert_array_equal(rj.numpy(), j.numpy())
        np.testing.assert_array_equal(rc.numpy(), c.numpy())


def test_jump_double_rounds_poison_sums_exactly_in_int64():
    """contract_walk's POISON weights (n + 1 on a spine-free cycle) and
    weights past int32 still sum exactly over every round."""
    n = 64
    nxt = np.arange(1, n + 1, dtype=np.int64)
    nxt[-1] = NULL                                # one chain 0 -> ... -> 63
    jump = torch.from_numpy(nxt.astype(np.int32))
    w = torch.full((n,), 2 ** 40 + 3, dtype=torch.int64)
    w[5] = n + 1
    _, c = tco.jump_double(jump, w, rounds=n.bit_length())
    want = torch.flip(torch.cumsum(torch.flip(w, [0]), 0), [0])
    np.testing.assert_array_equal(c.numpy(), want.numpy())


@pytest.mark.parametrize("n,bits", [(1, 1), (61, 1), (61, 4), (61, 6),
                                    (512, 3), (512, 9), (512, 10)])
def test_chain_tables_matches_reference_device_tables(n, bits):
    """One launch of bits rounds (the extra round's level dropped) gives
    the reference's chain_tables_device tables and counts; without counts
    bits - 1 rounds give the same tables."""
    nxt = _faulty_chain(n, n + bits).astype(np.int64)
    nxt[0] = 2 ** 32 + 3                          # torn: NULL, not node 3
    want_t, want_c = jco.chain_tables_device(nxt, bits, interpret=True)
    jump0 = tco.sanitize32(torch.from_numpy(nxt))
    tables, cnt = tco.chain_tables(jump0, bits,
                                   torch.ones(n, dtype=torch.int64))
    assert tables.shape == (bits, n)
    np.testing.assert_array_equal(tables.numpy(), np.stack(want_t))
    np.testing.assert_array_equal(cnt.numpy(), want_c)
    tables2, none = tco.chain_tables(jump0, bits)
    assert none is None
    np.testing.assert_array_equal(tables2.numpy(), np.stack(want_t))
    np.testing.assert_array_equal(
        TR.jump_tables(torch.from_numpy(nxt), bits).numpy(),
        R.jump_tables(nxt, bits))


# ------------------------------------------------------------ gather_next

def _unsanitized(n, lanes, seed, ids_dtype):
    rng = np.random.default_rng(seed)
    nxt = rng.integers(-1, n, n).astype(np.int32)
    nxt[::7] = n + 5
    nxt[1::11] = -9
    ids = rng.integers(-3, n + 3, lanes).astype(np.int64)
    ids[:3] = [-1, n, 0]
    if ids_dtype == np.int64:
        ids[3:6] = [2 ** 32 + 3, 2 ** 40, -(2 ** 33)]
    return nxt, ids.astype(ids_dtype)


@pytest.mark.parametrize("ids_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("hops", [1, 2, 8])
@pytest.mark.parametrize("n,lanes", [(97, 130), (300, 64)])
def test_gather_next_hops_match_pallas_hops(ids_dtype, hops, n, lanes):
    """hops=h equals h successive reference calls, each fed the stored
    values the last returned (so an out-of-range value ends the walk at
    the next hop); the length is the leading columns holding an id in
    range."""
    nxt, ids = _unsanitized(n, lanes, n * lanes + hops, ids_dtype)
    cols, cur = [ids], ids
    for _ in range(hops):
        cur = np.asarray(jco.gather_next(jnp.asarray(nxt), cur,
                                         interpret=True))
        cols.append(cur)
    got = tco.gather_next(torch.from_numpy(nxt), torch.from_numpy(ids),
                          hops=hops)
    if hops == 1:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), cols[1])
        return
    walk, length = got
    assert walk.dtype == torch.int32 and walk.shape == (hops, lanes)
    np.testing.assert_array_equal(walk.numpy(), np.stack(cols[1:]))
    live = [bool(((c >= 0) & (c < n)).any()) for c in cols]
    assert length == sum(live)
    assert live == [True] * length + [False] * (hops + 1 - length)


def test_gather_next_hops_walk_ends_and_length():
    # 0 -> 1 -> 2 -> NULL; 3 -> 9 (stored out of range); 4 -> 4 (cycle)
    nxt = torch.tensor([1, 2, -1, 9, 4], dtype=torch.int32)
    ids = torch.tensor([0, 3, 2 ** 32 + 3], dtype=torch.int64)
    walk, length = tco.gather_next(nxt, ids, hops=4)
    assert walk.tolist() == [[1, 9, -1], [2, -1, -1], [-1, -1, -1],
                             [-1, -1, -1]]
    assert length == 3            # ids, then 1 and 2 hops hold an id in range
    walk, length = tco.gather_next(nxt, torch.tensor([4, 0]), hops=3)
    assert walk.tolist() == [[4, 1], [4, 2], [4, -1]]
    assert length == 4            # still live after the last hop
    walk, length = tco.gather_next(nxt, torch.tensor([-1, 7]), hops=2)
    assert walk.tolist() == [[-1, -1], [-1, -1]] and length == 0
    walk, length = tco.gather_next(nxt, torch.tensor([], dtype=torch.int64),
                                   hops=3)
    assert walk.shape == (3, 0) and length == 0


# ------------------------------------------------------------- chain_walk

def _chains(n, lengths, seed, extra_heads=()):
    """NEXT over n nodes holding disjoint chains of the given lengths
    (nodes drawn at random); returns (nxt int64, heads int64)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    nxt = np.full(n, NULL, np.int64)
    heads, at = [], 0
    for ln in lengths:
        seg = perm[at:at + ln]
        nxt[seg[:-1]] = seg[1:]
        heads.append(int(seg[0]))
        at += ln
    return nxt, np.asarray(heads + list(extra_heads), np.int64)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("longest", [127, 128, 129])
def test_chain_walk_escalation_boundary_matches_reference(longest,
                                                          monkeypatch):
    """Over n = 2**17 with 12 heads, "auto" walks level-synchronously
    while column 128 is dead and escalates to the shared contraction once
    it is live: a chain of 129 nodes escalates, 128 does not, in both
    packages; the member matrices are equal either way."""
    n = 1 << 17
    nxt, heads = _chains(n, [longest, 1, 2, 7, 8, 9, 30, 64, 100],
                         longest, extra_heads=(-1, n, 2 ** 32 + 3))
    ref_esc = _spy(monkeypatch, R, "_walk_contract")
    port_esc = _spy(monkeypatch, TR, "_walk_contract")
    hops = []
    real = tco.gather_next

    def counted(nxt32, ids, **kw):
        hops.append(kw.get("hops", 1))
        return real(nxt32, ids, **kw)

    monkeypatch.setattr(tco, "gather_next", counted)
    want = R.chain_walk(nxt, heads)
    got = TR.chain_walk(torch.from_numpy(nxt), heads)
    assert got.dtype == torch.int64 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.shape == (heads.size, longest)
    escalated = longest > R._WALK_ESCALATE_ROUNDS
    assert len(ref_esc) == len(port_esc) == int(escalated)
    # budgets 8, 16, 32, 64, then capped at column 128: 8
    assert hops == [8, 16, 32, 64, 8]


@pytest.mark.parametrize("longest,launches", [(1, 1), (8, 1), (9, 2),
                                              (24, 2), (25, 3), (56, 3),
                                              (57, 4), (300, 6)])
def test_chain_walk_launches_per_walk(longest, launches, monkeypatch):
    """A walk of L columns takes 1 + ceil(log2(L / 8)) hop-blocked
    launches at most (budgets 8, 16, 32, ... from the heads), never one
    per column."""
    n = 4096                       # below CONTRACT_MIN_N: never escalates
    nxt, heads = _chains(n, [longest, 3, 1], longest)
    hops = []
    real = tco.gather_next

    def counted(nxt32, ids, **kw):
        hops.append(kw.get("hops", 1))
        return real(nxt32, ids, **kw)

    monkeypatch.setattr(tco, "gather_next", counted)
    got = TR.chain_walk(torch.from_numpy(nxt), heads)
    np.testing.assert_array_equal(got.numpy(), R.chain_walk(nxt, heads))
    assert len(hops) == launches
    assert launches <= 1 + max(0, math.ceil(math.log2(longest / 8)))
    assert hops == [8 * 2 ** i for i in range(launches)]


@pytest.mark.parametrize("n,cycle_at", [(1, 0), (7, 2), (50, 10),
                                        (300, 200)])
def test_chain_walk_cycle_raises_like_reference(n, cycle_at):
    """A cycle reachable from a head: both packages raise once column n is
    live; the walk is capped there, however far the budgets doubled."""
    perm = np.random.default_rng(n).permutation(n)
    nxt = np.full(n, NULL, np.int64)
    nxt[perm[:-1]] = perm[1:]
    nxt[perm[-1]] = perm[cycle_at]
    heads = np.asarray([perm[0], -1], np.int64)
    with pytest.raises(RuntimeError, match="cycle in chain"):
        R.chain_walk(nxt, heads)
    with pytest.raises(RuntimeError, match="cycle in chain"):
        TR.chain_walk(torch.from_numpy(nxt), heads)


def test_chain_walk_escalated_cycle_raises_like_reference(monkeypatch):
    """Few heads over a big table: a cycle longer than 128 columns
    escalates in both packages, and the contraction finds the cycle."""
    n = 1 << 17
    nxt, heads = _chains(n, [400, 5], 9)
    # close the 400-node chain into a cycle at its 50th node
    cur = int(heads[0])
    order = [cur]
    while nxt[cur] != NULL:
        cur = int(nxt[cur])
        order.append(cur)
    nxt[order[-1]] = order[50]
    ref_esc = _spy(monkeypatch, R, "_walk_contract")
    port_esc = _spy(monkeypatch, TR, "_walk_contract")
    with pytest.raises(RuntimeError, match="cycle in chain"):
        R.chain_walk(nxt, heads)
    with pytest.raises(RuntimeError, match="cycle in chain"):
        TR.chain_walk(torch.from_numpy(nxt), heads)
    assert len(ref_esc) == len(port_esc) == 1


@pytest.mark.parametrize("heads", [[-1, 5, 2 ** 32 + 3, -7],
                                   [3, -1, 11, 4], []])
def test_chain_walk_out_of_range_and_empty_match_reference(heads):
    """Heads outside [0, n) are NULL rows; all of them gives an (H, 0)
    matrix, and so do no heads at all."""
    n = 12
    nxt = np.array([1, 2, NULL, 4, NULL, 6, 7, 2 ** 32 + 3, NULL, NULL,
                    NULL, 0], np.int64)
    hs = np.asarray(heads, np.int64)
    want = R.chain_walk(nxt, hs)
    got = TR.chain_walk(torch.from_numpy(nxt), hs)
    assert got.dtype == torch.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_chain_walk_empty_table_matches_reference():
    nxt = np.zeros(0, np.int64)
    hs = np.asarray([0, -1, 3], np.int64)
    want = R.chain_walk(nxt, hs)
    got = TR.chain_walk(torch.from_numpy(nxt), hs)
    assert got.shape == want.shape == (3, 0)


# ------------------------------------------------------------ the wrappers

def test_multi_step_wrappers_check_steps_types_and_devices():
    j = torch.tensor([1, -1], dtype=torch.int32)
    with pytest.raises(ValueError, match="rounds"):
        tco.jump_double(j, rounds=0)
    with pytest.raises(ValueError, match="hops"):
        tco.gather_next(j, torch.tensor([0]), hops=0)
    with pytest.raises(TypeError):
        tco.jump_double(j.long(), rounds=2)
    with pytest.raises(ValueError):
        tco.jump_double(j, torch.ones(3, dtype=torch.int64), rounds=2)
    with pytest.raises(TypeError):
        tco.gather_next(j, torch.tensor([0.0]), hops=2)
    with pytest.raises(ValueError):
        tco.gather_next(j, torch.tensor([0], device="meta"), hops=2)
    with pytest.raises(RuntimeError, match="no kernel"):
        tco.jump_double(j.to("meta"), rounds=3, keep=True)
    with pytest.raises(RuntimeError, match="no kernel"):
        tco.gather_next(j.to("meta"), torch.tensor([0], device="meta"),
                        hops=2)


def test_cpu_tensors_launch_nothing():
    reset_launch_counts()
    j = torch.tensor([1, 2, -1], dtype=torch.int32)
    tco.jump_double(j, torch.ones(3, dtype=torch.int64), rounds=3,
                    keep=True)
    tco.gather_next(j, torch.tensor([0]), hops=4)
    TR.chain_walk(j.long(), [0, 2])
    counts = launch_counts()
    assert counts["jump_double"] == counts["gather_next"] == 0
    assert launch_steps() == {"jump_double": {}, "gather_next": {}}


def test_steps_histogram_by_size():
    def fake():
        pass

    fake.launches, fake.sizes, fake.steps = 0, {}, {}
    for size, steps in ((8192, 8), (8000, 8), (8192, 16), (131073, 18),
                        (5, None)):
        _build.note_launch(fake, size, steps=steps)
    assert fake.launches == 5
    assert fake.sizes == {8192: 3, 262144: 1, 8: 1}
    assert fake.steps == {8192: {8: 2, 16: 1}, 262144: {18: 1}}
