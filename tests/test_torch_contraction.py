"""The contraction list ranking of repro_torch vs the JAX reference.

``contract_walk`` walks a whole contraction in one ``walk_segments``
launch (the budget the round driver reached in rounds of
``budget0 = max(2k, 64)`` hops) and records every ``MARK_STRIDE``-th node
of each segment; ``_expand_plan`` splits the used segments at those
checkpoints, so no ``expand_segments`` run is longer than MARK_STRIDE.
Here, on CPU tensors, the wrappers take their plain versions, which are
held against the round driver the port ran before (kept below as a test
helper), a hop-by-hop stepping of each segment, the reference's host
primitives (``repro.core.recovery``) and its device pipeline in interpret
mode.  Integer results, compared exactly (tolerance 0).  ``chip_smoke.py``
holds the CUDA kernels against the same plain versions on the card.
"""
import numpy as np
import pytest
import torch

from repro.core import recovery as R
from repro.kernels import chain_order as jco
from repro_torch.core import recovery as TR
from repro_torch.kernels import chain_order as tco

NULL = -1
STRIDE = tco.MARK_STRIDE


def _rounds(nxt32, spine, *, k, head, n_mult, promoted, spine_pos=None):
    """contract_walk as the port ran it before it was one launch: rounds
    of budget0 hops through walk_segments_plain, the lanes that arrived
    or ended retired between rounds, until every segment closed or n hops
    proved a spine-free cycle (POISON n + 1)."""
    n = nxt32.shape[0]
    S = spine.shape[0]
    cnext = torch.full((S,), NULL, dtype=torch.int32)
    w = torch.zeros(S, dtype=torch.int64)
    lanes = torch.arange(S)
    cur = spine.to(torch.int32)
    budget = max(2 * k, 64)
    hops = 0
    while lanes.numel() and hops <= n:
        c2, sp, wd = tco.walk_segments_plain(
            nxt32, cur.contiguous(), k=k, head=head, n_mult=n_mult,
            promoted=promoted, budget=budget, spine_pos=spine_pos)
        w[lanes] += wd.long()
        arrived = sp >= 0
        cnext[lanes[arrived]] = sp[arrived]
        alive = (c2 >= 0) & ~arrived
        lanes = lanes[alive]
        cur = c2[alive]
        hops += budget
    if lanes.numel():
        w[lanes] = n + 1
    return cnext, torch.clamp(w, min=1)


def _spine(n, heads, k):
    """The spine and walk arguments _contract builds for these heads."""
    heads = torch.as_tensor(heads, dtype=torch.int64)
    spine = torch.arange(0, n, k, dtype=torch.int64)
    extra = torch.unique(heads[heads % k != 0])
    spine = torch.cat([spine, extra])
    spine_pos = None
    if extra.numel() > 1:
        spine_pos = torch.full((n,), NULL, dtype=torch.int32)
        spine_pos[spine] = torch.arange(spine.shape[0], dtype=torch.int32)
    kw = dict(k=k, head=int(extra[0]) if extra.numel() == 1 else NULL,
              n_mult=(n + k - 1) // k, promoted=extra.numel() == 1,
              spine_pos=spine_pos)
    return spine, kw


def _perm_chain(n, seed, live=None):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)[:live or n]
    nxt = np.full(n, NULL, np.int64)
    nxt[perm[:-1]] = perm[1:]
    return nxt, perm


def _segments_of(lengths, k, n):
    """A chain 0 -> ... through the spine nodes 0, k, 2k, ..., where the
    segment from spine node j*k takes lengths[j] hops to the next spine
    node (lengths[j] - 1 non-spine nodes between), the last segment
    ending in NULL; the non-spine ids are taken in order."""
    free = iter([i for i in range(n) if i % k])
    nxt = np.full(n, NULL, np.int64)
    for j, ln in enumerate(lengths):
        cur = j * k
        for _ in range(ln - 1):
            v = next(free)
            nxt[cur] = v
            cur = v
        nxt[cur] = (j + 1) * k if j + 1 < len(lengths) else NULL
    return nxt


def _cases():
    """{name: (nxt int64, heads, k)}."""
    out = {}
    for k in (4, 7, 32):
        nxt, perm = _perm_chain(2000, k)
        nxt[perm[700]] = NULL                    # two chains
        out[f"random_k{k}"] = (nxt, [int(perm[0])], k)
    for k in (32, 40):                           # budget0 64 and 80
        b0 = max(2 * k, 64)
        lengths = [b0, b0 - 1, b0 + 1, 2 * b0, 1, 2 * b0 + 1, 3]
        n = k * (len(lengths) + 1) + sum(lengths) + 8
        out[f"budget0_boundaries_k{k}"] = (
            _segments_of(lengths, k, n), [0], k)
    # a spine-free cycle (k = 32): 0 -> 1 -> 2 -> 3 -> 1, nothing else
    sf = np.full(64, NULL, np.int64)
    sf[0], sf[1], sf[2], sf[3] = 1, 2, 3, 1
    out["spine_free_cycle"] = (sf, [0], 32)
    # a long spine-free cycle entered from two spine nodes
    lf = np.full(512, NULL, np.int64)
    ring = [i for i in range(1, 512) if i % 32][:150]
    lf[ring[:-1]] = ring[1:]
    lf[ring[-1]] = ring[0]
    lf[0], lf[64] = ring[0], ring[70]
    out["spine_free_cycle_long"] = (lf, [0], 32)
    # a cycle through a spine node: the walk arrives, the rank sees it
    cy, perm = _perm_chain(1000, 5)
    cy[perm[-1]] = perm[200]
    out["cycle_through_spine"] = (cy, [int(perm[0])], 32)
    # torn pointers: 2**32 + 3 ends the chain, it does not alias node 3
    tn, perm = _perm_chain(1500, 6)
    tn[perm[300]] = 2 ** 32 + 3
    tn[perm[900]] = 1500 + 7
    tn[perm[1200]] = -2 ** 40
    out["torn"] = (tn, [int(perm[0])], 32)
    # a promoted head (head % k != 0)
    ph, perm = _perm_chain(1200, 8)
    if perm[0] % 32 == 0:
        perm[[0, 1]] = perm[[1, 0]]
        ph = np.full(1200, NULL, np.int64)
        ph[perm[:-1]] = perm[1:]
    out["promoted_head"] = (ph, [int(perm[0])], 32)
    # several promoted heads: spine membership through spine_pos
    mh = np.full(1500, NULL, np.int64)
    perm = np.random.default_rng(9).permutation(1500)
    heads = []
    for seg in np.split(perm, [300, 301, 900, 1111]):
        mh[seg[:-1]] = seg[1:]
        heads.append(int(seg[0]))
    out["several_heads"] = (mh, heads, 32)
    return out


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_contract_walk_one_launch_matches_round_driver(name, monkeypatch):
    """One walk_segments call gives the round driver's (cnext, w), POISON
    and budget0 boundaries included, and the reference host _contract's."""
    nxt, heads, k = CASES[name]
    n = nxt.shape[0]
    nxt32 = tco.sanitize32(torch.from_numpy(nxt))
    spine, kw = _spine(n, heads, k)
    calls = []
    real = tco.walk_segments

    def spy(*a, **kws):
        calls.append(kws.get("budget"))
        return real(*a, **kws)
    monkeypatch.setattr(tco, "walk_segments", spy)
    cnext, w, _ = tco.contract_walk(nxt32, spine, **kw)
    b0 = max(2 * k, 64)
    assert calls == [b0 * -(-(n + 1) // b0)]
    want_c, want_w = _rounds(nxt32, spine, **kw)
    np.testing.assert_array_equal(cnext.numpy(), want_c.numpy())
    np.testing.assert_array_equal(w.numpy(), want_w.numpy())
    _, _, ref_c, ref_w = R._contract(R._sanitize32(nxt),
                                     np.asarray(heads, np.int64), k)
    np.testing.assert_array_equal(cnext.numpy(), ref_c)
    np.testing.assert_array_equal(w.numpy(), ref_w)
    if name.startswith("spine_free"):
        assert int(w.max()) == n + 1             # POISON
    if name.startswith("budget0"):
        assert sorted(set(w.tolist()) & {b0 - 1, b0, b0 + 1, 2 * b0}) == [
            b0 - 1, b0, b0 + 1, 2 * b0]


def _stepped_marks(nxt32, starts, budget, kw):
    """Every (lane, hop, node) checkpoint by stepping each lane alone."""
    n = nxt32.shape[0]
    nx = nxt32.numpy()
    spos = kw["spine_pos"].numpy() if kw["spine_pos"] is not None else None
    out = set()
    for lane, cur in enumerate(starts.tolist()):
        if cur < 0:
            continue
        for t in range(1, budget + 1):
            cur = int(nx[cur]) if 0 <= cur < n else NULL
            if not 0 <= cur < n:
                break
            if spos is not None:
                if spos[cur] >= 0:
                    break
            elif cur % kw["k"] == 0 or (kw["promoted"] and
                                        cur == kw["head"]):
                break
            if t == budget:
                break
            if t % STRIDE == 0:
                out.add((lane, t, cur))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_walk_checkpoints_equal_stepping_each_segment(name):
    """The records of the one-launch walk, as a set, are every
    MARK_STRIDE-th node strictly inside each segment; a smaller buffer
    stores a subset and still counts them all."""
    nxt, heads, k = CASES[name]
    n = nxt.shape[0]
    nxt32 = tco.sanitize32(torch.from_numpy(nxt))
    spine, kw = _spine(n, heads, k)
    _, _, marks = tco.contract_walk(nxt32, spine, **kw)
    budget = marks.walk["budget"]
    want = _stepped_marks(nxt32, spine, budget, kw)
    total = int(marks.total[0])
    assert total == len(want)
    cap = marks.rec.shape[1]
    got = {tuple(r) for r in marks.rec[:, :min(total, cap)].t().tolist()}
    if name.startswith("spine_free"):
        # a spine-free cycle is entered through a node with two
        # predecessors: its lanes record more than a chain's buffer holds
        assert total > cap and len(got) == cap and got <= want
    else:
        assert total <= cap and got == want
    if total > 1:
        small = tco.walk_segments(nxt32, spine.to(torch.int32),
                                  budget=budget, marks=total // 2, **kw)[3]
        assert int(small[1][0]) == total
        assert {tuple(r) for r in small[0].t().tolist()} <= want


def _plan_and_expand(nxt, head, count, k):
    """The split and the unsplit plan of chain_order's contraction, and
    each one's expand."""
    nxt32 = tco.sanitize32(torch.from_numpy(nxt))
    spine, hpos, cnext, w, marks = TR._contract(
        nxt32, torch.tensor([head]), k)
    cjump = TR._contract_tables(cnext, min(count, spine.shape[0]))
    plans = {"split": TR._expand_plan(spine, cjump, w, int(hpos[0]), count,
                                      marks),
             "whole": TR._expand_plan(spine, cjump, w, int(hpos[0]), count)}
    return plans, {name: tco.expand_segments(nxt32, *p, count)
                   for name, p in plans.items()}


def _tiles(plan, count):
    """The plan's runs cover every position of [0, count) exactly once."""
    _, posn, rem = (x.long() for x in plan)
    cover = torch.cat([torch.arange(p, p + r) for p, r in
                       zip(posn.tolist(), rem.tolist()) if r > 0])
    return torch.equal(torch.sort(cover)[0], torch.arange(count))


@pytest.mark.parametrize("n,live,k,pallas", [
    (96, 71, 4, True), (150, 150, 7, True), (128, 120, 32, True),
    (3000, 2500, 32, False), (2048, 2048, 4, False), (777, 600, 7, False)])
def test_split_plan_expand_matches_unsplit_and_references(n, live, k,
                                                          pallas):
    """The split plan's runs are at most MARK_STRIDE long and tile
    [0, count); its expand equals the unsplit plan's, the reference's
    host chain_order and (small chains) its device pipeline in interpret
    mode, at counts that end inside a run."""
    nxt, perm = _perm_chain(n, n + k, live)
    head = int(perm[0])
    for count in sorted({live, live - 1, live // 2 + 3, STRIDE + 5, 1}):
        plans, orders = _plan_and_expand(nxt, head, count, k)
        split = plans["split"]
        assert int(split[2].max()) <= STRIDE
        assert _tiles(split, count) and _tiles(plans["whole"], count)
        np.testing.assert_array_equal(orders["split"].numpy(),
                                      orders["whole"].numpy())
        np.testing.assert_array_equal(orders["split"].numpy(), perm[:count])
        np.testing.assert_array_equal(
            TR.chain_order(torch.from_numpy(nxt), head, count,
                           method="contract", k=k).numpy(),
            R.chain_order(nxt, head, count, method="contract", k=k))
    if pallas:                                   # the last count: live
        np.testing.assert_array_equal(
            orders["split"].numpy(),
            jco.chain_order_device(nxt, head, method="contract", k=k,
                                   fuse=False, interpret=True))


def test_split_plan_cuts_count_inside_a_run():
    """A count that ends inside a sub-run (not at a checkpoint, not at a
    segment end) shortens only that run."""
    k = 32
    nxt = _segments_of([64, 64, 64], k, 300)
    order = R.chain_order(nxt, 0, method="double")
    for count in (64 + 16 + 7, 64 + 33, 2 * 64 + 47):
        plans, orders = _plan_and_expand(nxt, 0, count, k)
        rem = plans["split"][2]
        assert int(rem.max()) <= STRIDE and int(rem.sum()) == count
        assert (count - 64) % STRIDE in set(rem.tolist())
        np.testing.assert_array_equal(orders["split"].numpy(), order[:count])


def _expand_spy(monkeypatch):
    """Record the largest run of every expand_segments call."""
    seen = []
    real = tco.expand_segments

    def spy(nxt, starts, posn, rem, count):
        seen.append(int(rem.max()) if rem.numel() else 0)
        return real(nxt, starts, posn, rem, count)
    monkeypatch.setattr(tco, "expand_segments", spy)
    return seen


@pytest.mark.parametrize("method", ["contract", "auto"])
def test_chain_lengths_and_walk_contract_equal_host(method, monkeypatch):
    """chain_lengths and chain_walk's shared contraction (_walk_contract,
    one expand per head) equal the host primitives; every expand run is
    split."""
    rng = np.random.default_rng(12)
    n = 3000
    nxt = np.full(n, NULL, np.int64)
    perm = rng.permutation(n)
    heads = []
    for seg in np.split(perm, [40, 41, 700, 1900]):
        nxt[seg[:-1]] = seg[1:]
        heads.append(int(seg[0]))
    hs = np.asarray(heads + [NULL, 5 * n], np.int64)
    t = torch.from_numpy(nxt)
    np.testing.assert_array_equal(
        TR.chain_lengths(t, hs, method="contract", k=32).numpy(),
        R.chain_lengths(nxt, hs, method="contract", k=32))
    runs = _expand_spy(monkeypatch)
    calls = []
    real = TR._walk_contract

    def walk_contract(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(TR, "_walk_contract", walk_contract)
    got = TR.chain_walk(t, hs, method=method, k=32).numpy()
    np.testing.assert_array_equal(got, R.chain_walk(nxt, hs, method="contract",
                                                    k=32))
    if method == "contract":
        assert calls == [1] and len(runs) == 5   # one expand per live head
    assert all(r <= STRIDE for r in runs)


def _merged(n=4096, k=32, path_len=300):
    """Every spine node points into one long spine-free path: the
    segments merge, and their checkpoints outgrow a chain's buffer."""
    nxt, _ = _perm_chain(n, 4)
    path = np.array([i for i in range(1, n) if i % k][:path_len])
    nxt[np.arange(0, n, k)] = path[0]
    nxt[path[:-1]] = path[1:]
    nxt[path[-1]] = NULL
    return nxt


@pytest.mark.parametrize("count", [None, 5, 37, 100, 301, 302])
def test_plan_walks_again_when_checkpoints_overflow(count, monkeypatch):
    """Torn pointers that merge segments fill the checkpoint buffer: the
    plan walks its segments again (one more walk, exactly sized) and the
    order equals the reference's; runs stay within MARK_STRIDE."""
    nxt = _merged()
    walks = []
    real = tco.walk_segments

    def spy(*a, **kw):
        walks.append(kw.get("marks"))
        return real(*a, **kw)
    monkeypatch.setattr(tco, "walk_segments", spy)
    runs = _expand_spy(monkeypatch)
    t = torch.from_numpy(nxt)
    try:
        got = TR.chain_order(t, 0, count, method="contract").numpy()
    except ValueError:
        with pytest.raises(ValueError):
            R.chain_order(nxt, 0, count, method="contract")
        return
    np.testing.assert_array_equal(
        got, R.chain_order(nxt, 0, count, method="contract"))
    capacity = -(-nxt.shape[0] // STRIDE) + nxt.shape[0] // 32
    assert len(walks) == 2 and walks[0] == capacity
    assert all(r <= STRIDE for r in runs)


def _outcome(fn):
    try:
        return "ok", np.asarray(fn())
    except (RuntimeError, ValueError) as e:
        return type(e).__name__, None


@pytest.mark.parametrize("count", [5, 300, 700, 1300, 2500])
@pytest.mark.parametrize("method", ["contract", "double"])
def test_plan_segment_used_twice_matches_reference(count, method,
                                                   monkeypatch):
    """An explicit count past the entry of a cycle through spine nodes
    uses segments twice; the order (the cycle walked round) or the error
    equals the reference's, through the plan's second walk."""
    nxt, perm = _perm_chain(4000, 21, live=1000)
    nxt[perm[-1]] = perm[400]                    # a cycle of 600 nodes
    runs = _expand_spy(monkeypatch)
    t = torch.from_numpy(nxt)
    head = int(perm[0])
    want = _outcome(lambda: R.chain_order(nxt, head, count, method=method))
    got = _outcome(lambda: TR.chain_order(t, head, count,
                                          method=method).numpy())
    assert got[0] == want[0] == "ok"
    np.testing.assert_array_equal(got[1], want[1])
    if count > 1000:
        np.testing.assert_array_equal(got[1][1000:1100], perm[400:500])
    assert all(r <= STRIDE for r in runs)
