"""repro_torch chain primitives (CPU tensors: the kernels' plain versions
under the port's driver) vs the reference host primitives of
``repro.core.recovery``: equal orders, lengths and member matrices, and the
same exception type on every failure.  Integer results, tolerance 0."""
import numpy as np
import pytest
import torch

from repro.core import recovery as R
from repro_torch.core import recovery as TR


def _outcome(fn):
    try:
        return "ok", np.asarray(fn())
    except (RuntimeError, ValueError) as e:
        return type(e).__name__, None


def _same(ref_fn, port_fn):
    want, got = _outcome(ref_fn), _outcome(port_fn)
    assert got[0] == want[0], (got[0], want[0])
    if want[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])
    return want[0]


def _perm_chain(n, seed, live=None):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)[:live or n]
    nxt = np.full(n, -1, np.int64)
    nxt[perm[:-1]] = perm[1:]
    return nxt, perm


@pytest.mark.parametrize("n", [1, 2, 33, 1000, 2 ** 17 + 5])
@pytest.mark.parametrize("method", ["auto", "double", "contract"])
def test_chain_order_random_permutations(n, method):
    nxt, perm = _perm_chain(n, n)
    t = torch.from_numpy(nxt)
    head = int(perm[0])
    for count in (None, n, max(1, n // 3)):
        assert _same(lambda: R.chain_order(nxt, head, count, method=method),
                     lambda: TR.chain_order(t, head, count,
                                            method=method).numpy()) == "ok"
    if n >= 2 ** 17:
        # auto crosses over to contraction at this size, as the host does
        assert TR.chain_method(n, None, "auto") == "contract"


@pytest.mark.parametrize("method", ["double", "contract"])
def test_chain_order_heads_and_torn_pointers(method):
    nxt, perm = _perm_chain(64, 3, live=40)
    t = torch.from_numpy(nxt)
    for head in (-1, 64, 2 ** 31, 2 ** 40):        # NULL / out of range
        assert TR.chain_order(t, head, method=method).numel() == 0
        assert TR.chain_order(t, head, 5, method=method).numel() == 0
    # a torn 2**32 + 3 must end the chain, not alias node 3
    torn = nxt.copy()
    torn[perm[9]] = 2 ** 32 + 3
    tt = torch.from_numpy(torn)
    for count in (None, 10, 11):
        _same(lambda: R.chain_order(torn, int(perm[0]), count,
                                    method=method, k=4),
              lambda: TR.chain_order(tt, int(perm[0]), count, method=method,
                                     k=4).numpy())
    assert TR.chain_order(tt, int(perm[0]), method=method,
                          k=4).tolist() == perm[:10].tolist()


@pytest.mark.parametrize("method", ["double", "contract"])
@pytest.mark.parametrize("count", [None, 3, 6, 9])
def test_chain_order_cycles_and_overlong_counts(method, count):
    cases = {
        "mid_cycle": np.array([1, 2, 3, 1], np.int64),       # 0->1->2->3->1
        # a cycle holding no spine node (k = 8): 0 -> 9 -> 10 -> 11 -> 9
        "spine_free": np.where(np.arange(16) == 0, 9, -1).astype(np.int64),
        "short": np.array([1, 2, -1, -1, -1], np.int64),      # length 3
        "self_loop": np.array([-1, 1, -1], np.int64),
    }
    cases["spine_free"][9:12] = [10, 11, 9]
    for name, nxt in cases.items():
        t = torch.from_numpy(nxt)
        head = 1 if name == "self_loop" else 0
        _same(lambda: R.chain_order(nxt, head, count, method=method, k=8),
              lambda: TR.chain_order(t, head, count, method=method,
                                     k=8).numpy())
    # count > length raises ValueError, cycle without count RuntimeError
    t = torch.from_numpy(cases["short"])
    with pytest.raises(ValueError, match="count exceeds"):
        TR.chain_order(t, 0, 4, method=method, k=2)
    with pytest.raises(RuntimeError, match="cycle"):
        TR.chain_order(torch.from_numpy(cases["mid_cycle"]), 0,
                       method=method, k=2)


@pytest.mark.parametrize("method", ["auto", "double", "contract"])
def test_chain_lengths_match_host(method):
    rng = np.random.default_rng(5)
    n = 300
    nxt = np.full(n, -1, np.int64)
    perm = rng.permutation(n)
    cuts = np.sort(rng.choice(np.arange(1, n), 6, replace=False))
    heads = []
    for seg in np.split(perm, cuts):           # 7 disjoint chains
        nxt[seg[:-1]] = seg[1:]
        heads.append(int(seg[0]))
    heads += [-1, n + 2, 2 ** 40]              # terminated chains
    hs = np.asarray(heads, np.int64)
    assert _same(lambda: R.chain_lengths(nxt, hs, method=method, k=8),
                 lambda: TR.chain_lengths(torch.from_numpy(nxt), hs,
                                          method=method, k=8).numpy()) == "ok"
    cyc = nxt.copy()
    cyc[perm[cuts[0] - 1]] = perm[2]           # first chain loops back
    _same(lambda: R.chain_lengths(cyc, hs, method=method, k=8),
          lambda: TR.chain_lengths(torch.from_numpy(cyc), hs, method=method,
                                   k=8).numpy())


@pytest.mark.parametrize("method", ["auto", "double", "contract"])
def test_chain_walk_matches_host(method):
    rng = np.random.default_rng(9)
    n = 200
    nxt = np.full(n, -1, np.int64)
    perm = rng.permutation(n)
    heads = []
    for seg in np.split(perm, [5, 40, 41, 120]):
        nxt[seg[:-1]] = seg[1:]
        heads.append(int(seg[0]))
    hs = np.asarray(heads + [-1, 7 * n], np.int64)
    assert _same(lambda: R.chain_walk(nxt, hs, method=method, k=4),
                 lambda: TR.chain_walk(torch.from_numpy(nxt), hs,
                                       method=method, k=4).numpy()) == "ok"
    assert TR.chain_walk(torch.from_numpy(nxt), np.empty(0, np.int64),
                         method=method).shape == (0, 0)
    cyc = nxt.copy()
    cyc[perm[39]] = perm[10]
    _same(lambda: R.chain_walk(cyc, hs, method=method, k=4),
          lambda: TR.chain_walk(torch.from_numpy(cyc), hs, method=method,
                                k=4).numpy())


def test_chain_walk_auto_escalates_like_host():
    """Few long chains over a big table: auto escalates from the
    level-synchronous walk to contraction after 128 rounds."""
    n = 2 ** 17 + 3
    nxt, perm = _perm_chain(n, 1, live=400)
    hs = np.asarray([int(perm[0]), int(perm[200])], np.int64)
    _same(lambda: R.chain_walk(nxt, hs), lambda: TR.chain_walk(
        torch.from_numpy(nxt), hs).numpy())


def test_jump_tables_and_method_match_host():
    nxt, _ = _perm_chain(77, 4, live=50)
    np.testing.assert_array_equal(
        TR.jump_tables(torch.from_numpy(nxt), 5).numpy(),
        R.jump_tables(nxt, 5))
    for n, count, method in [(10, None, "auto"), (2 ** 17, None, "auto"),
                             (2 ** 17, 31, "auto"), (2 ** 17, 32, "auto"),
                             (5, None, "contract")]:
        assert TR.chain_method(n, count, method) == R.chain_method(
            n, count, method)
    with pytest.raises(ValueError):
        TR.chain_method(4, None, "bogus")
    # a snapshot with no count never verifies (host semantics): both
    # packages fall back to the full rank and report its method
    head = int(np.flatnonzero(nxt >= 0)[0])
    ref_s, port_s = R.ChainSnapshot([head]), TR.ChainSnapshot([head])
    _same(lambda: R.chain_order(nxt, head, snapshot=ref_s),
          lambda: TR.chain_order(torch.from_numpy(nxt), head,
                                 snapshot=port_s).numpy())
    assert (port_s.outcome, port_s.replayed) == (ref_s.outcome,
                                                 ref_s.replayed)
