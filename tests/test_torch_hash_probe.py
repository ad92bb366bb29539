"""repro_torch's batched hash probe and the ops wrappers, on the CPU
against the JAX reference.

* ``ops.hash32`` equals the reference's uint32 hash exactly, negative
  ints, 0, -1 and 2**31-1 included.
* ``probe_plain`` (what ``probe`` runs on a CPU tensor) equals the
  reference's Pallas ``probe`` in interpret mode and ``ref.probe_ref``
  exactly, with -1 queries (the empty-lane value: the first empty lane
  of the bucket) and full buckets.
* ``ops.hash_lookup`` end to end, and ``ops.pack_rows``/``scatter_rows``
  at D = 100 (padded to 128) and D = 256.
* What the port does with bucket ids outside the table (-1, no read
  outside it, where the reference's interpret mode clamps) and the dtype
  and shape errors.
* A numpy model of the card's grouped kernel (``csrc/hash_probe.cu``):
  count with ranks, a block-sliced scan, the scatter into bucket order,
  the probe in windows of 32 and the gather of the answers back, exact
  against the reference on uniform,
  one-bucket, Zipf, out-of-range, small, one-bucket-table and edge-lane
  inputs, with its row reads between the distinct rows and the distinct
  rows plus one per window, and the same answers whatever order the
  count's atomics take.
* ``probe_hashed`` (``hash_lookup``'s form) on the CPU: hash32 and
  ``probe_plain``, no launch, the reference's ``hash_lookup``; a table
  of no buckets raises as before.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hash_probe as jhp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import hash_probe as thp
from repro_torch.kernels import ops as tops

BUCKET = thp.BUCKET


def _hash32_np(x: np.ndarray) -> np.ndarray:
    return np.asarray(jops.hash32(jnp.asarray(x, jnp.int32))).astype(np.int64)


def _table(nb: int, keys: np.ndarray) -> np.ndarray:
    """Place each key in its hash bucket's first free lane, as the
    reference's tests do; -1 marks an empty lane."""
    table = np.full((nb, BUCKET), -1, np.int32)
    fill = np.zeros(nb, np.int64)
    for k, b in zip(keys, _hash32_np(keys) % nb):
        table[b, fill[b]] = k
        fill[b] += 1
    return table


def _probe_all(table, queries, bids):
    """(port, reference Pallas in interpret mode, reference oracle)."""
    got = thp.probe(torch.from_numpy(table), torch.from_numpy(queries),
                    torch.from_numpy(bids)).numpy()
    args = (jnp.asarray(table), jnp.asarray(queries), jnp.asarray(bids))
    pallas = np.asarray(jhp.probe(*args, interpret=True))
    oracle = np.asarray(jref.probe_ref(*args))
    return got, pallas, oracle


def test_hash32_matches_reference():
    rng = np.random.default_rng(0)
    edge = np.array([0, -1, 1, 2 ** 31 - 1, -2 ** 31, -2, 2 ** 16,
                     0x7FEB352D, -0x7B94], np.int32)
    x = np.concatenate([edge, rng.integers(-2 ** 31, 2 ** 31, 4096,
                                           dtype=np.int64).astype(np.int32)])
    got = tops.hash32(torch.from_numpy(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _hash32_np(x))
    assert int(got.min()) >= 0 and int(got.max()) < 2 ** 32


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_matches_reference(seed):
    rng = np.random.default_rng(seed)
    nb = 8
    keys = rng.choice(1 << 20, 300, replace=False).astype(np.int32)
    table = _table(nb, keys)
    # one full bucket: all 128 lanes hold keys, none empty
    full = 3
    table[full] = rng.choice(np.arange(2 << 20, 3 << 20), BUCKET,
                             replace=False).astype(np.int32)
    kept = keys[_hash32_np(keys) % nb != full]      # not overwritten
    queries = np.concatenate([
        kept[:40],                                  # present
        rng.integers(4 << 20, 5 << 20, 16).astype(np.int32),  # absent
        table[full, [0, 1, 64, 127]],               # every lane of a row
        np.full(6, -1, np.int32),                   # the empty-lane value
        np.array([-7, 2 ** 31 - 1], np.int32)])
    bids = (_hash32_np(queries) % nb).astype(np.int32)
    q_full = 40 + 16
    bids[q_full:q_full + 4] = full
    bids[q_full + 4] = full                         # -1 in a full bucket
    got, pallas, oracle = _probe_all(table, queries, bids)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.int32
    assert (got[:40] >= 0).all() and (got[40:56] == -1).all()
    np.testing.assert_array_equal(got[q_full:q_full + 4],
                                  full * BUCKET + np.array([0, 1, 64, 127]))
    assert got[q_full + 4] == -1
    # -1 in a bucket with room: the first empty lane
    for i in range(q_full + 5, q_full + 10):
        b = bids[i]
        assert got[i] == b * BUCKET + int(np.argmax(table[b] == -1))


def test_probe_first_of_duplicate_lanes():
    table = np.full((2, BUCKET), -1, np.int32)
    table[1, [5, 9, 100]] = 42
    got, pallas, oracle = _probe_all(table, np.array([42, 42], np.int32),
                                     np.array([1, 0], np.int32))
    np.testing.assert_array_equal(got, [BUCKET + 5, -1])
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)


def test_hash_lookup_matches_reference():
    rng = np.random.default_rng(5)
    nb = 16
    keys = rng.choice(1 << 24, 600, replace=False).astype(np.int32)
    keys[:3] = [0, 2 ** 31 - 1, -12345]
    table = _table(nb, keys)
    queries = np.concatenate([keys[::3], keys[:20] + (1 << 25),
                              np.array([-1, -2 ** 31], np.int32)])
    want = np.asarray(jops.hash_lookup(jnp.asarray(table),
                                       jnp.asarray(queries)))
    before = thp.probe.launches
    got = tops.hash_lookup(torch.from_numpy(table),
                           torch.from_numpy(queries)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:200] >= 0).all()
    np.testing.assert_array_equal(table.reshape(-1)[got[:200]], keys[::3])
    assert (got[200:220] == -1).all()
    assert thp.probe.launches == before          # the CPU runs no kernel


@pytest.mark.parametrize("d", [100, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_pack_scatter_rows_match_reference(d, dtype):
    rng = np.random.default_rng(d)
    n, m = 40, 12
    src = (rng.standard_normal((n, d)) * 100).astype(dtype)
    idx = rng.choice(n, m, replace=False).astype(np.int32)
    idx[[2, 7]] = -1
    got = tops.pack_rows(torch.from_numpy(src), torch.from_numpy(idx))
    want = np.asarray(jops.pack_rows(jnp.asarray(src), jnp.asarray(idx)))
    assert got.shape == (m, d) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    packed = (rng.standard_normal((m, d)) * 100).astype(dtype)
    dst = torch.from_numpy(src.copy())
    got = tops.scatter_rows(dst, torch.from_numpy(packed),
                            torch.from_numpy(idx), block_d=128)
    want = np.asarray(jops.scatter_rows(jnp.asarray(src),
                                        jnp.asarray(packed),
                                        jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dst.numpy(), src)     # functional


def test_probe_out_of_range_bucket_is_absent():
    """A bucket id outside [0, n_buckets) answers -1 on the port; the
    reference's interpret mode clamps it to the nearest bucket."""
    table = np.full((4, BUCKET), -1, np.int32)
    table[3, 0] = 77
    table[0, 0] = 88
    queries = np.array([77, 88, 77, -1], np.int32)
    bids = np.array([4, -1, 1 << 20, 9], np.int32)
    got = thp.probe(torch.from_numpy(table), torch.from_numpy(queries),
                    torch.from_numpy(bids)).numpy()
    np.testing.assert_array_equal(got, [-1, -1, -1, -1])
    clamped = np.asarray(jhp.probe(jnp.asarray(table), jnp.asarray(queries),
                                   jnp.asarray(bids), interpret=True))
    # the reference reads the last row and names a slot past the table
    assert clamped[0] == 4 * BUCKET


def test_probe_rejects_other_dtypes_and_shapes():
    t32 = torch.full((2, BUCKET), -1, dtype=torch.int32)
    q = torch.tensor([1, 2], dtype=torch.int32)
    b = torch.tensor([0, 1], dtype=torch.int32)
    for bad in (t32.long(), t32.float()):
        with pytest.raises(TypeError):
            thp.probe(bad, q, b)
    with pytest.raises(TypeError):
        thp.probe(t32, q.long(), b)
    with pytest.raises(TypeError):
        thp.probe(t32, q, b.long())
    with pytest.raises(TypeError):
        tops.hash_lookup(t32.long(), q)
    with pytest.raises(ValueError):
        thp.probe(torch.full((2, 64), -1, dtype=torch.int32), q, b)
    with pytest.raises(ValueError):
        thp.probe(t32, q, b[:1])
    with pytest.raises(ValueError):
        thp.probe(torch.full((BUCKET, 2), -1, dtype=torch.int32).t(), q,
                  b)                                # not contiguous


# ------------------------------------------------ the grouped kernel's model

def _grouped_model(table, queries, bids, blocks=4, rng=None):
    """numpy model of ``csrc/hash_probe.cu``'s grouped kernel, stage by
    stage.  ``rng`` shuffles the order in which warps take their atomics
    and, inside a warp, the order of its bucket groups (the card gives no
    order).  Returns (answers, keys in bucket order as (query, bucket),
    each query's key position (-1 outside the table), rows read,
    windows)."""
    nb, nq = table.shape[0], queries.shape[0]
    out = np.full(nq, -2, np.int64)            # -2: never answered
    # 1. count: a warp of 32 queries takes one atomic per bucket it holds;
    # its lanes of that bucket rank in lane order from the atomic's value
    count = np.zeros(nb, np.int64)
    pos = np.full(nq, -1, np.int64)
    warps = np.arange(-(-nq // 32))
    if rng is not None:
        warps = rng.permutation(warps)
    for w in warps:
        lanes = np.arange(32 * w, min(32 * w + 32, nq))
        live = lanes[(bids[lanes] >= 0) & (bids[lanes] < nb)]
        out[np.setdiff1d(lanes, live)] = -1     # out of range: answered
        groups = np.unique(bids[live])
        if rng is not None:
            groups = rng.permutation(groups)
        for b in groups:
            peers = live[bids[live] == b]
            pos[peers] = count[b] + np.arange(peers.size)
            count[b] += peers.size
    # 2. scan: block k scans buckets [k << shift, (k + 1) << shift) in place
    # and writes its total
    shift = 0
    while (blocks << shift) < nb:
        shift += 1
    offsets = np.zeros(nb, np.int64)
    totals = np.zeros(blocks, np.int64)
    for k in range(blocks):
        running = 0
        for b in range(k << shift, min((k + 1) << shift, nb)):
            offsets[b] = running
            running += count[b]
        totals[k] = running
    # 3. scatter: the block totals scanned, each key placed at its block's
    # base + its bucket's offset + its rank, which replaces the rank
    base = np.zeros(blocks + 1, np.int64)
    for k in range(blocks):
        base[k + 1] = base[k] + totals[k]
    n_valid = int(base[blocks])
    keys = np.full((n_valid, 2), -1, np.int64)  # query, bucket
    for i in np.flatnonzero(pos >= 0):
        b = bids[i]
        pos[i] += base[b >> shift] + offsets[b]
        assert keys[pos[i], 1] == -1            # each slot written once
        keys[pos[i]] = (queries[i], b)
    assert (keys[:, 1] >= 0).all()
    # 4. probe: a window of 32 keys reads the row of its first pending
    # key's bucket and answers every key of that bucket in it, in key order
    answers = np.full(n_valid, -2, np.int64)
    reads = 0
    for w0 in range(0, n_valid, 32):
        win = keys[w0:w0 + 32]
        pending = np.ones(len(win), bool)
        while pending.any():
            b = win[np.argmax(pending), 1]
            group = pending & (win[:, 1] == b)
            row = table[b]
            reads += 1
            for r in np.flatnonzero(group):
                hit = np.flatnonzero(row == win[r, 0])
                answers[w0 + r] = b * BUCKET + hit[0] if hit.size else -1
            pending &= ~group
    # 5. gather: each answer back to its query
    live = pos >= 0
    out[live] = answers[pos[live]]
    assert (out >= -1).all()
    return out.astype(np.int32), keys, pos, reads, -(-n_valid // 32)


def _present_table(rng, nb, n_keys):
    keys = rng.choice(1 << 22, n_keys, replace=False).astype(np.int32)
    return _table(nb, keys), keys


def _case(name):
    """(table, queries, bucket ids) of one grouped-model case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "one_bucket":
        table, keys = _present_table(rng, 16, 600)
        b = 5
        row = table[b]
        pool = np.concatenate([row, np.array([-7, 1 << 23], np.int32)])
        q = pool[rng.integers(0, pool.size, 1500)]
        return table, q, np.full(q.size, b, np.int32)
    if name == "zipf":
        table, keys = _present_table(rng, 64, 2000)
        z = rng.zipf(1.1, 3000)
        q = keys[(z - 1) % keys.size]
        return table, q, (_hash32_np(q) % 64).astype(np.int32)
    if name == "nb1":
        table, keys = _present_table(rng, 1, 90)
        q = np.concatenate([keys, rng.integers(1 << 22, 1 << 23, 400)
                            .astype(np.int32), np.full(10, -1, np.int32)])
        return table, q, np.zeros(q.size, np.int32)
    if name == "edge_lanes":
        # -1 queries, a full bucket and a key in several lanes of a row
        table, keys = _present_table(rng, 8, 300)
        table[3] = rng.choice(np.arange(1 << 23, 1 << 24), BUCKET,
                              replace=False).astype(np.int32)
        table[6, [2, 40, 127]] = 4242
        q = np.concatenate([table[3, [0, 5, 127]], np.full(8, -1, np.int32),
                            np.full(5, 4242, np.int32), keys[:40]])
        b = (_hash32_np(q) % 8).astype(np.int32)
        b[:3] = 3
        b[3:7] = 3                               # -1 in the full bucket
        b[11:16] = 6
        perm = rng.permutation(q.size)
        return table, q[perm], b[perm]
    table, keys = _present_table(rng, 64, 2000)
    n = {"q0": 0, "q1": 1, "q31": 31, "q33": 33, "q1000": 1000}.get(name,
                                                                   2000)
    q = np.concatenate([keys[rng.integers(0, keys.size, n - n // 2)],
                        rng.integers(1 << 22, 1 << 23, n // 2)
                        .astype(np.int32)])[rng.permutation(n)]
    b = (_hash32_np(q) % 64).astype(np.int32)
    if name in ("out_of_range", "q31", "q33", "q1000"):
        b[::7] = 64 + 3
        b[1::11] = -1
        b[2::13] = -2 ** 31
    return table, q, b


@pytest.mark.parametrize("name", ["uniform", "one_bucket", "zipf",
                                  "out_of_range", "q0", "q1", "q31", "q33",
                                  "q1000", "nb1", "edge_lanes"])
def test_grouped_model_matches_reference(name):
    table, q, b = _case(name)
    got, keys, pos, reads, windows = _grouped_model(table, q, b)
    inr = (b >= 0) & (b < table.shape[0])
    np.testing.assert_array_equal(got[~inr], -1)
    # the port's plain version: -1 for an id outside the table
    np.testing.assert_array_equal(got, thp.probe_plain(
        torch.from_numpy(table), torch.from_numpy(q),
        torch.from_numpy(b)).numpy())
    # the reference on the ids inside it (its interpret mode clamps the
    # others); Pallas takes no empty grid, so Q = 0 meets probe_ref alone
    args = (jnp.asarray(table), jnp.asarray(q[inr]), jnp.asarray(b[inr]))
    np.testing.assert_array_equal(got[inr], np.asarray(jref.probe_ref(*args)))
    if inr.any():
        np.testing.assert_array_equal(
            got[inr], np.asarray(jhp.probe(*args, interpret=True)))
    # keys in bucket order, each query's key where its position says; one
    # read per distinct row, plus at most one per window boundary that
    # splits a bucket
    assert (np.diff(keys[:, 1]) >= 0).all()
    np.testing.assert_array_equal(keys[pos[inr]], np.stack([q[inr], b[inr]],
                                                           1))
    distinct = np.unique(b[inr]).size
    assert distinct <= reads <= distinct + max(windows - 1, 0)
    if name == "one_bucket":
        assert reads == windows == -(-q.size // 32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_model_answers_do_not_depend_on_rank_order(seed):
    table, q, b = _case("zipf")
    want, keys, pos, _, _ = _grouped_model(table, q, b)
    got, keys2, pos2, _, _ = _grouped_model(table, q, b, blocks=3,
                                            rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(pos2, pos)               # another order
    np.testing.assert_array_equal(keys2[:, 1], keys[:, 1])
    np.testing.assert_array_equal(got, np.asarray(jref.probe_ref(
        jnp.asarray(table), jnp.asarray(q), jnp.asarray(b))))


@pytest.mark.parametrize("nb", [1, 64])
def test_hash_lookup_cpu_launches_nothing_and_matches_reference(nb):
    rng = np.random.default_rng(nb)
    table, keys = _present_table(rng, nb, 100 if nb == 1 else 2000)
    z = rng.zipf(1.1, 2500)
    queries = np.concatenate([keys[(z - 1) % keys.size],
                              rng.integers(-2 ** 31, 2 ** 31, 500,
                                           dtype=np.int64).astype(np.int32),
                              np.array([-1, 0, 2 ** 31 - 1], np.int32)])
    want = np.asarray(jops.hash_lookup(jnp.asarray(table),
                                       jnp.asarray(queries)))
    before = thp.probe.launches, dict(thp.probe.sizes)
    t, qs = torch.from_numpy(table), torch.from_numpy(queries)
    got = tops.hash_lookup(t, qs)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(thp.probe_hashed(t, qs).numpy(), want)
    np.testing.assert_array_equal(thp.probe_hashed_plain(t, qs).numpy(),
                                  want)
    assert (thp.probe.launches, thp.probe.sizes) == before
    assert got.dtype == torch.int32


def test_hash_lookup_without_buckets_raises_as_before():
    """A table of no buckets: the modulo by zero of ``hash32 % 0`` raised
    on the CPU before the hash moved into ``probe_hashed``; it still does,
    and an empty batch still answers nothing."""
    table = torch.empty((0, BUCKET), dtype=torch.int32)
    q = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        (tops.hash32(q) % table.shape[0])
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        tops.hash_lookup(table, q)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        thp.probe_hashed_plain(table, q)
    empty = tops.hash_lookup(table, q[:0])
    assert empty.shape == (0,) and empty.dtype == torch.int32
