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
