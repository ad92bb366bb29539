"""hash_probe: batched probe of a bucketed hash table.

The device half of ``ops.hash_lookup``: the table is bucketized, each
bucket one 128-wide row of int32 keys, and a query is compared with the
whole row of its bucket at once.

For query ``q`` with bucket ``b`` the result is the global slot id
``b * 128 + j`` of the first lane ``j`` with ``keys[b, j] == q``, else -1,
as int32, exactly the reference's ``probe_ref``.  A query equal to the
empty-lane value -1 therefore finds the first empty lane of its bucket.

Two entry points, one kernel source (``csrc/hash_probe.cu``, which holds
the design note):

* ``probe(keys_table, queries, bucket_ids)`` takes the buckets from the
  caller, as the reference's Pallas ``probe`` does.
* ``probe_hashed(keys_table, queries)`` is ``hash_lookup``'s form: the
  bucket is ``hash32(q) % n_buckets``, computed inside the kernel on the
  card, so no bucket-id array is ever written.  Its plain version hashes
  with ``hash32`` in torch ops and calls ``probe_plain``.

On the card a batch of at least ``GROUPED_MIN_QUERIES`` queries takes the
grouped kernel, one cooperative launch: it counts the queries of each
bucket, scans the counts, scatters the queries into bucket order, probes
each bucket's 512 B row once for all of its queries in a window of 32,
and gathers the answers back to the queries' order.  Its scratch (16 B a
query, 4 B a bucket) comes from ``torch.empty`` and lives for the call.
A smaller batch, whose rows are rarely shared, takes the query-major
kernel (one warp per query).  Either counts one launch of ``probe``.

A bucket id outside ``[0, n_buckets)`` is a caller error.  The port
answers -1 (absent) for it and reads nothing outside the table, on the
card and on the CPU alike; the reference's interpret mode clamps the
bucket to the nearest row instead.  Only int32 tables, queries and bucket
ids are taken (``TypeError`` otherwise), and at most 2**24 buckets, so
every global slot id fits in int32.  The hashed form over a table of no
buckets raises as the modulo by zero of its plain version does.

CPU tensors take the plain version; CUDA tensors launch a kernel or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["BUCKET", "GROUPED_MIN_QUERIES", "hash32", "probe", "probe_plain",
           "probe_hashed", "probe_hashed_plain"]

BUCKET = 128           # lanes per bucket row
MAX_BUCKETS = 1 << 24  # (2**24 - 1) * 128 + 127 is the largest int32 id
MAX_QUERIES = (1 << 31) - 1   # a record keeps the query's index as int32
GROUPED_MIN_QUERIES = 1 << 20  # smaller batches take the query-major kernel
MAX_GRID = 2048        # the grouped kernel's most blocks (kMaxGrid)
STAMPS = 7             # the grouped kernel's stage stamps


def hash32(x: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 xorshift-multiply hash of ``x`` taken as
    uint32 (a negative int32 as its two's complement), returned as int64
    values in [0, 2**32).  torch has no unsigned ``>>`` for wide types and
    ``>>`` on int64 is arithmetic, so the words are kept non-negative in
    int64: masked to 32 bits after every multiply, whose int64 product
    wraps mod 2**64 and so keeps its low 32 bits exact."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    u = ((u ^ (u >> 16)) * 0x7FEB352D) & 0xFFFFFFFF
    u = ((u ^ (u >> 15)) * 0x846CA68B) & 0xFFFFFFFF
    return u ^ (u >> 16)


def _check_table(keys_table: torch.Tensor, queries: torch.Tensor) -> None:
    for name, t in (("keys_table", keys_table), ("queries", queries)):
        if t.dtype != torch.int32:
            raise TypeError(f"probe: {name} must be int32, got {t.dtype}")
    if keys_table.dim() != 2 or keys_table.shape[1] != BUCKET:
        raise ValueError(f"probe: keys_table must be (n_buckets, {BUCKET}),"
                         f" got {tuple(keys_table.shape)}")
    if keys_table.shape[0] > MAX_BUCKETS:
        raise ValueError(f"probe: {keys_table.shape[0]} buckets; global "
                         f"slot ids are int32, so at most {MAX_BUCKETS}")
    if queries.dim() != 1:
        raise ValueError(f"probe: queries must be (Q,), got "
                         f"{tuple(queries.shape)}")
    if keys_table.device != queries.device:
        raise ValueError("probe: keys_table and queries on different "
                         "devices")
    if not (keys_table.is_contiguous() and queries.is_contiguous()):
        raise ValueError("probe: keys_table and queries must be contiguous")


def _check(keys_table: torch.Tensor, queries: torch.Tensor,
           bucket_ids: torch.Tensor) -> None:
    _check_table(keys_table, queries)
    if bucket_ids.dtype != torch.int32:
        raise TypeError(f"probe: bucket_ids must be int32, got "
                        f"{bucket_ids.dtype}")
    if bucket_ids.shape != queries.shape:
        raise ValueError(f"probe: queries and bucket_ids must be (Q,), got "
                         f"{tuple(queries.shape)} and "
                         f"{tuple(bucket_ids.shape)}")
    if bucket_ids.device != queries.device:
        raise ValueError("probe: keys_table, queries and bucket_ids on "
                         "different devices")
    if not bucket_ids.is_contiguous():
        raise ValueError("probe: keys_table, queries and bucket_ids must be "
                         "contiguous")


def _check_hashed(keys_table: torch.Tensor, queries: torch.Tensor) -> None:
    _check_table(keys_table, queries)
    if keys_table.shape[0] == 0 and queries.numel():
        raise RuntimeError("ZeroDivisionError: hash32(q) % n_buckets over a "
                           "table of 0 buckets")


def probe_plain(keys_table: torch.Tensor, queries: torch.Tensor,
                bucket_ids: torch.Tensor) -> torch.Tensor:
    """Plain version: gather each query's bucket row, compare, take the
    first hit (``argmax`` over the hit mask), -1 where none hits or the
    bucket id is out of range."""
    _check(keys_table, queries, bucket_ids)
    nb = keys_table.shape[0]
    valid = (bucket_ids >= 0) & (bucket_ids < nb)
    safe = torch.where(valid, bucket_ids, 0).long()
    if nb == 0:
        return torch.full_like(queries, -1)
    hit = keys_table[safe] == queries[:, None]
    lane = hit.to(torch.int32).argmax(1).to(torch.int32)
    found = hit.any(1) & valid
    return torch.where(found, bucket_ids * BUCKET + lane,
                       torch.full_like(queries, -1))


def probe_hashed_plain(keys_table: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """Plain version of the hashed form: ``hash32`` in torch ops, then
    ``probe_plain``."""
    _check_hashed(keys_table, queries)
    nb = max(keys_table.shape[0], 1)       # Q == 0 when the table has none
    bid = (hash32(queries) % nb).to(torch.int32)
    return probe_plain(keys_table, queries, bid)


def probe(keys_table: torch.Tensor, queries: torch.Tensor,
          bucket_ids: torch.Tensor) -> torch.Tensor:
    """keys_table (n_buckets, 128) int32; queries and bucket_ids (Q,)
    int32.  Returns (Q,) int32 global slot ids, -1 where absent."""
    _check(keys_table, queries, bucket_ids)
    if keys_table.device.type == "cpu":
        return probe_plain(keys_table, queries, bucket_ids)
    return _launch(keys_table, queries, bucket_ids)


def probe_hashed(keys_table: torch.Tensor,
                 queries: torch.Tensor) -> torch.Tensor:
    """``probe`` with each query's bucket ``hash32(q) % n_buckets``, hashed
    inside the kernel on the card.  keys_table (n_buckets, 128) int32;
    queries (Q,) int32.  Returns (Q,) int32 global slot ids, -1 where
    absent."""
    _check_hashed(keys_table, queries)
    if keys_table.device.type == "cpu":
        return probe_hashed_plain(keys_table, queries)
    return _launch(keys_table, queries, None)


def _launch(keys_table: torch.Tensor, queries: torch.Tensor,
            bucket_ids: Optional[torch.Tensor],
            grouped: Optional[bool] = None,
            stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch one kernel on checked CUDA tensors: ``bucket_ids`` None
    hashes in the kernel.  ``grouped`` picks the kernel (None: by
    ``GROUPED_MIN_QUERIES``); ``stamps``, (STAMPS,) int64 on the card,
    receives the grouped kernel's %globaltimer readings (start, after each
    of its five barriers, end)."""
    if keys_table.device.type != "cuda":
        raise RuntimeError(f"probe: no kernel for device "
                           f"{keys_table.device}")
    if keys_table.data_ptr() % 16:
        raise ValueError("probe: keys_table must be 16-byte aligned")
    n_q, nb = queries.shape[0], keys_table.shape[0]
    if n_q > MAX_QUERIES:
        raise ValueError(f"probe: {n_q} queries; at most {MAX_QUERIES}")
    if grouped is None:
        grouped = n_q >= GROUPED_MIN_QUERIES
    if stamps is not None and (not grouped or stamps.dtype != torch.int64
                               or stamps.numel() < STAMPS
                               or stamps.device != queries.device):
        raise ValueError(f"probe: stamps are for the grouped kernel, "
                         f"{STAMPS} int64 on {queries.device}")
    out = torch.empty_like(queries)
    if n_q == 0:
        return out
    bid_ptr = None if bucket_ids is None else bucket_ids.data_ptr()
    lib = _build.load("hash_probe")
    with torch.cuda.device(keys_table.device):
        stream = torch.cuda.current_stream(keys_table.device).cuda_stream
        if grouped:
            nbytes = 16 * n_q + 4 * (nb + MAX_GRID)
            scratch = torch.empty(nbytes, dtype=torch.uint8,
                                  device=keys_table.device)
            rc = lib.probe_grouped_launch(
                keys_table.data_ptr(), queries.data_ptr(), bid_ptr,
                out.data_ptr(), scratch.data_ptr(), nbytes,
                None if stamps is None else stamps.data_ptr(), nb, n_q,
                stream)
        else:
            rc = lib.probe_launch(keys_table.data_ptr(), queries.data_ptr(),
                                  bid_ptr, out.data_ptr(), nb, n_q, stream)
    if rc:
        raise RuntimeError(f"probe: kernel launch failed (CUDA error {rc})")
    _build.note_launch(probe, n_q)
    return out


probe.launches = 0
probe.sizes = {}
