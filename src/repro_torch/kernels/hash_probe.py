"""hash_probe: batched probe of a bucketed hash table.

The device half of ``ops.hash_lookup``: the table is bucketized, each
bucket one 128-wide row of int32 keys, and a query is compared with the
whole row of its bucket at once.  Hashing a query to its bucket happens
in the caller (``ops.hash_lookup``), as in the reference.
``csrc/hash_probe.cu`` holds the Hopper kernel and its design note.

For query ``q`` with bucket ``b`` the result is the global slot id
``b * 128 + j`` of the first lane ``j`` with ``keys[b, j] == q``, else -1,
as int32, exactly the reference's ``probe_ref``.  A query equal to the
empty-lane value -1 therefore finds the first empty lane of its bucket.

A bucket id outside ``[0, n_buckets)`` is a caller error.  The port
answers -1 (absent) for it and reads nothing outside the table, on the
card and on the CPU alike; the reference's interpret mode clamps the
bucket to the nearest row instead.  Only int32 tables, queries and bucket
ids are taken (``TypeError`` otherwise), and at most 2**24 buckets, so
every global slot id fits in int32.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["BUCKET", "probe", "probe_plain"]

BUCKET = 128           # lanes per bucket row
MAX_BUCKETS = 1 << 24  # (2**24 - 1) * 128 + 127 is the largest int32 id


def _check(keys_table: torch.Tensor, queries: torch.Tensor,
           bucket_ids: torch.Tensor) -> None:
    for name, t in (("keys_table", keys_table), ("queries", queries),
                    ("bucket_ids", bucket_ids)):
        if t.dtype != torch.int32:
            raise TypeError(f"probe: {name} must be int32, got {t.dtype}")
    if keys_table.dim() != 2 or keys_table.shape[1] != BUCKET:
        raise ValueError(f"probe: keys_table must be (n_buckets, {BUCKET}),"
                         f" got {tuple(keys_table.shape)}")
    if keys_table.shape[0] > MAX_BUCKETS:
        raise ValueError(f"probe: {keys_table.shape[0]} buckets; global "
                         f"slot ids are int32, so at most {MAX_BUCKETS}")
    if queries.dim() != 1 or bucket_ids.shape != queries.shape:
        raise ValueError(f"probe: queries and bucket_ids must be (Q,), got "
                         f"{tuple(queries.shape)} and "
                         f"{tuple(bucket_ids.shape)}")
    if not (keys_table.device == queries.device == bucket_ids.device):
        raise ValueError("probe: keys_table, queries and bucket_ids on "
                         "different devices")
    if not (keys_table.is_contiguous() and queries.is_contiguous()
            and bucket_ids.is_contiguous()):
        raise ValueError("probe: keys_table, queries and bucket_ids must be "
                         "contiguous")


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


def probe(keys_table: torch.Tensor, queries: torch.Tensor,
          bucket_ids: torch.Tensor) -> torch.Tensor:
    """keys_table (n_buckets, 128) int32; queries and bucket_ids (Q,)
    int32.  Returns (Q,) int32 global slot ids, -1 where absent."""
    _check(keys_table, queries, bucket_ids)
    if keys_table.device.type == "cpu":
        return probe_plain(keys_table, queries, bucket_ids)
    if keys_table.device.type != "cuda":
        raise RuntimeError(f"probe: no kernel for device "
                           f"{keys_table.device}")
    if keys_table.data_ptr() % 16:
        raise ValueError("probe: keys_table must be 16-byte aligned")
    out = torch.empty_like(queries)
    if queries.numel() == 0:
        return out
    lib = _build.load("hash_probe")
    with torch.cuda.device(keys_table.device):
        stream = torch.cuda.current_stream(keys_table.device).cuda_stream
        rc = lib.probe_launch(keys_table.data_ptr(), queries.data_ptr(),
                              bucket_ids.data_ptr(), out.data_ptr(),
                              keys_table.shape[0], queries.shape[0], stream)
    if rc:
        raise RuntimeError(f"probe: kernel launch failed (CUDA error {rc})")
    _build.note_launch(probe, queries.shape[0])
    return out


probe.launches = 0
probe.sizes = {}
