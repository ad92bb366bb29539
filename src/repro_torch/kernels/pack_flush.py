"""pack_flush: gather dirty rows into one staging buffer, and scatter
packed rows back.

The device half of the epoch drain (core/writeset.py): the dirty rows of
every region a drain writes are packed by ``pack_rows_grouped`` into one
byte staging buffer, one 16-byte-aligned segment per region, in one
launch (up to ``MAX_GROUPS`` regions a launch).  The drain calls its
form ``pack_rows_grouped_host``: the indices and the staging buffer lie
in pinned host memory, which the kernel reads and writes across the bus,
and the drain writes each segment into the persistent image.
``pack_rows`` is the one-region case, with the reference's signature.  ``csrc/pack_flush.cu`` holds the
Hopper kernel and its design note.

``scatter_rows_`` is the inverse, in place: ``dst[idx[i]] = packed[i]``.
The serving engine seats each re-prefill group's cache rows with it, one
launch per cache leaf per group (``serve/engine.py``); ``scatter_rows`` is
the reference's functional form on a copy.

All dispatch by where their tensors live: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise (``pack_rows_grouped_host``
dispatches on its sources and has no plain form: CPU sources raise).
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["MAX_GROUPS", "group_layout", "pack_rows", "pack_rows_grouped",
           "pack_rows_grouped_host", "pack_rows_grouped_plain",
           "pack_rows_plain", "scatter_rows", "scatter_rows_",
           "scatter_rows_plain"]

MAX_GROUPS = 64      # region descriptors in one launch's parameter space
SEG_ALIGN = 16       # every segment of the staging buffer starts here


def _rowbytes(src: torch.Tensor) -> int:
    return src.shape[1] * src.element_size()


def _check_idx(idx: torch.Tensor) -> None:
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"pack_rows: idx must be 1-D int32, got "
                        f"{idx.dtype} shape {tuple(idx.shape)}")
    if not idx.is_contiguous():
        raise ValueError("pack_rows: idx must be contiguous")


def _check_src(src: torch.Tensor, device: torch.device) -> None:
    if src.dim() != 2:
        raise ValueError(f"pack_rows: src must be 2-D (rows, words), "
                         f"got shape {tuple(src.shape)}")
    if src.device != device:
        raise ValueError(f"pack_rows: src on {src.device}, idx on {device}")
    if not src.is_contiguous():
        raise ValueError("pack_rows: src must be contiguous")
    if _rowbytes(src) % 4:
        raise ValueError(f"pack_rows: {_rowbytes(src)} B rows are not a "
                         f"multiple of 4 bytes")


def _check(src: torch.Tensor, idx: torch.Tensor) -> None:
    _check_idx(idx)
    _check_src(src, idx.device)


def _check_group(srcs: Sequence[torch.Tensor], idx: torch.Tensor,
                 counts: Sequence[int]) -> None:
    if len(srcs) != len(counts):
        raise ValueError(f"pack_rows_grouped: {len(srcs)} sources, "
                         f"{len(counts)} counts")
    if any(m < 0 for m in counts) or sum(counts) != idx.shape[0]:
        raise ValueError(f"pack_rows_grouped: counts {list(counts)} do not "
                         f"split {idx.shape[0]} indices")
    _check_idx(idx)
    for src in srcs:
        _check_src(src, idx.device)


def group_layout(srcs: Sequence[torch.Tensor], counts: Sequence[int]
                 ) -> Tuple[List[int], int]:
    """Byte offset of each region's segment in the staging buffer (each
    ``SEG_ALIGN``-aligned, in order) and the buffer's size in bytes."""
    offs, pos = [], 0
    for src, m in zip(srcs, counts):
        offs.append(pos)
        pos += -(-m * _rowbytes(src) // SEG_ALIGN) * SEG_ALIGN
    return offs, pos


def pack_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``out[i] = src[idx[i]]``, a zero row where
    ``idx[i]`` lies outside ``[0, len(src))``."""
    _check(src, idx)
    n = src.shape[0]
    valid = (idx >= 0) & (idx < n)
    safe = torch.where(valid, idx, 0).long()
    out = src[safe] if n else src.new_zeros((idx.shape[0], src.shape[1]))
    out[~valid] = 0
    return out


def pack_rows_grouped_plain(srcs: Sequence[torch.Tensor], idx: torch.Tensor,
                            counts: Sequence[int]) -> torch.Tensor:
    """Plain version of the grouped gather: ``pack_rows_plain`` of each
    region (``counts[r]`` consecutive indices of ``idx`` each), its bytes
    written at the region's offset of ``group_layout``; pad bytes zero.
    Returns the (bytes,) uint8 staging buffer."""
    _check_group(srcs, idx, counts)
    offs, total = group_layout(srcs, counts)
    out = torch.zeros(total, dtype=torch.uint8, device=idx.device)
    pos = 0
    for src, m, off in zip(srcs, counts, offs):
        rows = pack_rows_plain(src, idx[pos:pos + m]).reshape(-1)
        out[off:off + m * _rowbytes(src)] = rows.view(torch.uint8)
        pos += m
    return out


def pack_rows_grouped(srcs: Sequence[torch.Tensor], idx: torch.Tensor,
                      counts: Sequence[int],
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather the rows of several regions into one staging buffer: region
    r's rows ``srcs[r][idx_r]``, where ``idx_r`` is its ``counts[r]``
    consecutive int32 indices of ``idx``, land at its byte offset of
    ``group_layout``; indices outside ``[0, len(srcs[r]))`` give zero rows.
    Every source is (N, W) with a row width in bytes that is a multiple of
    4.  Returns the (bytes,) uint8 buffer: a new one on ``idx``'s device,
    or the first bytes of ``out`` (uint8, 16-byte aligned; on a card it
    may be pinned host memory, which the kernel then writes directly).
    One launch for every ``MAX_GROUPS`` regions, each counted in
    ``pack_rows.launches``."""
    _check_group(srcs, idx, counts)
    offs, total = group_layout(srcs, counts)
    if out is not None:
        if out.dtype != torch.uint8 or out.dim() != 1 or \
                out.shape[0] < total or out.data_ptr() % SEG_ALIGN:
            raise ValueError(f"pack_rows: out must be 1-D uint8 of at least "
                             f"{total} bytes, 16-byte aligned")
        host = out.device.type == "cpu"
        if out.device != idx.device and not (host and out.is_pinned()):
            raise ValueError(f"pack_rows: out on {out.device} for indices "
                             f"on {idx.device}")
        out = out[:total]
    if idx.device.type == "cpu":
        plain = pack_rows_grouped_plain(srcs, idx, counts)
        return plain if out is None else out.copy_(plain)
    if idx.device.type != "cuda":
        raise RuntimeError(f"pack_rows: no kernel for device {idx.device}")
    if out is None:
        out = torch.empty(total, dtype=torch.uint8, device=idx.device)
    _launch_grouped(srcs, counts, offs, idx.data_ptr(), out.data_ptr(),
                    idx.device, torch.cuda.current_stream(idx.device))
    return out


# pinned host buffers seen by pack_rows_grouped_host, by id: a tensor
# stays pinned for its life, so each is asked once
_PINNED: Dict[int, "weakref.ref"] = {}


def _pinned_buffer(buf: torch.Tensor, what: str) -> None:
    ref = _PINNED.get(id(buf))
    if ref is not None and ref() is buf:
        return
    if buf.device.type != "cpu" or buf.dtype != torch.uint8 or \
            buf.dim() != 1 or not buf.is_contiguous() or \
            buf.data_ptr() % SEG_ALIGN or not buf.is_pinned():
        raise ValueError(f"pack_rows: {what} must be a contiguous 1-D uint8 "
                         f"pinned host buffer, 16-byte aligned")
    _PINNED[id(buf)] = weakref.ref(
        buf, lambda _, key=id(buf): _PINNED.pop(key, None))


def pack_rows_grouped_host(srcs: Sequence[torch.Tensor],
                           counts: Sequence[int], idx: torch.Tensor,
                           out: torch.Tensor,
                           stream: "torch.cuda.Stream") -> None:
    """``pack_rows_grouped`` of sources on a card with the indices and the
    staging buffer both in pinned host memory, which the kernel reads and
    writes directly across the bus (mapped under unified addressing):
    ``idx`` holds the ``sum(counts)`` int32 indices in its first bytes,
    ``out`` receives the segments of ``group_layout``.  Both are uint8
    buffers the caller keeps (each is checked once for its life), the
    launch goes on ``stream``, and the caller synchronizes it before it
    reads ``out`` or writes ``idx`` again.  This is the epoch drain's
    gather: no index upload precedes the launch."""
    if not srcs:
        return
    device = srcs[0].device
    if device.type != "cuda":
        raise RuntimeError(f"pack_rows: no kernel for device {device}")
    if len(srcs) != len(counts) or any(m < 0 for m in counts):
        raise ValueError(f"pack_rows_grouped: {len(srcs)} sources, counts "
                         f"{list(counts)}")
    for src in srcs:
        _check_src(src, device)
    _pinned_buffer(idx, "idx")
    _pinned_buffer(out, "out")
    offs, total = group_layout(srcs, counts)
    if 4 * sum(counts) > idx.shape[0] or total > out.shape[0]:
        raise ValueError(f"pack_rows: {sum(counts)} indices and {total} "
                         f"bytes do not fit buffers of {idx.shape[0]} and "
                         f"{out.shape[0]} bytes")
    _launch_grouped(srcs, counts, offs, idx.data_ptr(), out.data_ptr(),
                    device, stream)


def _launch_grouped(srcs, counts, offs, idx_ptr: int, out_ptr: int,
                    device: torch.device, stream) -> None:
    """The grouped kernel's launches over checked arguments: one for every
    ``MAX_GROUPS`` regions with rows, each counted in
    ``pack_rows.launches``."""
    desc, pos = [], 0
    for src, m, off in zip(srcs, counts, offs):
        rowbytes = _rowbytes(src)
        chunk = 16 if rowbytes % 16 == 0 else 8 if rowbytes % 8 == 0 else 4
        if src.data_ptr() % chunk:
            raise ValueError(f"pack_rows: {rowbytes} B rows at address "
                             f"{src.data_ptr():#x} are not {chunk}-byte "
                             f"aligned")
        desc.append((src.data_ptr(), src.shape[0], off, pos, m, rowbytes,
                     chunk))
        pos += m
    with torch.cuda.device(device):
        for lo in range(0, len(desc), MAX_GROUPS):
            part = np.array(desc[lo:lo + MAX_GROUPS], np.int64)
            rows = int(part[:, 4].sum())
            if rows == 0:
                continue
            rc = _build.load("pack_flush").pack_rows_grouped_launch(
                part.ctypes.data, len(part), idx_ptr, out_ptr,
                stream.cuda_stream)
            if rc:
                raise RuntimeError(f"pack_rows: kernel launch failed (CUDA "
                                   f"error {rc})")
            _build.note_launch(pack_rows, rows)


def pack_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows ``idx`` of ``src`` (N, W) into a packed (M, W) buffer of
    the same dtype; indices outside [0, N) give zero rows.  The row width
    in bytes must be a multiple of 4.  The one-region case of
    ``pack_rows_grouped``."""
    _check(src, idx)
    if src.device.type == "cpu":
        return pack_rows_plain(src, idx)
    m = idx.shape[0]
    staged = pack_rows_grouped([src], idx, [m])
    return staged[:m * _rowbytes(src)].view(src.dtype).reshape(m,
                                                               src.shape[1])


pack_rows.launches = 0
pack_rows.sizes = {}


# ---------------------------------------------------------------- scatter

def _check_scatter(dst: torch.Tensor, packed: torch.Tensor,
                   idx: torch.Tensor) -> None:
    if dst.dim() != 2 or packed.dim() != 2 or packed.shape[1] != dst.shape[1]:
        raise ValueError(f"scatter_rows: dst (N, W) and packed (M, W) "
                         f"expected, got {tuple(dst.shape)} and "
                         f"{tuple(packed.shape)}")
    if packed.dtype != dst.dtype:
        raise TypeError(f"scatter_rows: packed {packed.dtype} != dst "
                        f"{dst.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or \
            idx.shape[0] != packed.shape[0]:
        raise TypeError(f"scatter_rows: idx must be 1-D int32 of "
                        f"{packed.shape[0]} rows, got {idx.dtype} shape "
                        f"{tuple(idx.shape)}")
    if not (dst.device == packed.device == idx.device):
        raise ValueError("scatter_rows: dst, packed, idx on different "
                         "devices")
    if not (dst.is_contiguous() and packed.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError("scatter_rows: dst, packed and idx must be "
                         "contiguous")


def _winners(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Mask of the packed rows that land: a valid index, and the last row
    naming its dst row (the reference's sequential scatter keeps the last
    of duplicates)."""
    valid = (idx >= 0) & (idx < n)
    pos = torch.arange(idx.shape[0], device=idx.device)
    inv = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
    inv.scatter_reduce_(0, idx[valid].long(), pos[valid], reduce="amax")
    return valid & (inv[torch.where(valid, idx, 0).long()] == pos)


def scatter_rows_plain(dst: torch.Tensor, packed: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """Plain version, in place: ``dst[idx[i]] = packed[i]`` by advanced
    indexing for every ``0 <= idx[i] < len(dst)``, the last of duplicate
    indices winning.  Returns ``dst``."""
    _check_scatter(dst, packed, idx)
    keep = _winners(idx, dst.shape[0])
    dst[idx[keep].long()] = packed[keep]
    return dst


def scatter_rows_(dst: torch.Tensor, packed: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """In place ``dst[idx[i]] = packed[i]`` for ``0 <= idx[i] < N``; rows
    with another index (-1 is the padding sentinel) are skipped, and of
    duplicate indices the last packed row wins.  dst (N, W) and packed
    (M, W) of one dtype, idx (M,) int32.  Returns ``dst``.  Only the M
    scattered rows are touched, so a multi-GB dst is never copied."""
    _check_scatter(dst, packed, idx)
    if dst.device.type == "cpu":
        return scatter_rows_plain(dst, packed, idx)
    if dst.device.type != "cuda":
        raise RuntimeError(f"scatter_rows: no kernel for device "
                           f"{dst.device}")
    m = idx.shape[0]
    rowbytes = dst.shape[1] * dst.element_size()
    chunk = next(c for c in (16, 8, 4, 2, 1) if rowbytes % c == 0)
    if dst.data_ptr() % chunk or packed.data_ptr() % chunk:
        raise ValueError(f"scatter_rows: {rowbytes} B rows are not "
                         f"{chunk}-byte aligned")
    if m == 0 or rowbytes == 0:
        return dst
    inv = torch.full((dst.shape[0],), -1, dtype=torch.int32,
                     device=dst.device)
    lib = _build.load("pack_flush")
    with torch.cuda.device(dst.device):
        stream = torch.cuda.current_stream(dst.device).cuda_stream
        rc = lib.scatter_rows_launch(dst.data_ptr(), packed.data_ptr(),
                                     idx.data_ptr(), inv.data_ptr(),
                                     dst.shape[0], m, rowbytes, chunk,
                                     stream)
    if rc:
        raise RuntimeError(f"scatter_rows: kernel launch failed (CUDA error "
                           f"{rc})")
    _build.note_launch(scatter_rows_, m)
    return dst


scatter_rows_.launches = 0
scatter_rows_.sizes = {}


def scatter_rows(dst: torch.Tensor, packed: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Functional form, as the reference's: a copy of ``dst`` with the
    rows scattered (through ``scatter_rows_``)."""
    return scatter_rows_(dst.clone(), packed, idx)
