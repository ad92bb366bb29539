"""pack_flush: gather dirty rows into one staging buffer, and scatter
packed rows back.

The device half of the epoch drain (core/writeset.py): the dirty rows of a
region's volatile tensor are packed into one contiguous (M, ...) buffer on
the card, which the drain then copies to the host in one transfer and
writes into the persistent image.  ``csrc/pack_flush.cu`` holds the Hopper
kernel and its design note.

``scatter_rows_`` is the inverse, in place: ``dst[idx[i]] = packed[i]``.
The serving engine seats each re-prefill group's cache rows with it, one
launch per cache leaf per group (``serve/engine.py``); ``scatter_rows`` is
the reference's functional form on a copy.

Both dispatch by where their tensors live: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["pack_rows", "pack_rows_plain", "scatter_rows",
           "scatter_rows_", "scatter_rows_plain"]


def _check(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.dim() != 2:
        raise ValueError(f"pack_rows: src must be 2-D (rows, words), "
                         f"got shape {tuple(src.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"pack_rows: idx must be 1-D int32, got "
                        f"{idx.dtype} shape {tuple(idx.shape)}")
    if src.device != idx.device:
        raise ValueError(f"pack_rows: src on {src.device}, idx on "
                         f"{idx.device}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("pack_rows: src and idx must be contiguous")
    if (src.shape[1] * src.element_size()) % 4:
        raise ValueError(f"pack_rows: {src.shape[1] * src.element_size()} B "
                         f"rows are not a multiple of 4 bytes")


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


def pack_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows ``idx`` of ``src`` (N, W) into a packed (M, W) buffer of
    the same dtype; indices outside [0, N) give zero rows.  The row width
    in bytes must be a multiple of 4; the kernel moves 16-byte chunks when
    it is a multiple of 16."""
    _check(src, idx)
    if src.device.type == "cpu":
        return pack_rows_plain(src, idx)
    if src.device.type != "cuda":
        raise RuntimeError(f"pack_rows: no kernel for device {src.device}")
    m = idx.shape[0]
    out = torch.empty((m, src.shape[1]), dtype=src.dtype, device=src.device)
    rowbytes = src.shape[1] * src.element_size()
    chunk = next(c for c in (16, 8, 4) if rowbytes % c == 0)
    if src.data_ptr() % chunk or out.data_ptr() % chunk:
        raise ValueError(f"pack_rows: {rowbytes} B rows at address "
                         f"{src.data_ptr():#x} are not {chunk}-byte aligned")
    if m == 0:
        return out
    lib = _build.load("pack_flush")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.pack_rows_launch(src.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), src.shape[0], m, rowbytes,
                                  chunk, stream)
    if rc:
        raise RuntimeError(f"pack_rows: kernel launch failed (CUDA error "
                           f"{rc})")
    pack_rows.launches += 1
    return out


pack_rows.launches = 0


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
    scatter_rows_.launches += 1
    return dst


scatter_rows_.launches = 0


def scatter_rows(dst: torch.Tensor, packed: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Functional form, as the reference's: a copy of ``dst`` with the
    rows scattered (through ``scatter_rows_``)."""
    return scatter_rows_(dst.clone(), packed, idx)
