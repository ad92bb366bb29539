"""pack_flush: gather dirty rows into one staging buffer.

The device half of the epoch drain (core/writeset.py): the dirty rows of a
region's volatile tensor are packed into one contiguous (M, ...) buffer on
the card, which the drain then copies to the host in one transfer and
writes into the persistent image.  ``csrc/pack_flush.cu`` holds the Hopper
kernel and its design note.

``pack_rows`` dispatches by where its tensors live: CPU tensors take
``pack_rows_plain``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["pack_rows", "pack_rows_plain"]


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
