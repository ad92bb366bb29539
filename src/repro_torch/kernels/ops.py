"""Leaf-level wrappers around the quantize kernels, the port of
``repro.kernels.ops.quantize_leaf``/``dequantize_leaf``.

``_as_rows`` flattens any leaf to (rows, width) with the reference's exact
geometry, so the int8 payload and the scales land in the same places and
persist as the same bytes: width = 256 * clamp(ceil(n/256), 1, 16), rows
padded with zeros up to a multiple of 8.  The all-zero padding groups get
the scale ``1e-12 * f32(1/127)`` and are persisted as they are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import quant_pack
from repro_torch.kernels.quant_pack import GROUP

__all__ = ["quantize_leaf", "dequantize_leaf"]


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    """Flatten any leaf to (N, GROUP*k) f32 rows, padding the tail."""
    flat = x.reshape(-1)
    n_el = flat.shape[0]
    width = GROUP * max(1, min(16, (n_el + GROUP - 1) // GROUP))
    rows = -(-n_el // width)
    rows8 = -(-rows // 8) * 8
    padded = torch.zeros(rows8 * width, dtype=torch.float32,
                         device=x.device)
    padded[:n_el] = flat
    return padded.reshape(rows8, width)


def quantize_leaf(x: torch.Tensor):
    """Any-shaped float leaf -> (q int8 rows, scales) for persist."""
    return quant_pack.quantize_blockwise(_as_rows(x))


def dequantize_leaf(q: torch.Tensor, s: torch.Tensor, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    rows = quant_pack.dequantize_blockwise(q, s)
    n_el = 1
    for d in shape:
        n_el *= int(d)
    return rows.reshape(-1)[:n_el].reshape(tuple(shape)).to(dtype)
