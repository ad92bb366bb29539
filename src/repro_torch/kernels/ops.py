"""Public wrappers around the kernels, the port of ``repro.kernels.ops``.

* ``pack_rows``/``scatter_rows`` pad the row width D up to a multiple of
  128 elements, as the reference does, call the kernels of
  ``kernels/pack_flush.py`` and slice the result back to D.  ``block_d``
  is accepted and has no effect: the CUDA kernels do not tile D.
* ``quantize_leaf``/``dequantize_leaf`` flatten any leaf to rows for the
  quantize kernels (below).
* ``hash_lookup`` probes the bucketed table at each query's bucket
  ``hash32(q) % n_buckets`` through ``kernels/hash_probe.probe_hashed``:
  on the card the kernel hashes (the reference hashes outside its Pallas
  kernel); on the CPU ``hash32`` runs in torch ops, then ``probe_plain``.

``_as_rows`` flattens any leaf to (rows, width) with the reference's exact
geometry, so the int8 payload and the scales land in the same places and
persist as the same bytes: width = 256 * clamp(ceil(n/256), 1, 16), rows
padded with zeros up to a multiple of 8.  The all-zero padding groups get
the scale ``1e-12 * f32(1/127)`` and are persisted as they are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import hash_probe, pack_flush, quant_pack
from repro_torch.kernels.hash_probe import hash32
from repro_torch.kernels.quant_pack import GROUP

__all__ = ["pack_rows", "scatter_rows", "quantize_leaf", "dequantize_leaf",
           "hash_lookup", "hash32"]

LANE = 128


def _pad_cols(x: torch.Tensor, mult: int = LANE) -> torch.Tensor:
    """``x`` (N, D) with zero columns appended up to a multiple of
    ``mult``; ``x`` itself when D already is one."""
    pad = (-x.shape[1]) % mult
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad))], 1)


# ---------------- pack / scatter ----------------

def pack_rows(src: torch.Tensor, idx: torch.Tensor,
              block_d: int = 512) -> torch.Tensor:
    """Gather rows ``idx`` (M,) int32 of ``src`` (N, D) into a contiguous
    (M, D) buffer; -1 gives a zero row."""
    d0 = src.shape[1]
    return pack_flush.pack_rows(_pad_cols(src), idx)[:, :d0].contiguous()


def scatter_rows(dst: torch.Tensor, packed: torch.Tensor, idx: torch.Tensor,
                 block_d: int = 512) -> torch.Tensor:
    """A copy of ``dst`` (N, D) with ``packed[i]`` written to row
    ``idx[i]`` for every ``idx[i] >= 0``."""
    d0 = dst.shape[1]
    out = pack_flush.scatter_rows(_pad_cols(dst), _pad_cols(packed), idx)
    return out[:, :d0].contiguous()



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
    """Rows back to a ``dtype`` leaf of ``shape``; an f32 or bf16 leaf is
    written in its dtype by the kernel itself."""
    rows = quant_pack.dequantize_blockwise(
        q, s, dtype if dtype in (torch.float32, torch.bfloat16)
        else torch.float32)
    n_el = 1
    for d in shape:
        n_el *= int(d)
    return rows.reshape(-1)[:n_el].reshape(tuple(shape)).to(dtype)


# ---------------- hash probe ----------------

def hash_lookup(keys_table: torch.Tensor, queries: torch.Tensor
                ) -> torch.Tensor:
    """keys_table: (n_buckets, 128) int32; queries (Q,) int32.  Returns
    global slot ids (Q,) int32, -1 where absent."""
    return hash_probe.probe_hashed(keys_table, queries)
