"""flash_attention: blockwise online-softmax attention on the card.

The model's prefill attention (``models/layers.blockwise_attention``) runs
here: q (H, Sq, D) against k, v (H / group, Skv, D), query head h reading
KV head h // group, so grouped-query attention needs no repeated copy of
K/V.  With group 1 this is the function of the TPU kernel it replaces,
``repro/kernels/flash_attention.py:flash_attention``: scores and the
running max, sum and accumulator are f32, masked scores are excluded by
``s > 0.5 * NEG_INF``, and the output is ``acc / max(l, 1e-30)`` in q's
dtype.  ``csrc/flash_attention.cu`` holds the two kernels and their design
note: bf16 inputs run on the tensor cores (wgmma on TMA-filled tiles, the
scale applied to the f32 scores, P rounded to bf16 for P.V); f32 inputs run
a register-blocked FMA kernel with q scaled in f32 before the product, as
the TPU kernel does.  The ragged edge (any Sq, Skv) is masked in the
kernels, where the TPU wrapper asserted divisibility.

Bound: the larger of 4·H·Sq·Skv·D flops (halved when causal) over the f32
rate (67 TFLOP/s) or, for bf16, 989 TFLOP/s, and the bytes of q, k, v and
o once over 3.35 TB/s; operations bound it at every shape the model uses.

``flash_attention`` dispatches by where its tensors live: CPU tensors take
``flash_attention_plain``; CUDA tensors launch a kernel or raise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_plain", "NEG_INF"]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Validate shapes, dtypes and devices; returns the group size."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (H, Sq, D) and k, v "
                         f"(Hkv, Skv, D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    h, _, d = q.shape
    hk = k.shape[0]
    if k.shape[2] != d or hk == 0 or h % hk:
        raise ValueError(f"flash_attention: {h} query heads of width {d} "
                         f"do not group over {hk} KV heads of width "
                         f"{k.shape[2]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: f32 or bf16 inputs of one dtype "
                        f"expected, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    return h // hk


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: materialized f32 scores per head, masked softmax,
    product, in q's dtype.  K/V are repeated per query group."""
    g = _check(q, k, v)
    h, sq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk = k.float().repeat_interleave(g, dim=0)
    vv = v.float().repeat_interleave(g, dim=0)
    s = torch.matmul(q.float() * scale, kk.transpose(1, 2))
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vv) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (H, Sq, D) over k, v (H / G, Skv, D), query head h
    reading KV head h // G; causal masks kpos > qpos (positions from 0 on
    both axes, as the TPU kernel).  Returns (H, Sq, D) in q's dtype."""
    g = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device "
                           f"{q.device}")
    h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {d} not in "
                         f"{HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if sq == 0:
        return out
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    # the kernels read 16-byte vectors and the TMA maps need 16-byte-aligned
    # bases (their strides, multiples of D * itemsize, are)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: q, k, v and the output must start "
                         "on 16-byte boundaries")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), h, sq,
            k.shape[1], d, g, int(causal), scale,
            int(q.dtype == torch.bfloat16), stream)
    if rc:
        raise RuntimeError(f"flash_attention: kernel launch failed (error "
                           f"{rc}: a CUDA error, or 10000 + the driver's "
                           f"CUresult when a TMA map cannot be encoded)")
    _build.note_launch(flash_attention, sq)
    return out


flash_attention.launches = 0
flash_attention.sizes = {}
