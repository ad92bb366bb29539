"""flash_attention: blockwise online-softmax attention on the card.

The model's prefill attention (``models/layers.blockwise_attention``) runs
here: q (H, Sq, D) against k, v (H / group, Skv, D), query head h reading
KV head h // group, so grouped-query attention needs no repeated copy of
K/V.  With group 1 this is the function of the TPU kernel it replaces,
``repro/kernels/flash_attention.py:flash_attention``: scores and the
running max, sum and accumulator are f32, masked scores are excluded by
``s > 0.5 * NEG_INF``, and the output is ``acc / max(l, 1e-30)`` in q's
dtype.  ``window`` and ``softcap`` add what the reference's layer
computes for gemma in XLA (``repro/models/layers.py:blockwise_attention``,
which its Pallas kernel lacks): the scaled scores are capped as
``softcap * tanh(s / softcap)`` before the mask, and a key is hidden when
``qpos - kpos >= window`` on top of the causal mask (one-sided: without
causal, later keys stay visible, as in the reference).  The kernel skips
the tiles below a block's window band.  Head widths 16 to 256.  ``csrc/flash_attention.cu`` holds the two
kernels and their design note: bf16 inputs run on the tensor cores (wgmma
on TMA-filled tiles, the scale applied to the f32 scores, P rounded to
bf16 for P.V); f32 inputs run a register-blocked FMA kernel with q scaled
in f32 before the product, as the TPU kernel does.  The ragged edge (any
Sq, Skv) is masked in the kernels, where the TPU wrapper asserted
divisibility.

Bound: the larger of 4·D flops per (query, key) pair the mask keeps
(H·Sq·Skv, halved when causal, about H·Sq·window under a window) over the
f32 rate (67 TFLOP/s) or, for bf16, 989 TFLOP/s, and the bytes of q, k, v
and o once over 3.35 TB/s; operations bound it at every shape the model
uses.

Training needs the gradient, which the TPU kernel never had (the reference
differentiates its jnp ``blockwise_attention`` through XLA).  With grad
enabled and an input that requires it, ``flash_attention`` runs through
``FlashAttentionFn``: its forward launches the same kernel and also keeps
the per-row logsumexp ``lse`` (H, Sq) f32, and its backward is
``flash_attention_bwd``, three hand-written kernels
(``csrc/flash_attention_bwd.cu``: Di = rowsum(dO·o) once into a scratch,
then dK and dV over KV tiles, then dQ over Q tiles; bf16 on the tensor
cores with P and dS rounded to bf16, f32 register-blocked on the FMA
units; f32 sums, no atomics, so the bits repeat).  The backward takes the
forward's ``window`` and ``softcap`` and every head width of
``HEAD_DIMS``: it recomputes each score as the forward does (capped in
f32 before the mask), so P = exp(s - lse) is the forward's, skips the
tiles outside a window's band in both of its walks (a key tile is seen
only by the query tiles from its own up to its last key + window - 1) and
masks only the band's edge tiles, and multiplies dS by the cap's chain
rule factor 1 - tanh(s_raw / softcap)^2 before dS feeds dK and dQ.  At
head width 256 each block keeps 64 keys (or rows) and its two halves of
threads own the two 128-column halves of dK and dV (or dQ), each
recomputing the scores: twice the score work, the accumulators of width
128.  Bound of the backward: 10·D flops per (query, key) pair the mask
keeps (H·Sq·Skv, halved when causal, about H·Sq·window under a window)
over the same rates.

Every wrapper dispatches by where its tensors live: CPU tensors take the
plain versions (``flash_attention_plain``, ``flash_attention_bwd_plain``);
CUDA tensors launch a kernel or raise.  Nothing falls back to autograd
through torch ops.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["BWD_HEAD_DIMS", "FlashAttentionFn", "HEAD_DIMS",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_delta_plain", "flash_attention_bwd_plain",
           "flash_attention_plain", "NEG_INF"]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = HEAD_DIMS
# the kernels flash_attention_bwd_launch runs, by bit: the Di pass, dK/dV, dQ
BWD_DELTA, BWD_DKDV, BWD_DQ = 1, 2, 4
BWD_ALL = BWD_DELTA | BWD_DKDV | BWD_DQ
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


def _masked(s: torch.Tensor, causal: bool, window: int = 0) -> torch.Tensor:
    """Scores (H, Sq, Skv) with NEG_INF where causal hides a key (kpos >
    qpos) or the window does (qpos - kpos >= window); the softmax then
    excludes ``s <= 0.5 * NEG_INF``."""
    if not causal and not window:
        return s
    sq, skv = s.shape[-2:]
    ahead = (torch.arange(sq, device=s.device)[:, None]
             - torch.arange(skv, device=s.device)[None, :])
    keep = torch.ones_like(ahead, dtype=torch.bool)
    if causal:
        keep &= ahead >= 0
    if window:
        keep &= ahead < window
    return torch.where(keep, s, NEG_INF)


def _capped(s: torch.Tensor, softcap: float) -> torch.Tensor:
    return softcap * torch.tanh(s / softcap) if softcap else s


def _check_band(window: int, softcap: float) -> None:
    if window < 0 or not softcap >= 0:
        raise ValueError(f"flash_attention: window >= 0 and softcap >= 0 "
                         f"expected, got {window}, {softcap}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          window: int = 0, softcap: float = 0.0,
                          return_lse: bool = False):
    """Plain version: materialized f32 scores per head, capped, masked
    softmax, product, in q's dtype.  K/V are repeated per query group.
    With ``return_lse``, also the per-row logsumexp of the scaled (and
    capped) scores, (H, Sq) f32, +inf for a row with no visible key."""
    g = _check(q, k, v)
    _check_band(window, softcap)
    d = q.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk = k.float().repeat_interleave(g, dim=0)
    vv = v.float().repeat_interleave(g, dim=0)
    s = _masked(_capped(torch.matmul(q.float() * scale, kk.transpose(1, 2)),
                        softcap), causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p, vv) / torch.clamp(l, min=1e-30)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), math.inf)[..., 0]
    return out, lse


def flash_attention_bwd_delta_plain(o: torch.Tensor,
                                    do: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward's Di pass: Di = rowsum(dO · o) in f32,
    (H, Sq)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True,
                              scale: Optional[float] = None,
                              window: int = 0, softcap: float = 0.0):
    """Plain version of the backward: (dq, dk, dv) of the forward's output
    ``o`` under the incoming gradient ``do``, from the forward's ``lse``,
    the explicit formula of ``csrc/flash_attention_bwd.cu`` in f32, each
    in its input's dtype; dk, dv summed over each KV head's query group.
    The scores are capped and masked as the forward's (``window``,
    ``softcap``), and dS takes the cap's factor 1 - tanh(s_raw /
    softcap)^2."""
    g = _check(q, k, v)
    _check_bwd(q, k, o, do, lse)
    _check_band(window, softcap)
    h, sq, d = q.shape
    hk, skv = k.shape[:2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kk = k.float().repeat_interleave(g, dim=0)
    vv = v.float().repeat_interleave(g, dim=0)
    s = torch.matmul(qf, kk.transpose(1, 2)) * scale
    t = torch.tanh(s / softcap) if softcap else None
    s = _masked(softcap * t if softcap else s, causal, window)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - lse[..., None]), 0.0)
    di = flash_attention_bwd_delta_plain(o, do)[..., None]
    dv = torch.matmul(p.transpose(1, 2), dof)
    ds = p * (torch.matmul(dof, vv.transpose(1, 2)) - di)
    if softcap:
        ds = ds * (1.0 - t * t)
    dq = torch.matmul(ds, kk) * scale
    dk = torch.matmul(ds.transpose(1, 2), qf) * scale
    dk = dk.reshape(hk, g, skv, d).sum(dim=1)
    dv = dv.reshape(hk, g, skv, d).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q: torch.Tensor, k: torch.Tensor, o: torch.Tensor,
               do: torch.Tensor, lse: torch.Tensor) -> None:
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o and do must be shaped as "
                         f"q {tuple(q.shape)}, got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd: o and do must be {q.dtype}, "
                        f"got {o.dtype}, {do.dtype}")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be f32 "
                         f"{tuple(q.shape[:2])}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if not (o.device == do.device == lse.device == q.device == k.device):
        raise ValueError("flash_attention_bwd: tensors on different devices")


def _kernel_ready(name: str, q: torch.Tensor, k: torch.Tensor,
                  *more: torch.Tensor, widths=HEAD_DIMS) -> None:
    """Raise unless the kernel takes these CUDA tensors: a head width of
    ``widths``, at least one key, 16-byte aligned contiguous bases."""
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    if q.shape[2] not in widths:
        raise ValueError(f"{name}: head width {q.shape[2]} not in "
                         f"{widths}")
    if k.shape[1] == 0:
        raise ValueError(f"{name}: no keys (Skv = 0)")
    # the kernels read 16-byte vectors and the TMA maps need 16-byte-aligned
    # bases (their strides, multiples of D * itemsize, are)
    if any(t.data_ptr() % 16 for t in (q, k, *more)):
        raise ValueError(f"{name}: every tensor must start on a 16-byte "
                         f"boundary")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, scale: Optional[float], with_lse: bool,
             window: int = 0, softcap: float = 0.0):
    """(out, lse or None): the plain version on CPU tensors, else one
    launch of the forward kernel, which writes lse when asked."""
    g = _check(q, k, v)
    _check_band(window, softcap)
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                    window=window, softcap=softcap,
                                    return_lse=with_lse)
        return out if with_lse else (out, None)
    h, sq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if sq == 0:
        return out, lse
    _kernel_ready("flash_attention", q, k, v, out,
                  *([lse] if with_lse else []))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, h, sq, k.shape[1], d, g,
            int(causal), scale, int(window), float(softcap),
            int(q.dtype == torch.bfloat16), stream)
    if rc:
        raise RuntimeError(f"flash_attention: kernel launch failed (error "
                           f"{rc}: a CUDA error, or 10000 + the driver's "
                           f"CUresult when a TMA map cannot be encoded)")
    _build.note_launch(flash_attention, sq)
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None, window: int = 0,
                        softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention``: CPU tensors take
    ``flash_attention_bwd_plain``; CUDA tensors launch the three backward
    kernels (the Di pass, dK/dV, then dQ) of
    ``csrc/flash_attention_bwd.cu``, counted as one launch of this
    wrapper, or raise.  ``window`` and ``softcap`` must be the
    forward's."""
    g = _check(q, k, v)
    _check_bwd(q, k, o, do, lse)
    _check_band(window, softcap)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         scale=scale, window=window,
                                         softcap=softcap)
    h, sq, d = q.shape
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if sq == 0:
        return dq, dk.zero_(), dv.zero_()
    di = torch.empty((h, sq), dtype=torch.float32, device=q.device)
    _kernel_ready("flash_attention_bwd", q, k, v, o, do, lse, di, dq, dk,
                  dv, widths=BWD_HEAD_DIMS)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), h, sq, k.shape[1], d, g,
            int(causal), scale, int(window), float(softcap),
            int(q.dtype == torch.bfloat16), BWD_ALL, stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed "
                           f"(error {rc}: a CUDA error, or 10000 + the "
                           f"driver's CUresult when a TMA map cannot be "
                           f"encoded)")
    _build.note_launch(flash_attention_bwd, sq)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward keeps q, k, v, o
    and the per-row lse, the backward runs ``flash_attention_bwd`` on
    them.  On CPU tensors the same wiring runs the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window=0, softcap=0.0):
        out, lse = _forward(q, k, v, causal, scale, True, window, softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.window, ctx.softcap = window, softcap
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), lse,
                                         causal=ctx.causal, scale=ctx.scale,
                                         window=ctx.window,
                                         softcap=ctx.softcap)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Attention of q (H, Sq, D) over k, v (H / G, Skv, D), query head h
    reading KV head h // G; causal masks kpos > qpos (positions from 0 on
    both axes, as the TPU kernel), ``window`` > 0 also qpos - kpos >=
    window, and ``softcap`` > 0 caps the scaled scores first.  Returns
    (H, Sq, D) in q's dtype.  With grad enabled and an input that requires
    it, the call goes through ``FlashAttentionFn``, whose backward is
    ``flash_attention_bwd`` with the same window and cap."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, scale, window,
                                      softcap)
    return _forward(q, k, v, causal, scale, False, window, softcap)[0]


flash_attention.launches = 0
flash_attention.sizes = {}
flash_attention_bwd.launches = 0
flash_attention_bwd.sizes = {}
