"""Core transformer layers, the port of ``repro.models.layers``: norms,
RoPE, gated MLPs, attention for prefill and decode, ring-buffer helpers.

Plain functions on tensors in the reference's layouts (``(B, S, K, G, Dh)``
queries, ``(B, S, K, Dh)`` keys and values), so the two packages compare
like with like.  Norms, RoPE and softmax compute in f32 and return the
input's dtype; matrix products run in the compute dtype.  Where the
reference asks XLA for an f32 result that it uses before rounding (the
gated MLPs' gate and up products, the decode scores), ``f32_product``
gives one: on the card a bf16 tensor-core product with an f32 output
(``torch.mm``/``torch.bmm`` with ``out_dtype``), on the CPU the same
values from the operands upcast; its backward is the bf16 products the
rounded result had.  The other products round their f32 accumulation to
the compute dtype once, as the reference's ``.astype(dt)`` does.

Prefill and training attention, ``blockwise_attention``, is the
``flash_attention`` kernel on a CUDA tensor and its plain version on the
CPU; when its inputs require grad (train mode) the call goes through
``FlashAttentionFn``, whose backward is the hand-written
``flash_attention_bwd`` (the reference differentiates its jnp layer with
XLA; the gradient is the same function).  The kernel
scales q in f32 before the product, as the TPU kernel does; the
reference's layer rounds ``q * scale`` to q's dtype first.  In f32 the two
agree to rounding; in bf16 they differ by one bf16 rounding of q, which is
inside the 2e-2 the reference's own kernel tests allow.  Sliding windows
and score softcaps (gemma's local layers and gemma2's cap) go to the
kernel too, which skips the tiles below a window's band, and so does
their gradient: the backward kernels take the same window and cap.

Not ported: ``LOWP_ROW_REDUCE`` (a distributed-cell switch) and the mesh
hooks ``constrain_activations``/``seq_parallel``, which are identities
without a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


# ----------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, f32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate-half RoPE.  x: (B, S, N, D) [or (B, S, N, G, D)] with
    positions (S,)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] * inv
    for _ in range(x.dim() - ang.dim() - 1):   # broadcast over head axes
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ gated MLP

def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh")}[name]


class _F32Product(torch.autograd.Function):
    """``a @ b`` of two bf16 operands, (M, K) x (K, N) or batched
    (E, M, K) x (E, K, N), with an f32 result.  The backward rounds the
    incoming gradient to bf16 and runs the two bf16 products autograd
    would run for a bf16 result cast to f32, so only the forward gains
    precision."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        if a.is_cuda:
            return mm(a, b, out_dtype=torch.float32)
        return mm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        ga = mm(g, b.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        gb = mm(a.transpose(-1, -2), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32, from operands in the compute dtype: a (..., K)
    times b (K, N), or a (E, M, K) times b (E, K, N) batched.  f32
    operands take ``torch.matmul`` as before; bf16 ones keep bf16
    tensor-core products on the card (never f32 operands)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if b.dim() == 2:
        out = _F32Product.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return _F32Product.apply(a, b)


def gate_up(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            act: str) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)`` with both products' results in f32,
    rounded to x's dtype: the reference's gated-MLP inner product
    (``preferred_element_type=f32``) for a gated MLP (w (d, f)) or the
    experts of an MoE layer (x (E, M, d), w (E, d, f))."""
    dt = x.dtype
    g = f32_product(x, w_gate.to(dt))
    u = f32_product(x, w_up.to(dt))
    return (act_fn(act)(g) * u).to(dt)


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, act: str) -> torch.Tensor:
    """x: (..., d).  w_gate/w_up: (d, f); w_down: (f, d)."""
    h = gate_up(x, w_gate, w_up, act)
    return torch.matmul(h, w_down.to(x.dtype))


# ------------------------------------------------------------ attention

def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


@dataclasses.dataclass(frozen=True)
class AttnParams:
    """Weight bundle for one attention mixer."""
    wq: torch.Tensor        # (d, H, Dh)
    wk: torch.Tensor        # (d, K, Dh)
    wv: torch.Tensor        # (d, K, Dh)
    wo: Optional[torch.Tensor]          # (H, Dh, d)
    q_norm: Optional[torch.Tensor] = None   # (Dh,) gemma3 qk-norm
    k_norm: Optional[torch.Tensor] = None


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) times w (d, N, E) -> (B, S, N, E)."""
    d, n, e = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, n * e)).reshape(
        *x.shape[:-1], n, e)


def project_qkv(x: torch.Tensor, p: AttnParams, n_kv: int, *,
                positions: torch.Tensor, theta: float,
                qk_norm_eps: float = 1e-6, use_rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q: (B, S, K, G, Dh); k, v: (B, S, K, Dh)."""
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, qk_norm_eps)
        k = rms_norm(k, p.k_norm, qk_norm_eps)
    if use_rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    b, s, h, e = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, e), k, v


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0,
                        softcap: float = 0.0, q_block: int = 1024,
                        kv_block: int = 1024,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a whole sequence.  q: (B, S, K, G, Dh); k, v:
    (B, Skv, K, Dh).  Returns (B, S, K, G, Dh).

    The (B, K, G) axes fold into the kernel's query heads and (B, K) into
    its KV heads, so query head (b, k, g) reads KV head (b, k) with no
    repeated K/V.  ``window`` and ``softcap`` are the reference's (a key is
    hidden when qpos - kpos >= window; scores are capped before the mask).
    ``q_block``/``kv_block`` are the reference's XLA tiling and are not
    used: the kernel tiles itself."""
    b, s, n_kv, g, dh = q.shape
    skv = k.shape[1]
    qh = q.permute(0, 2, 3, 1, 4).reshape(b * n_kv * g, s, dh)
    kh = k.permute(0, 2, 1, 3).reshape(b * n_kv, skv, dh)
    vh = v.permute(0, 2, 1, 3).reshape(b * n_kv, skv, dh)
    out = flash_attention(qh, kh, vh, causal=causal, scale=scale,
                          window=window, softcap=softcap)
    return out.reshape(b, n_kv, g, s, dh).permute(0, 3, 1, 2, 4)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     pos, *, window: int = 0, softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step attention against a cache.  q: (B, 1, K, G, Dh);
    k_cache/v_cache: (B, C, K, Dh); kv_positions: (C,) absolute position
    held by each cache slot (-1 empty); pos: the current position."""
    b, _, n_kv, g, dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qs = q[:, 0] * scale                                  # (B, K, G, Dh)
    # f32 scores from the compute-dtype q and k, as the reference asks
    # XLA for them: the softcap and the softmax see no bf16 rounding
    kt = k_cache.permute(0, 2, 1, 3).reshape(b * n_kv, -1, dh)
    s = f32_product(qs.reshape(b * n_kv, g, dh), kt.transpose(1, 2))
    s = _softcap(s.reshape(b, n_kv, g, -1), softcap)
    valid = (kv_positions >= 0) & (kv_positions <= pos)
    if window:
        valid &= kv_positions > pos - window
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", p.to(v_cache.dtype), v_cache)
    return out[:, None].to(q.dtype)


def attn_out(attended: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """attended: (B, S, K, G, Dh); wo: (H, Dh, d) -> (B, S, d)."""
    b, s, n_kv, g, dh = attended.shape
    a = attended.reshape(b, s, n_kv * g * dh)
    return torch.matmul(a, wo.to(a.dtype).reshape(n_kv * g * dh, -1))


# ---------------------------------------------- ring-buffer cache helpers

def ring_slot_positions(pos: int, cap: int, device=None) -> torch.Tensor:
    """Absolute position stored in each ring slot after writing ``pos`` at
    slot pos % cap: slot w holds the largest p <= pos with p % cap == w
    (or -1 if none)."""
    slots = torch.arange(cap, device=device)
    p = pos - ((pos - slots) % cap)
    return torch.where(p >= 0, p, -1)


def ring_write(cache: torch.Tensor, value: torch.Tensor, pos: int,
               cap: int) -> torch.Tensor:
    """A copy of cache (B, cap, ...) with value (B, 1, ...) written at slot
    pos % cap."""
    out = cache.clone()
    out[:, pos % cap] = value[:, 0].to(cache.dtype)
    return out
