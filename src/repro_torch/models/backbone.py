"""Backbone: parameter and cache shapes, initialisation and layer
application, the port of ``repro.models.backbone``.

The stack is ``n_super`` repetitions of the config's ``layer_pattern``
("superblock") plus an unrolled remainder.  Superblock parameters are
stacked on a leading axis, so ``param_specs`` has the reference's tree:
``embed``, ``final_norm``, ``blocks/pos<i>/...`` (leading dim n_super),
``rem/rem<i>/...``, ``lm_head`` when embeddings are untied, and the
encoder's ``enc_blocks``/``enc_final_norm``.  Decode caches have the same
tree shape (``cache_specs``).

``apply_layer`` runs the attention layers with a dense or an MoE FFN
(base ``dense``, ``attn`` or ``moe``, the latter through
``models/moe.py``; variants ``full``, ``bidir``, ``local``, gemma's
sliding-window layer, whose ring cache holds ``min(window, s_max)``
positions, and ``cross``) in train, prefill and decode mode.  A
``cross`` layer attends to a context ``ctx`` (B, C, d) with no RoPE and
no mask (``_cross_attention_seq``): in a ``vlm`` model it replaces
self-attention and is gated by ``tanh(xgate)``; in an ``audio`` model it
follows causal self-attention (``ln_x``).  Prefill caches the context's
keys and values as computed (``xk``, ``xv``, C long, not a ring) and
decode reads them back unchanged, passing the same tensors on.

A ``hybrid`` layer (hymba; variants ``full`` and ``local``) runs
attention and mamba heads side by side on the same normed input
(``_hybrid``): causal attention through ``blockwise_attention``, the
mamba branch through ``models/ssm.py`` (``_mamba_seq`` from a zero state
in train and prefill mode, ``_mamba_step`` on the cached ``ssm`` state
and ``conv`` tail in decode), each branch normed and projected, the two
averaged, then the gated MLP.  The reference's cast points are kept: the
input projection rounds to the compute dtype, ``x_proj``'s product and
with it ``dt_low``/``bmat``/``cmat`` stay f32, the step sizes round to
the compute dtype before the scan, and the two output projections are
compute-dtype products.

The xLSTM layers (``mlstm``, ``slstm``; variant ``full``) run through
``models/xlstm.py``: the chunkwise mLSTM from a zero state in train and
prefill mode and ``mlstm_step`` on the cached ``c``/``n``/``m`` in decode;
the sLSTM scan likewise, its cache ``c``/``n``/``h``/``m``.  The
reference's cast points are kept: q, k and v are f32 products rounded to
the compute dtype, the mLSTM gates and output gate stay f32, the mLSTM
output projection is an f32 product rounded once, the sLSTM gate
pre-activations are an f32 product plus bias rounded to the compute
dtype, and the sLSTM output is cast to the layer's dtype before its norm
and compute-dtype projection, then the gated MLP.  Any other variant of
those bases raises ``NotImplementedError`` naming itself.

Train mode is a full-sequence forward with no caches.  ``REMAT`` picks
what a training forward keeps of each superblock for the backward
(``remat_wrap``), as the reference's ``jax.checkpoint`` policies do:
"full" keeps only the superblock's input and recomputes the rest
(``torch.utils.checkpoint``, non-reentrant), "none" keeps everything,
"dots" keeps the outputs of the 2-D matrix products (the projections and
MLP products, which carry no batch dimension: the reference's
``dots_with_no_batch_dims_saveable``) through selective activation
checkpointing and recomputes the rest, attention included.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.core.arena import not_ported
from repro_torch.core.policy import tree_map
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X

PyTree = Any

# Remat policy applied to the superblock body in train mode.  "none" saves
# everything (no recompute), "full" saves nothing (max recompute, min
# memory), "dots" saves matmul outputs with no batch dims.
REMAT = {"policy": "full"}


def _dots_policy(ctx, op, *args, **kwargs):
    # mm.dtype: a bf16 product with an f32 result (layers.f32_product)
    if op in (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn):
    """``fn`` under the current ``REMAT`` policy, for a training forward."""
    pol = REMAT["policy"]
    if pol == "none":
        return fn
    if pol == "dots":
        def context():
            return create_selective_checkpoint_contexts(_dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=context)
    if pol != "full":
        raise ValueError(f"unknown remat policy {pol!r}")
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def parse_tag(tag: str) -> Tuple[str, str]:
    base, _, var = tag.partition(":")
    return base, (var or "full")


def _attn_shapes(cfg: ArchConfig, cross: bool = False) -> Dict[str, Tuple[int, ...]]:
    d, h, k, e = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    out = {"wq": (d, h, e), "wk": (d, k, e), "wv": (d, k, e), "wo": (h, e, d)}
    if cfg.qk_norm and not cross:
        out["q_norm"] = (e,)
        out["k_norm"] = (e,)
    return out


def _mlp_shapes(d: int, f: int) -> Dict[str, Tuple[int, ...]]:
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def _moe_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    mc = cfg.moe
    d = cfg.d_model
    f = mc.expert_d_ff or cfg.d_ff
    out = {
        "router": (d, mc.n_experts),
        "w_gate": (mc.n_experts, d, f),
        "w_up": (mc.n_experts, d, f),
        "w_down": (mc.n_experts, f, d),
    }
    if mc.shared_expert:
        out.update({"s_gate": (d, f), "s_up": (d, f), "s_down": (f, d)})
    return out


def _mamba_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    di = cfg.ssm.expand * d
    n = cfg.ssm.state_dim
    dt_rank = max(1, d // 16)
    return {
        "in_proj": (d, 2 * di),
        "conv": (di, cfg.ssm.conv_width),
        "x_proj": (di, dt_rank + 2 * n),
        "dt_w": (dt_rank, di),
        "dt_bias": (di,),
        "a_log": (di, n),
        "d_skip": (di,),
    }


def layer_shapes(cfg: ArchConfig, tag: str) -> Dict[str, Any]:
    base, var = parse_tag(tag)
    d = cfg.d_model
    sh: Dict[str, Any] = {"ln1": (d,)}
    if base in ("dense", "attn", "moe"):
        if var == "cross" and cfg.family == "vlm":
            sh["xattn"] = _attn_shapes(cfg, cross=True)
            sh["xgate"] = ()
        else:
            sh["attn"] = _attn_shapes(cfg)
            if var == "cross":              # audio: self + cross
                sh["ln_x"] = (d,)
                sh["xattn"] = _attn_shapes(cfg, cross=True)
        sh["ln2"] = (d,)
        if base == "moe":
            sh["moe"] = _moe_shapes(cfg)
        else:
            sh["mlp"] = _mlp_shapes(d, cfg.d_ff)
    elif base == "hybrid":
        di = cfg.ssm.expand * d
        sh["attn"] = _attn_shapes(cfg)
        sh["mamba"] = _mamba_shapes(cfg)
        sh["norm_attn"] = (cfg.n_heads * cfg.resolved_head_dim,)
        sh["norm_mamba"] = (di,)
        sh["ln2"] = (d,)
        sh["mlp"] = _mlp_shapes(d, cfg.d_ff)
        # wo lives in sh["attn"]; hybrid projects the *combined* stream:
        sh["attn"] = {k: v for k, v in sh["attn"].items() if k != "wo"}
        sh["wo"] = (cfg.n_heads * cfg.resolved_head_dim, d)
        sh["w_mamba_out"] = (di, d)
    elif base == "mlstm":
        h = cfg.n_heads
        dv = cfg.resolved_head_dim
        dk = max(dv // 2, 8)
        sh.update({
            "wq": (d, h, dk), "wk": (d, h, dk), "wv": (d, h, dv),
            "w_if": (d, 2, h), "b_if": (2, h), "w_og": (d, h, dv),
            "out_norm": (h * dv,), "wo": (h, dv, d),
        })
    elif base == "slstm":
        h = cfg.n_heads
        dh = cfg.d_model // cfg.n_heads
        fx = int((cfg.xlstm.proj_factor if cfg.xlstm else 2.0) * d)
        sh.update({
            "w_in": (d, 4, h, dh), "b_in": (4, h, dh), "r": (4, h, dh, dh),
            "out_norm": (d,), "wo": (d, d), "ln2": (d,),
            "mlp": _mlp_shapes(d, fx),
        })
    else:
        raise ValueError(f"unknown layer tag {tag}")
    return sh


def _spec(shape) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch.float32, device="meta")


def _leaf_specs(tree, prefix_dims=()):
    """Shape tuples (the leaves of ``layer_shapes``) -> meta tensors."""
    if isinstance(tree, dict):
        return {k: _leaf_specs(v, prefix_dims) for k, v in tree.items()}
    return _spec(tuple(prefix_dims) + tuple(tree))


def param_specs(cfg: ArchConfig) -> PyTree:
    """The parameter tree as f32 ``meta`` tensors (shapes, no storage)."""
    pattern, n_super, rem = cfg.pattern_plan()
    p: Dict[str, Any] = {
        "embed": _spec((cfg.vocab_padded, cfg.d_model)),
        "final_norm": _spec((cfg.d_model,)),
    }
    if n_super:
        p["blocks"] = {
            f"pos{i}": _leaf_specs(layer_shapes(cfg, t), (n_super,))
            for i, t in enumerate(pattern)
        }
    if rem:
        p["rem"] = {
            f"rem{i}": _leaf_specs(layer_shapes(cfg, t))
            for i, t in enumerate(rem)
        }
    if not cfg.tie_embeddings:
        p["lm_head"] = _spec((cfg.d_model, cfg.vocab_padded))
    if cfg.encoder_layers:
        p["enc_blocks"] = {
            "pos0": _leaf_specs(layer_shapes(cfg, "dense:bidir"),
                                (cfg.encoder_layers,))
        }
        p["enc_final_norm"] = _spec((cfg.d_model,))
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None, dtype=torch.float32) -> PyTree:
    """Materialize real parameters with the reference's scale rule: 0-d
    and 1-d leaves (norms, biases, gates) start at zero, the others are
    ``min(0.02, fan_in**-0.5) * N(0, 1)``; then the SSM special inits.
    Leaves draw from ``generator`` (on ``device``; None means the
    generator's) in flatten order, in f32, each rounded to ``dtype`` as
    it is drawn (so a bf16 tree never holds more than one f32 leaf).
    Torch's draws are not JAX's: only shapes and the init rule are held
    against the reference."""
    device = generator.device if device is None else torch.device(device)
    params = tree_map(lambda spec: init_leaf(spec, generator, device, dtype),
                      param_specs(cfg))
    return _fix_special_inits(params)


def init_leaf(spec, generator: torch.Generator, device,
              dtype=torch.float32) -> torch.Tensor:
    """One leaf of ``init_params``' rule (before the SSM special inits)."""
    shape = tuple(spec.shape)
    if len(shape) <= 1:
        return torch.zeros(shape, dtype=dtype, device=device)
    scale = min(0.02, (1.0 / shape[0]) ** 0.5)       # shape[0]: fan-in
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def _fix_special_inits(params: PyTree) -> PyTree:
    """SSM a_log / dt_bias need structured init for stability."""
    def fix(path, x):
        if "a_log" in path:
            n = x.shape[-1]
            base = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                          device=x.device))
            return base.expand(x.shape).contiguous()
        if "dt_bias" in path:
            return torch.full(x.shape, -2.0, dtype=x.dtype, device=x.device)
        if "d_skip" in path:
            return torch.ones(x.shape, dtype=x.dtype, device=x.device)
        return x
    return tree_map(fix, params, with_path=True)


# ---------------------------------------------------------------------------
# Cache shape construction (decode)
# ---------------------------------------------------------------------------


def _cache_shapes(cfg: ArchConfig, tag: str, batch: int, s_max: int,
                  dtype) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of one layer's decode cache."""
    base, var = parse_tag(tag)
    k, e = cfg.n_kv_heads, cfg.resolved_head_dim
    sh: Dict[str, Any] = {}
    if base in ("dense", "attn", "moe", "hybrid"):
        if var == "cross" and cfg.family == "vlm":
            ctx = cfg.context_seq
            sh["xk"] = ((batch, ctx, k, e), dtype)
            sh["xv"] = ((batch, ctx, k, e), dtype)
        else:
            cap = min(cfg.window, s_max) if var == "local" else s_max
            sh["k"] = ((batch, cap, k, e), dtype)
            sh["v"] = ((batch, cap, k, e), dtype)
            if var == "cross":   # audio self+cross
                sh["xk"] = ((batch, cfg.encoder_seq, k, e), dtype)
                sh["xv"] = ((batch, cfg.encoder_seq, k, e), dtype)
    if base == "hybrid":
        di = cfg.ssm.expand * cfg.d_model
        sh["ssm"] = ((batch, di, cfg.ssm.state_dim), torch.float32)
        sh["conv"] = ((batch, cfg.ssm.conv_width - 1, di), dtype)
    if base == "mlstm":
        h, dv = cfg.n_heads, cfg.resolved_head_dim
        dk = max(dv // 2, 8)
        sh["c"] = ((batch, h, dk, dv), torch.float32)
        sh["n"] = ((batch, h, dk), torch.float32)
        sh["m"] = ((batch, h), torch.float32)
    if base == "slstm":
        h = cfg.n_heads
        dh = cfg.d_model // cfg.n_heads
        for name in ("c", "n", "h", "m"):
            sh[name] = ((batch, h, dh), torch.float32)
    return sh


def cache_specs(cfg: ArchConfig, batch: int, s_max: int,
                dtype=torch.bfloat16) -> PyTree:
    """The decode-cache tree as ``meta`` tensors (shapes and dtypes)."""
    pattern, n_super, rem = cfg.pattern_plan()

    def meta(shapes, prefix=()):
        return {n: torch.empty(prefix + shape, dtype=dt, device="meta")
                for n, (shape, dt) in shapes.items()}
    out: Dict[str, Any] = {}
    if n_super:
        out["blocks"] = {
            f"pos{i}": meta(_cache_shapes(cfg, t, batch, s_max, dtype),
                            (n_super,))
            for i, t in enumerate(pattern)}
    if rem:
        out["rem"] = {
            f"rem{i}": meta(_cache_shapes(cfg, t, batch, s_max, dtype))
            for i, t in enumerate(rem)}
    return out


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device=None) -> PyTree:
    return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                          device=device),
                    cache_specs(cfg, batch, s_max, dtype))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _attn_params(p: Dict[str, torch.Tensor]) -> L.AttnParams:
    return L.AttnParams(wq=p["wq"], wk=p["wk"], wv=p["wv"],
                        wo=p.get("wo"), q_norm=p.get("q_norm"),
                        k_norm=p.get("k_norm"))


def _self_attention_seq(cfg: ArchConfig, p, x, *, causal, window,
                        softcap):
    """Self-attention over the whole sequence x (B, S, d): (attended
    (B, S, K, G, Dh), k, v (B, S, K, Dh))."""
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = L.project_qkv(x, _attn_params(p), cfg.n_kv_heads,
                            positions=positions, theta=cfg.rope_theta)
    att = L.blockwise_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    return att, k, v


def _self_attention_decode(cfg: ArchConfig, p, y, cache, new_cache, pos,
                           *, window, softcap) -> torch.Tensor:
    """One decode step's self-attention of y (B, 1, d) at ``pos``: its
    keys and values written into copies of the cached ring (``k``,
    ``v``, set in ``new_cache``), then attention over the ring."""
    cap = cache["k"].shape[1]
    positions = torch.tensor([pos], device=y.device)
    q, k_new, v_new = L.project_qkv(y, _attn_params(p), cfg.n_kv_heads,
                                    positions=positions,
                                    theta=cfg.rope_theta)
    k_c = L.ring_write(cache["k"], k_new, pos, cap)
    v_c = L.ring_write(cache["v"], v_new, pos, cap)
    new_cache["k"], new_cache["v"] = k_c, v_c
    kv_pos = L.ring_slot_positions(pos, cap, y.device)
    return L.decode_attention(q, k_c, v_c, kv_pos, pos, window=window,
                              softcap=softcap)


def _seat_kv(cfg: ArchConfig, var: str, s_max: int, k_all, v_all,
             new_cache) -> None:
    """A prefill's keys and values seated in their decode caches: a
    ring of ``min(window, s_max)`` slots on a local layer, else
    ``s_max``."""
    cap = min(cfg.window, s_max) if var == "local" else s_max
    new_cache["k"] = _seat_cache(k_all, cap)
    new_cache["v"] = _seat_cache(v_all, cap)


def _cross_attention_seq(cfg: ArchConfig, p, x: torch.Tensor,
                         ctx: torch.Tensor):
    """Attention of ``x`` (B, S, d) to the context ``ctx`` (B, C, d): q
    from x, keys and values from ctx, each product rounded once to x's
    dtype, no RoPE, no mask (``causal=False``).  Returns (attended
    (B, S, K, G, Dh), xk, xv (B, C, K, Dh))."""
    dt = x.dtype
    q = L._proj(x, p["wq"])
    b, s, h, e = q.shape
    q = q.reshape(b, s, cfg.n_kv_heads, h // cfg.n_kv_heads, e)
    c = ctx.to(dt)
    xk, xv = L._proj(c, p["wk"]), L._proj(c, p["wv"])
    att = L.blockwise_attention(q, xk, xv, causal=False)
    return att, xk, xv


def _cross_decode(cfg: ArchConfig, p, y: torch.Tensor, cache,
                  new_cache) -> torch.Tensor:
    """One decode step's cross attention of ``y`` (B, 1, d) to the cached
    context keys and values, which pass on unchanged (the same tensors,
    so the engine writes nothing back for them)."""
    b, s, _ = y.shape
    q = L._proj(y, p["wq"])
    q = q.reshape(b, s, cfg.n_kv_heads, cfg.q_group, -1)
    xk, xv = cache["xk"], cache["xv"]
    ctx_pos = torch.arange(xk.shape[1], device=y.device)
    new_cache["xk"], new_cache["xv"] = xk, xv
    return L.decode_attention(q, xk, xv, ctx_pos, 1 << 30)


def _seat_cache(k_all: torch.Tensor, cap_total: int) -> torch.Tensor:
    """Place the tail of prefill K/V (B, S, ...) into a fresh ring/linear
    cache of capacity cap_total, at the slots decode will expect
    (slot = abs_pos % cap_total)."""
    b, s = k_all.shape[:2]
    t = min(cap_total, s)
    slots = torch.arange(s - t, s, device=k_all.device) % cap_total
    out = k_all.new_zeros((b, cap_total) + tuple(k_all.shape[2:]))
    out[:, slots] = k_all[:, s - t:]
    return out


def _mamba_seq(cfg: ArchConfig, p, x: torch.Tensor,
               conv_tail: Optional[torch.Tensor], state0: torch.Tensor):
    """The mamba branch over a sequence x (B, S, d): (y (B, S, d_inner),
    the new conv tail, the final f32 state)."""
    n = cfg.ssm.state_dim
    dt_rank = max(1, cfg.d_model // 16)
    dt_ = x.dtype
    xs, z = torch.matmul(x, p["in_proj"].to(dt_)).chunk(2, dim=-1)
    xc, new_tail = S.depthwise_conv(xs, p["conv"], conv_tail)
    xc = F.silu(xc.float()).to(dt_)
    # f32 coefficients, as the reference's preferred_element_type leaves
    # them
    proj = L.f32_product(xc, p["x_proj"].to(dt_))
    dt_low, bmat, cmat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt_full = F.softplus(torch.matmul(dt_low, p["dt_w"].float())
                         + p["dt_bias"].float())
    y, state = S.ssm_scan(xc, dt_full.to(dt_), p["a_log"], bmat, cmat,
                          p["d_skip"], state0)
    return y * F.silu(z.float()).to(dt_), new_tail, state


def _mamba_step(cfg: ArchConfig, p, x_t: torch.Tensor,
                conv_tail: torch.Tensor, state: torch.Tensor):
    """One decode step of the mamba branch, x_t (B, 1, d): (y (B, 1,
    d_inner), the new conv tail, the new f32 state)."""
    n = cfg.ssm.state_dim
    dt_rank = max(1, cfg.d_model // 16)
    dt_ = x_t.dtype
    xs, z = torch.matmul(x_t, p["in_proj"].to(dt_)).chunk(2, dim=-1)
    full = torch.cat([conv_tail, xs], 1)               # (B, cw, di)
    xc = (full.float() * p["conv"].float().t()[None]).sum(1, keepdim=True)
    xc = F.silu(xc).to(dt_)
    proj = L.f32_product(xc, p["x_proj"].to(dt_))
    dt_low, bmat, cmat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt_full = F.softplus(torch.matmul(dt_low, p["dt_w"].float())
                         + p["dt_bias"].float())
    y, state = S.ssm_step(xc[:, 0], dt_full[:, 0].to(dt_), p["a_log"],
                          bmat[:, 0], cmat[:, 0], p["d_skip"], state)
    return y[:, None] * F.silu(z.float()).to(dt_), full[:, 1:], state


def _hybrid(cfg: ArchConfig, var: str, p: Dict[str, Any], x: torch.Tensor,
            mode: str, cache, pos, s_max: int
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """hymba's layer: attention and mamba heads on the same normed input,
    ``x + 0.5 * (rms(att) @ wo + rms(mamba) @ w_mamba_out)``, then the
    gated MLP.  Causal attention with no softcap (a ``local`` layer's
    window); the mamba branch starts from a zero state outside decode."""
    b, s, d = x.shape
    new_cache: Dict[str, torch.Tensor] = {}
    window = cfg.window if var == "local" else 0
    y = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    # the reference's hybrid attention takes no softcap
    if mode == "decode":
        att = _self_attention_decode(cfg, p["attn"], y, cache, new_cache,
                                     pos, window=window, softcap=0.0)
        m_out, new_cache["conv"], new_cache["ssm"] = _mamba_step(
            cfg, p["mamba"], y, cache["conv"], cache["ssm"])
    else:
        att, k_all, v_all = _self_attention_seq(
            cfg, p["attn"], y, causal=True, window=window, softcap=0.0)
        state0 = torch.zeros((b, cfg.ssm.expand * d, cfg.ssm.state_dim),
                             dtype=torch.float32, device=x.device)
        m_out, new_tail, new_state = _mamba_seq(cfg, p["mamba"], y, None,
                                                state0)
        if mode == "prefill":
            _seat_kv(cfg, var, s_max, k_all, v_all, new_cache)
            new_cache["conv"], new_cache["ssm"] = new_tail, new_state
    rms = L.rms_norm
    a_mix = torch.matmul(rms(att.reshape(b, s, -1), p["norm_attn"],
                             cfg.norm_eps), p["wo"].to(x.dtype))
    m_mix = torch.matmul(rms(m_out, p["norm_mamba"], cfg.norm_eps),
                         p["w_mamba_out"].to(x.dtype))
    x = x + 0.5 * (a_mix + m_mix)
    return _ffn(cfg, "hybrid", p, x), new_cache or None


def _mlstm_proj(cfg: ArchConfig, p, x: torch.Tensor):
    """The mLSTM projections of x (B, S, d): q, k, v (f32 products rounded
    to x's dtype), and f32 input and forget gate pre-activations (B, S,
    H) and output gate (B, S, H, Dv)."""
    b, s, d = x.shape
    dt = x.dtype
    q, k, v = (L._proj(x, p[n]) for n in ("wq", "wk", "wv"))
    gates = L.f32_product(x, p["w_if"].to(dt).reshape(d, -1)).reshape(
        b, s, 2, -1) + p["b_if"].float()
    og = L.f32_product(x, p["w_og"].to(dt).reshape(d, -1)).reshape(
        b, s, *p["w_og"].shape[1:])
    return q, k, v, gates[:, :, 0], gates[:, :, 1], og


def _mlstm(cfg: ArchConfig, p: Dict[str, Any], x: torch.Tensor, mode: str,
           cache) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The mLSTM layer: ``x + out_norm(mlstm(rms(x)) * sigmoid(og)) @
    wo``, no FFN."""
    b, s, _ = x.shape
    y = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v, i_pre, f_pre, og = _mlstm_proj(cfg, p, y)
    new_cache = None
    if mode == "decode":
        st = X.MLSTMState(cache["c"], cache["n"], cache["m"])
        yc, st2 = X.mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                               f_pre[:, 0], st)
        yc = yc[:, None]
        new_cache = {"c": st2.c, "n": st2.n, "m": st2.m}
    else:
        st = X.mlstm_init_state(b, cfg.n_heads, q.shape[-1], v.shape[-1],
                                x.device)
        chunk = cfg.xlstm.chunk if cfg.xlstm else 256
        yc, st2 = X.mlstm_chunkwise(q, k, v, i_pre, f_pre, st, chunk=chunk)
        if mode == "prefill":
            new_cache = {"c": st2.c, "n": st2.n, "m": st2.m}
    yc = yc * torch.sigmoid(og).to(yc.dtype)
    flat = L.rms_norm(yc.reshape(b, s, -1), p["out_norm"], cfg.norm_eps)
    out = L.f32_product(flat, p["wo"].to(x.dtype).reshape(flat.shape[-1],
                                                          -1))
    return x + out.to(x.dtype), new_cache


def _slstm(cfg: ArchConfig, p: Dict[str, Any], x: torch.Tensor, mode: str,
           cache) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The sLSTM layer: ``x + out_norm(slstm(rms(x))) @ wo``, then the
    gated MLP."""
    b, s, d = x.shape
    y = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    w_in = p["w_in"]
    pre = (L.f32_product(y, w_in.to(y.dtype).reshape(d, -1)).reshape(
        b, s, *w_in.shape[1:]) + p["b_in"].float()).to(y.dtype)
    new_cache = None
    if mode == "decode":
        st = X.SLSTMState(cache["c"], cache["n"], cache["h"], cache["m"])
        h_out, st2 = X.slstm_step(pre[:, 0], p["r"], st)
        h_out = h_out[:, None]
        new_cache = st2._asdict()
    else:
        st = X.slstm_init_state(b, cfg.n_heads, d // cfg.n_heads, x.device)
        h_out, st2 = X.slstm_scan(pre, p["r"], st)
        if mode == "prefill":
            new_cache = st2._asdict()
    flat = L.rms_norm(h_out.reshape(b, s, d).to(x.dtype), p["out_norm"],
                      cfg.norm_eps)
    x = x + torch.matmul(flat, p["wo"].to(x.dtype))
    return _ffn(cfg, "slstm", p, x), new_cache


DENSE_VARIANTS = ("full", "bidir", "local", "cross")
VARIANTS = {"dense": DENSE_VARIANTS, "attn": DENSE_VARIANTS,
            "moe": DENSE_VARIANTS, "hybrid": ("full", "local"),
            "mlstm": ("full",), "slstm": ("full",)}


def apply_layer(cfg: ArchConfig, tag: str, p: Dict[str, Any],
                x: torch.Tensor, *, mode: str,
                ctx: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                pos: Optional[int] = None,
                s_max: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Apply one layer (attention with a dense or an MoE FFN, hybrid,
    mLSTM or sLSTM) in ``train``, ``prefill`` or ``decode`` mode.
    Returns (x, new_cache), the cache None in train mode.  ``pos``
    (decode) is the position written; ``ctx`` (train, prefill) is a cross
    layer's context."""
    base, var = parse_tag(tag)
    if base not in VARIANTS:
        raise not_ported(f"layer base {base!r} ({tag})")
    if var not in VARIANTS[base]:
        raise not_ported(f"layer variant {var!r} ({tag})")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    s_max = s_max or x.shape[1]
    if base == "hybrid":
        return _hybrid(cfg, var, p, x, mode, cache, pos, s_max)
    if base == "mlstm":
        return _mlstm(cfg, p, x, mode, cache)
    if base == "slstm":
        return _slstm(cfg, p, x, mode, cache)
    new_cache: Dict[str, torch.Tensor] = {}
    window = cfg.window if var == "local" else 0
    y = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if var == "cross" and cfg.family == "vlm":
        # the image layer: gated cross attention in place of self-attention
        if mode == "decode":
            att = _cross_decode(cfg, p["xattn"], y, cache, new_cache)
        else:
            att, xk, xv = _cross_attention_seq(cfg, p["xattn"], y, ctx)
            if mode == "prefill":
                new_cache["xk"], new_cache["xv"] = xk, xv
        gate = torch.tanh(p["xgate"].float()).to(x.dtype)
        x = x + gate * L.attn_out(att, p["xattn"]["wo"])
        return _ffn(cfg, base, p, x), new_cache or None
    if mode == "decode":
        att = _self_attention_decode(cfg, p["attn"], y, cache, new_cache,
                                     pos, window=window,
                                     softcap=cfg.attn_softcap)
    else:
        att, k_all, v_all = _self_attention_seq(
            cfg, p["attn"], y, causal=var != "bidir", window=window,
            softcap=cfg.attn_softcap)
        if mode == "prefill":
            _seat_kv(cfg, var, s_max, k_all, v_all, new_cache)
    x = x + L.attn_out(att, p["attn"]["wo"])
    if var == "cross":
        # the audio decoder: causal self-attention, then cross attention
        # to the encoder's output
        y2 = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
        if mode == "decode":
            att2 = _cross_decode(cfg, p["xattn"], y2, cache, new_cache)
        else:
            att2, xk, xv = _cross_attention_seq(cfg, p["xattn"], y2, ctx)
            if mode == "prefill":
                new_cache["xk"], new_cache["xv"] = xk, xv
        x = x + L.attn_out(att2, p["xattn"]["wo"])
    return _ffn(cfg, base, p, x), new_cache or None


def _ffn(cfg: ArchConfig, base: str, p: Dict[str, Any],
         x: torch.Tensor) -> torch.Tensor:
    """The layer's FFN branch: ``x + ffn(rms_norm(x))``, dense or MoE."""
    y = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if base == "moe":
        mp = M.MoEParams(router=p["moe"]["router"],
                         w_gate=p["moe"]["w_gate"], w_up=p["moe"]["w_up"],
                         w_down=p["moe"]["w_down"],
                         s_gate=p["moe"].get("s_gate"),
                         s_up=p["moe"].get("s_up"),
                         s_down=p["moe"].get("s_down"))
        return x + M.moe_ffn(y, mp, cfg.moe, cfg.act)
    return x + L.gated_mlp(y, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                           p["mlp"]["w_down"], cfg.act)
