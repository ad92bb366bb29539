"""Backbone parameter shapes and initialisation, the port of the
parameter-shape part of ``repro.models.backbone``.

The stack is ``n_super`` repetitions of the config's ``layer_pattern``
("superblock") plus an unrolled remainder.  Superblock parameters are
stacked on a leading axis, so ``param_specs`` has the reference's tree:
``embed``, ``final_norm``, ``blocks/pos<i>/...`` (leading dim n_super),
``rem/rem<i>/...``, ``lm_head`` when embeddings are untied, and the
encoder's ``enc_blocks``/``enc_final_norm``.  The forward pass waits for
the model slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import tree_map

PyTree = Any


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
                device=None) -> PyTree:
    """Materialize real parameters with the reference's scale rule: 0-d
    and 1-d leaves (norms, biases, gates) start at zero, the others are
    ``min(0.02, fan_in**-0.5) * N(0, 1)``; then the SSM special inits.
    Leaves draw from ``generator`` (on ``device``; None means the
    generator's) in flatten order.  Torch's draws are not JAX's: only
    shapes and the init rule are held against the reference."""
    device = generator.device if device is None else torch.device(device)

    def init(spec):
        shape = tuple(spec.shape)
        if len(shape) <= 1:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        fan_in = shape[0]
        scale = min(0.02, (1.0 / fan_in) ** 0.5)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale)

    params = tree_map(init, param_specs(cfg))
    return _fix_special_inits(params)


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
