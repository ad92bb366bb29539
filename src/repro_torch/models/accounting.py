"""Analytical parameter / useful-FLOP accounting, the port of
``repro.models.accounting`` (it needs only the parameter shapes).

* ``param_count`` is exact: it sums the leaves of the implemented
  parameter tree (padding, gates, norms included).
* ``MODEL_FLOPS = 6 * N * D`` for training and ``2 * N * D`` for
  inference, where N excludes the input embedding table (a gather) but
  includes the LM head matmul once, tied or not, and for MoE counts only
  the active expert parameters (top_k / n_experts of routed weights).
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import tree_flatten_with_path


def _leaf_size(spec) -> int:
    return math.prod(spec.shape)


def param_count(cfg: ArchConfig) -> int:
    from repro_torch.models import backbone as B

    return sum(_leaf_size(s) for _, s in
               tree_flatten_with_path(B.param_specs(cfg)))


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: routed experts scaled by k/E)."""
    from repro_torch.models import backbone as B

    total = 0
    for keys, spec in tree_flatten_with_path(B.param_specs(cfg)):
        size = _leaf_size(spec)
        if cfg.moe is not None and any(k in ("w_gate", "w_up", "w_down")
                                       for k in keys) and "moe" in keys:
            size = int(size * cfg.moe.top_k / cfg.moe.n_experts)
        total += size
    return total


def matmul_param_count(cfg: ArchConfig, active: bool = True) -> int:
    """N for the 6ND formula: active params, minus the embedding gather,
    plus the head matmul if embeddings are tied (untied lm_head is already
    a parameter leaf)."""
    n = active_param_count(cfg) if active else param_count(cfg)
    n -= cfg.vocab_padded * cfg.d_model          # embedding gather
    if cfg.tie_embeddings:
        n += cfg.vocab_padded * cfg.d_model      # tied head matmul
    return n


def model_flops_per_token(cfg: ArchConfig, seq_len: int, training: bool) -> float:
    n = matmul_param_count(cfg, active=True)
    return (6.0 if training else 2.0) * n


def model_flops(cfg: ArchConfig, n_tokens: int, training: bool) -> float:
    return model_flops_per_token(cfg, 0, training) * n_tokens
