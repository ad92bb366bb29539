"""AdamW configuration and moment state, the port of the state part of
``repro.optim.adamw`` (decoupled weight decay, bias-corrected, eps
outside sqrt; the update step waits for the train slice).  Moments are
f32 by default; bf16 moments cannot be checkpointed by the port yet."""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.policy import tree_map

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"     # float32 | bfloat16
    max_grad_norm: float = 1.0


def init_moments(params: PyTree, cfg: AdamWConfig) -> Tuple[PyTree, PyTree]:
    """Zero first and second moments shaped as ``params``, on each
    parameter's device."""
    dt = _DTYPES[cfg.moment_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return tree_map(zeros, params), tree_map(zeros, params)
