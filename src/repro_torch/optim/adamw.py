"""Manual AdamW with a controllable moment dtype, the port of
``repro.optim.adamw``: decoupled weight decay, bias-corrected, eps
outside the sqrt, the global gradient norm clipped to ``max_grad_norm``.

The update keeps the reference's order of operations leaf by leaf (clip
scale, moments, bias correction, the step, the decay) in f32 and returns
new trees, as the reference's functional update does; it runs on the
parameters' device under ``no_grad``.  A leaf larger than
``UPDATE_CHUNK`` elements is updated a chunk of its elements at a time
into the new tensors: each element goes through the same operations, so
the bits are the same, and the step's temporaries stay a few chunks
instead of several copies of the largest leaf (gemma3-27b's tied
embedding is 1.41 B parameters, 5.6 GB a copy in f32).  Moments are f32
by default;
``moment_dtype="bfloat16"`` keeps them in bf16, and a checkpoint saves
them as the reference's files and restores them (``ckpt/manager.py``;
the reference itself cannot restore them, ROADMAP Queue 3)."""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.policy import tree_flatten_with_path, tree_map, \
    tree_unflatten

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
UPDATE_CHUNK = 1 << 24      # elements of a leaf updated at a time


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


def _leaves(tree):
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


@torch.no_grad()
def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's sum of
    squares in f32."""
    sums = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def update(params: PyTree, grads: PyTree, mu: PyTree, nu: PyTree,
           step, lr, cfg: AdamWConfig
           ) -> Tuple[PyTree, PyTree, PyTree, torch.Tensor]:
    """Returns (new_params, new_mu, new_nu, grad_norm).  ``step`` is the
    step being taken (0 first), ``lr`` its learning rate (a scalar or a
    0-d tensor)."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-12), max=1.0) \
        if cfg.max_grad_norm else 1.0
    t = torch.as_tensor(step).to(dev, torch.float32) + 1
    c1 = 1.0 - torch.pow(cfg.b1, t)
    c2 = 1.0 - torch.pow(cfg.b2, t)
    lr = torch.as_tensor(lr).to(dev, torch.float32)
    mdt = _DTYPES[cfg.moment_dtype]

    def part(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / c1
        vhat = v32 / c2
        upd = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.float()
        p_new = p32 - lr * (upd + cfg.weight_decay * p32)
        return p_new.to(p.dtype), m32.to(mdt), v32.to(mdt)

    def leaf(p, g, m, v):
        n = p.numel()
        if n <= UPDATE_CHUNK:
            return part(p, g, m, v)
        out = (torch.empty_like(p), torch.empty(p.shape, dtype=mdt,
                                                device=p.device),
               torch.empty(p.shape, dtype=mdt, device=p.device))
        ins = [t.reshape(-1) for t in (p, g, m, v)]
        flat = [t.view(-1) for t in out]
        for i in range(0, n, UPDATE_CHUNK):
            for dst, src in zip(flat, part(*(t[i:i + UPDATE_CHUNK]
                                             for t in ins))):
                dst[i:i + UPDATE_CHUNK] = src
        return out

    out = [leaf(*x) for x in zip(_leaves(params), _leaves(grads),
                                 _leaves(mu), _leaves(nu))]
    new_p, new_m, new_v = ([o[i] for o in out] for i in range(3))
    return (tree_unflatten(params, new_p), tree_unflatten(mu, new_m),
            tree_unflatten(nu, new_v), gnorm)
