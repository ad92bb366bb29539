"""train_step builder, the port of ``repro.train.step``: loss -> grads ->
AdamW, with optional microbatch gradient accumulation.

The reference lowers this into one jit'd program (a ``lax.scan`` over
microbatches); here it is eager PyTorch: a Python loop over microbatches,
``torch.autograd.grad`` of ``Model.loss`` with respect to the parameter
leaves, then ``optim.adamw.update``.  The order of the sums is the
reference's: per-microbatch losses and gradients are summed in f32 in
microbatch order, then divided by the count.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.arena import not_ported
from repro_torch.core.policy import (tree_flatten_with_path, tree_map,
                                     tree_unflatten)
from repro_torch.core.reconstruct import rebuild_rng
from repro_torch.models.model import Model
from repro_torch.optim.adamw import _DTYPES, AdamWConfig, update
from repro_torch.train.state import TrainState

PyTree = Any


def build_train_step(model: Model, opt: AdamWConfig,
                     schedule: Callable[[Any], Any],
                     microbatches: int = 1,
                     grad_sync_dtype: Optional[str] = None,
                     param_shardings: Optional[PyTree] = None):
    """Returns train_step(state, batch) -> (state, metrics), ``batch`` a
    dict of tensors on the parameters' device, ``metrics`` 0-d tensors
    ``loss``, ``lr`` and ``grad_norm``.

    grad_sync_dtype: "float32" or "bfloat16", the dtype each microbatch's
    gradients are rounded through before they are summed (the reference casts them so before its
    cross-replica reduction; one process here, so only the rounding
    remains); the sum stays f32.  None keeps f32.

    param_shardings: the reference's FSDP cast; not ported (it waits for
    distribution)."""
    if param_shardings is not None:
        raise not_ported("train-step parameter shardings (param_shardings=)")
    sync_dt = _DTYPES[grad_sync_dtype] if grad_sync_dtype else None

    def value_and_grad(params: PyTree, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, PyTree]:
        leaves = [leaf.detach().requires_grad_()
                  for _, leaf in tree_flatten_with_path(params)]
        with torch.enable_grad():
            loss = model.loss(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, list(grads))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if microbatches > 1:
            def split(x, i):
                b = x.shape[0]
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])[i]
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            for i in range(microbatches):
                l, g = value_and_grad(
                    state.params, {k: split(v, i) for k, v in batch.items()})
                if sync_dt is not None:
                    g = tree_map(lambda x: x.to(sync_dt), g)
                loss = loss + l
                grads = _add_trees(grads, g)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        else:
            loss, grads = value_and_grad(state.params, batch)
            if sync_dt is not None:
                grads = tree_map(lambda x: x.to(sync_dt).to(torch.float32),
                                 grads)

        step = int(state.step)
        lr = schedule(step)
        new_p, new_m, new_v, gnorm = update(
            state.params, grads, state.mu, state.nu, step, lr, opt)
        seed = int(state.data_seed)
        new_state = TrainState(
            params=new_p, mu=new_m, nu=new_v,
            step=state.step + 1,
            data_seed=state.data_seed,
            # DERIVABLE by construction: PRNGKey(data_seed) folded with
            # step (core.reconstruct.rebuild_rng, the reference's bits)
            rng=rebuild_rng(seed, step + 1).to(state.rng.device),
        )
        metrics = {"loss": loss, "lr": torch.as_tensor(lr),
                   "grad_norm": gnorm}
        return new_state, metrics

    return train_step


def _add_trees(acc: PyTree, g: PyTree) -> PyTree:
    """acc + g leaf by leaf, g promoted to acc's dtype."""
    gl = [leaf for _, leaf in tree_flatten_with_path(g)]
    al = [leaf for _, leaf in tree_flatten_with_path(acc)]
    return tree_unflatten(acc, [a + b.to(a.dtype) for a, b in zip(al, gl)])
