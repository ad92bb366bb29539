"""TrainState — the unit of persistence policy classification, the port
of ``repro.train.state``."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.core.arena import resolve_device

PyTree = Any


class TrainState(NamedTuple):
    """Field names align with repro_torch.core.policy.DEFAULT_RULES:
    params/step/data_seed are ESSENTIAL, mu/nu APPROXIMABLE, rng DERIVABLE.
    """
    params: PyTree
    mu: PyTree
    nu: PyTree
    step: torch.Tensor         # scalar int32
    data_seed: torch.Tensor    # scalar int32 (with step => pipeline cursor)
    rng: torch.Tensor          # DERIVABLE: (2,) uint32, PRNGKey(seed) fold_in step

    def as_dict(self) -> Dict[str, Any]:
        return self._asdict()


def new_state(params: PyTree, mu: PyTree, nu: PyTree, seed: int,
              device=None) -> TrainState:
    """A state at step 0 on ``device`` (None means the GPU); ``rng`` is
    JAX's ``PRNGKey(seed)``, the uint32 pair (0, seed)."""
    device = resolve_device(device)
    return TrainState(
        params=params, mu=mu, nu=nu,
        step=torch.zeros((), dtype=torch.int32, device=device),
        data_seed=torch.tensor(seed, dtype=torch.int32, device=device),
        rng=torch.tensor([0, seed], dtype=torch.uint32, device=device),
    )
