"""Trainer: the host loop tying pipeline, train_step, and checkpoints, the
port of ``repro.train.trainer``.

Fault-tolerance contract:
* checkpoint every `ckpt_every` steps through the configured policy
  (fully / partly / partly+q8 / partly+drop), async by default, through
  the port's ``CheckpointManager``;
* `crash()` drops ALL volatile state (python refs + device buffers);
* `resume()` restores from the latest valid checkpoint, reconstructs
  DERIVABLE state (pipeline cursor from (seed, step), rng), and continues —
  with the partly policy + persisted moments the continued loss trajectory
  is bit-identical to an uninterrupted run on the same device.
Straggler posture: per-step deadline watchdog — a step exceeding
`deadline_s` raises ``TimeoutError`` so the launcher respawns from the last
checkpoint (see launch/train.py).

The trainer runs on the GPU unless given ``device="cpu"``; parameters
start from the port's own init (``init_params`` drawing from a
``torch.Generator`` seeded with ``cfg.seed`` on that device), which is not
JAX's: a comparison with the reference sets ``state`` from converted
parameters instead of calling ``init``.  Restoring onto a mesh
(``shardings=``) is not ported.  On the card, bit-identical resumes also
need deterministic torch kernels (``torch.use_deterministic_algorithms``
and ``CUBLAS_WORKSPACE_CONFIG``), which the entry points set.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core import policy as pol
from repro_torch.core.arena import not_ported, resolve_device
from repro_torch.data.pipeline import Pipeline
from repro_torch.models.model import Model
from repro_torch.optim.adamw import _DTYPES, AdamWConfig, init_moments
from repro_torch.optim.schedule import WarmupCosine
from repro_torch.train.state import TrainState, new_state
from repro_torch.train.step import build_train_step

PyTree = Any


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "/tmp/repro_ckpt"
    policy: pol.PersistPolicy = pol.PARTLY_PERSISTENT
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 64
    microbatches: int = 1
    async_ckpt: bool = True
    deadline_s: float = 0.0      # 0 = watchdog off


class Trainer:
    def __init__(self, model: Model, opt: AdamWConfig, cfg: TrainerConfig,
                 shardings: Optional[PyTree] = None, device=None):
        if shardings is not None:
            raise not_ported("a trainer on a mesh (shardings=)")
        self.model = model
        self.opt = opt
        self.cfg = cfg
        self.device = resolve_device(device)
        self.schedule = WarmupCosine(total_steps=max(cfg.steps, 10))
        self.pipeline = Pipeline(model.cfg, cfg.global_batch, cfg.seq_len,
                                 seed=cfg.seed)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, cfg.policy)
        self._step_fn = build_train_step(model, opt, self.schedule,
                                         cfg.microbatches)
        self.state: Optional[TrainState] = None
        self.metrics_log: list = []
        self.shardings = shardings

    # ------------------------------------------------------------------
    def init(self) -> None:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.cfg.seed)
        params = self.model.init_params(g, self.device)
        mu, nu = init_moments(params, self.opt)
        self.state = new_state(params, mu, nu, self.cfg.seed, self.device)

    def state_spec(self) -> TrainState:
        """The state's structure, shapes and dtypes as ``meta`` tensors."""
        params = self.model.param_specs()
        mdt = _DTYPES[self.opt.moment_dtype]
        mu = pol.tree_map(lambda s: torch.empty(s.shape, dtype=mdt,
                                                device="meta"), params)

        def scalar(dtype, shape=()):
            return torch.empty(shape, dtype=dtype, device="meta")
        return TrainState(
            params=params, mu=mu, nu=mu,
            step=scalar(torch.int32), data_seed=scalar(torch.int32),
            rng=scalar(torch.uint32, (2,)))

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict[str, float]:
        assert self.state is not None, "call init() or resume() first"
        steps = steps if steps is not None else self.cfg.steps
        start = int(self.state.step)
        for s in range(start, start + steps):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch_at(s).items()}
            t0 = time.perf_counter()
            self.state, metrics = self._step_fn(self.state, batch)
            # float() waits for the card, so the step's time is its work
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            if self.cfg.deadline_s and dt > self.cfg.deadline_s:
                raise TimeoutError(
                    f"step {s} exceeded deadline ({dt:.1f}s) — respawn "
                    f"from checkpoint")
            metrics["step"] = s
            metrics["sec"] = dt
            self.metrics_log.append(metrics)
            if self.cfg.ckpt_every and (s + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(self.state,
                               blocking=not self.cfg.async_ckpt)
        self.ckpt.wait()
        return self.metrics_log[-1] if self.metrics_log else {}

    # ------------------------------------------------------------------
    def crash(self) -> None:
        """Drop all volatile state (simulated preemption)."""
        self.ckpt.wait()
        self.state = None
        self.pipeline.step = -1
        self.pipeline.seed = -1

    def resume(self) -> int:
        """Restore from latest checkpoint; reconstruct DERIVABLE state."""
        assert self.ckpt.valid(), "no valid checkpoint to resume from"
        self.state = self.ckpt.restore(self.state_spec(),
                                       device=self.device)
        step = int(self.state.step)
        seed = int(self.state.data_seed)
        # DERIVABLE reconstruction: pipeline cursor from essential scalars
        self.pipeline.reconstruct_cursor(seed, step)
        return step
