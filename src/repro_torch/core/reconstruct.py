"""Reconstruction engine: registry of per-structure rebuild functions.

The port of ``repro.core.reconstruct``.  Every DERIVABLE piece of state
names a reconstructor that rebuilds it from essential state;
reconstructors must be pure given (essential state, static config).  The
three paper structures register "pstruct.dll", "pstruct.bptree" and
"pstruct.hashmap" (pstruct/*.py); ``RecoveryManager`` (core/recovery.py)
runs them by name through ``run``, which times each one.  The "rng"
reconstructor waits for the training slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import torch

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str) -> Callable[..., Any]:
    return _REGISTRY[name]


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _cuda_devices(args) -> set:
    """CUDA devices of the arenas the arguments carry (a structure's
    ``arena``)."""
    devs = set()
    for a in args:
        dev = getattr(getattr(a, "arena", None), "device", None)
        if isinstance(dev, torch.device) and dev.type == "cuda":
            devs.add(dev)
    return devs


def run(name: str, *args, **kw):
    """Run a reconstructor, returning (result, seconds).  When the target's
    arena lives on a CUDA device, that device is synchronised before each
    clock read, so the seconds are the card's work, not the time to
    enqueue it."""
    devs = _cuda_devices(args)
    for d in devs:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = _REGISTRY[name](*args, **kw)
    for d in devs:
        torch.cuda.synchronize(d)
    return out, time.perf_counter() - t0


@register("schedule")
def rebuild_schedule(step: int, schedule_fn):
    # LR schedules are pure functions of step; their "state" is just memo
    return schedule_fn(step)


@register("pipeline_cursor")
def rebuild_pipeline_cursor(seed: int, step: int, global_batch: int):
    # deterministic pipeline: cursor is a pure function of (seed, step)
    return {"seed": seed, "next_index": step * global_batch}
