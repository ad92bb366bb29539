"""Reconstruction engine: registry of per-structure rebuild functions.

The port of ``repro.core.reconstruct``.  Every DERIVABLE piece of state
names a reconstructor that rebuilds it from essential state;
reconstructors must be pure given (essential state, static config).  The
three paper structures register "pstruct.dll", "pstruct.bptree" and
"pstruct.hashmap" (pstruct/*.py).  The "rng" reconstructor waits for the
training slice (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str) -> Callable[..., Any]:
    return _REGISTRY[name]


@register("schedule")
def rebuild_schedule(step: int, schedule_fn):
    # LR schedules are pure functions of step; their "state" is just memo
    return schedule_fn(step)


@register("pipeline_cursor")
def rebuild_pipeline_cursor(seed: int, step: int, global_batch: int):
    # deterministic pipeline: cursor is a pure function of (seed, step)
    return {"seed": seed, "next_index": step * global_batch}
