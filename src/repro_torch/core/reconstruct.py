"""Reconstruction engine: registry of per-structure rebuild functions.

The port of ``repro.core.reconstruct``.  Every DERIVABLE piece of state
names a reconstructor that rebuilds it from essential state;
reconstructors must be pure given (essential state, static config).  The
three paper structures register "pstruct.dll", "pstruct.bptree" and
"pstruct.hashmap" (pstruct/*.py); ``RecoveryManager`` (core/recovery.py)
runs them by name through ``run``, which times each one.  The "rng"
reconstructor rebuilds a train state's key as JAX's
``fold_in(PRNGKey(seed), step)``, bit for bit (threefry-2x32 in numpy).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import numpy as np
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


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """One threefry-2x32 block (20 rounds) of the count (x0, x1) under the
    key (k0, k1), all numpy uint32: the function behind JAX's
    ``threefry_2x32``."""
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):        # uint32 sums wrap, as intended
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x1 ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _u32(v: int) -> np.uint32:
    return np.uint32(int(v) & 0xFFFFFFFF)


@register("rng")
def rebuild_rng(seed: int, step: int) -> torch.Tensor:
    """``fold_in(PRNGKey(seed), step)`` as a (2,) torch.uint32 tensor on
    the CPU.  ``PRNGKey(seed)`` is the pair (0, seed) and ``fold_in``
    one threefry block of the count (0, step) under that key."""
    k = _threefry2x32(np.uint32(0), _u32(seed), np.uint32(0), _u32(step))
    return torch.from_numpy(np.array(k, dtype=np.uint32))


@register("schedule")
def rebuild_schedule(step: int, schedule_fn):
    # LR schedules are pure functions of step; their "state" is just memo
    return schedule_fn(step)


@register("pipeline_cursor")
def rebuild_pipeline_cursor(seed: int, step: int, global_batch: int):
    # deterministic pipeline: cursor is a pure function of (seed, step)
    return {"seed": seed, "next_index": step * global_batch}
