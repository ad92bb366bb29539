"""Serving launcher, the port of ``repro.launch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch <id> [--crash] [--device cpu]

Boots a ``ServingEngine`` (paged-KV DLL allocator and request hashmap,
both partly persistent) on the reduced config of ``--arch``, serves
batched greedy decode for synthetic requests, and with ``--crash`` drops
all device and volatile host state halfway and recovers it from the
persistent arenas (the token log re-prefills every live request).  It runs
on the card unless ``--device`` names another device.  Parameters come
from a seeded ``torch.Generator``, not the reference's JAX init; the
launcher compares nothing.  Every registered arch runs: dense attention,
MoE, the context archs (llama-3.2-vision-90b, whisper-large-v3: the
engine serves them with a context of zeros, as the reference's does),
hymba-1.5b's hybrid layers and xlstm-1.3b's mLSTM and sLSTM layers.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import base, registry
from repro_torch.core.arena import resolve_device
from repro_torch.models.model import build
from repro_torch.serve.engine import EngineConfig, ServingEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--arena", default=None,
                    help="engine arena file (default: a temporary "
                         "directory's)")
    ap.add_argument("--crash", action="store_true",
                    help="crash mid-serve and recover")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = base.reduced(registry.get(args.arch))
    model = build(cfg, compute_dtype=torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init_params(gen, device)
    with tempfile.TemporaryDirectory() as td:
        eng = ServingEngine(model, params,
                            EngineConfig(max_batch=args.requests,
                                         s_max=args.s_max,
                                         max_requests=4 * args.requests),
                            arena_path=args.arena or os.path.join(td, "eng"),
                            device=device)
        rng = np.random.default_rng(0)
        for rid in range(args.requests):
            prompt = rng.integers(1, cfg.vocab, rng.integers(3, 9))
            eng.add_request(100 + rid, prompt.astype(np.int64))
            print(f"[serve] request {100 + rid}: prompt={prompt.tolist()}")
        for step in range(args.steps // 2):
            print(f"[serve] step {step}: {eng.step()}")
        if args.crash:
            print("[serve] CRASH — dropping device caches + volatile tables")
            eng.crash()
            t = eng.recover()
            print(f"[serve] recovered in {t:.3f}s (hashmap reconstructed, "
                  f"LRU chain rebuilt, KV re-prefilled from token log)")
        for step in range(args.steps // 2, args.steps):
            print(f"[serve] step {step}: {eng.step()}")
        print(f"[serve] flush stats: {eng.arena.stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
