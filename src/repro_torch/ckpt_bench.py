"""Checkpoint policy benchmark on the port, the counterpart of
``benchmarks/ckpt_bench.py``.

Applies the policy spectrum to a real TrainState — fully / partly /
partly+q8 / partly+drop / partly+incremental — and reports the bytes
persisted per checkpoint and the save wall time (``ckpt_policies``), and
the restore time per policy (``restore_reconstruct``).  The byte columns
(``bytes_1st``, ``bytes_2nd``, ``skipped_derivable``) depend on shapes
only, so they equal the reference's numbers; the seconds are this
device's.  It runs on the GPU; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python -m repro_torch.ckpt_bench [--device cpu] [--layers N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile
import time
from typing import Dict, List

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import base, registry
from repro_torch.core import policy as pol
from repro_torch.core.arena import resolve_device
from repro_torch.models.backbone import init_params
from repro_torch.optim.adamw import AdamWConfig, init_moments
from repro_torch.train.state import TrainState, new_state

POLICIES = [
    ("fully", pol.FULLY_PERSISTENT, False),
    ("partly", pol.PARTLY_PERSISTENT, False),
    ("partly+q8", pol.PARTLY_Q8, False),
    ("partly+drop", pol.PARTLY_DROP, False),
    ("partly+incr", pol.PARTLY_PERSISTENT, True),
]


def _state(cfg, device, moments_offset: float = 0.0) -> TrainState:
    g = torch.Generator(device=device)
    g.manual_seed(0)
    params = init_params(cfg, g, device)
    mu, nu = init_moments(params, AdamWConfig())
    mu = pol.tree_map(lambda x: x + moments_offset, mu)
    return new_state(params, mu, nu, seed=0, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ckpt_policies(arch: str = "llama3.2-3b", device=None,
                  layers: int = 4) -> List[Dict]:
    device = resolve_device(device)
    cfg = base.reduced(registry.get(arch))
    # widen the reduced config so checkpoint sizes are meaningful (~40MB)
    cfg = dataclasses.replace(cfg, d_model=512, n_layers=layers, d_ff=1024,
                              vocab=8192)
    st = _state(cfg, device, moments_offset=0.01)   # non-trivial moments
    rows = []
    for name, policy, incr in POLICIES:
        d = tempfile.mkdtemp(prefix=f"ckpt_{name.replace('+', '_')}_")
        try:
            mgr = CheckpointManager(d, policy, incremental=incr)
            t0 = time.perf_counter()
            rep = mgr.save(st)
            t_first = time.perf_counter() - t0
            # second save (params unchanged): the incremental win
            t0 = time.perf_counter()
            rep2 = mgr.save(st)
            t_second = time.perf_counter() - t0
            rows.append({
                "policy": name,
                "bytes_1st": rep.bytes_written,
                "bytes_2nd": rep2.bytes_written,
                "skipped_derivable": rep.bytes_skipped_derivable,
                "save_s_1st": round(t_first, 4),
                "save_s_2nd": round(t_second, 4),
            })
        finally:
            shutil.rmtree(d, ignore_errors=True)
    base_b = rows[0]["bytes_1st"]
    for r in rows:
        r["vs_fully"] = f"{(1 - r['bytes_1st'] / base_b) * 100:.1f}% fewer"
    return rows


def restore_reconstruct(arch: str = "llama3.2-3b", device=None) -> List[Dict]:
    """Restore-time split: read-persisted vs reconstruct-derivable."""
    device = resolve_device(device)
    cfg = base.reduced(registry.get(arch))
    st = _state(cfg, device)
    rows = []
    for name, policy, _ in POLICIES[:3]:
        d = tempfile.mkdtemp(prefix="ckpt_r_")
        try:
            mgr = CheckpointManager(d, policy)
            mgr.save(st)
            t0 = time.perf_counter()
            got = mgr.restore(st, device=device)
            _sync(device)
            rows.append({"policy": name,
                         "restore_s": round(time.perf_counter() - t0, 4),
                         "leaves": len(pol.tree_flatten_with_path(got))})
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    p.add_argument("--layers", type=int, default=4,
                   help="layers of the widened config of ckpt_policies")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps({"device": str(device),
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu")}))
    for row in ckpt_policies(device=device, layers=args.layers):
        print(json.dumps({"table": "ckpt_policies", **row}))
    for row in restore_reconstruct(device=device):
        print(json.dumps({"table": "restore_reconstruct", **row}))


if __name__ == "__main__":
    main()
