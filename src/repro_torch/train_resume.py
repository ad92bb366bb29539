"""Training with partly-persistent checkpoints, a crash and a resume, held
against an uninterrupted twin: the port of ``examples/train_resume.py``.

Trains a ~100M-parameter llama3.2-3b-family model (6 layers, d_model 768,
12 heads over 4 KV heads of width 64, d_ff 2048, vocab 32000) in f32,
checkpointing every 40 steps through the PARTLY policy (params and Adam
moments persist; the rng, schedule and pipeline cursor are rebuilt from
(seed, step)), crashes after ``--crash-at`` steps, resumes from the
latest checkpoint and runs to ``--steps``; then an uninterrupted twin runs
the same steps.  Every loss the resumed run computed, and its final
parameters, must equal the twin's bit for bit; it prints ``delta=`` (the
final losses' difference, 0 when the resume is exact) and exits non-zero
otherwise.  ``--crash-at`` must lie above a multiple of 40 and below
``--steps``.  The reference's example asserts its final losses within
1e-4; the port asserts them equal.

It runs on the card unless ``--device`` names another device; on a card
it makes torch's kernels deterministic first (``launch.train``).  Both
runs start from the port's seeded init:

    PYTHONPATH=src python -m repro_torch.train_resume [--device cpu] [--steps 200] [--crash-at 120] [--global-batch 8] [--seq-len 128]
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
import time
from typing import Dict, List

import torch

from repro_torch.configs import registry
from repro_torch.core import policy as pol
from repro_torch.core.arena import resolve_device
from repro_torch.launch.train import deterministic
from repro_torch.models.model import Model, build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def small_llama():
    """~100M-param llama3-family config (the reference example's)."""
    return dataclasses.replace(
        registry.get("llama3.2-3b"),
        n_layers=6, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=32000)


def _losses(log: List[dict]) -> Dict[int, float]:
    return {m["step"]: m["loss"] for m in log}


def twin_run(model: Model, tc: TrainerConfig, crash_at: int, device,
             opt: AdamWConfig = AdamWConfig()) -> dict:
    """Train ``tc.steps`` steps with a crash after ``crash_at`` and a
    resume (checkpoints in ``tc.ckpt_dir``), then an uninterrupted twin
    (``ckpt_every=0``, its own directory).  Returns both runs' losses by
    step (the crashed run's first and second incarnations apart), both
    final parameter trees, the step the resume restored, every save's
    report, the restore's seconds and report, and each step's seconds."""
    tr = Trainer(model, opt, tc, device=device)
    saves = []
    save = tr.ckpt.save

    def save_and_note(state, blocking=True):
        rep = save(state, blocking=blocking)
        saves.append(rep)
        return rep
    tr.ckpt.save = save_and_note
    tr.init()
    tr.run(crash_at)
    first = _losses(tr.metrics_log)
    tr.crash()
    t0 = time.perf_counter()
    resumed = tr.resume()
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    restore_s = time.perf_counter() - t0
    n_before = len(tr.metrics_log)
    tr.run(tc.steps - resumed)
    second = _losses(tr.metrics_log[n_before:])
    out = {"first": first, "second": second, "resumed_at": resumed,
           "saves": saves, "restore_s": restore_s,
           "restore": tr.ckpt.last_recovery,
           "crashed_step_s": [m["sec"] for m in tr.metrics_log],
           "params": tr.state.params}
    del tr
    ref = Trainer(model, opt, dataclasses.replace(
        tc, ckpt_every=0, ckpt_dir=tc.ckpt_dir + "_ref"), device=device)
    ref.init()
    ref.run(tc.steps)
    out.update(twin=_losses(ref.metrics_log),
               twin_step_s=[m["sec"] for m in ref.metrics_log],
               twin_params=ref.state.params, twin_trainer=ref)
    return out


def mismatches(out: dict) -> List[str]:
    """Where the crashed run's losses or final parameters differ from the
    twin's, bit for bit (empty when the resume is exact)."""
    bad = [f"loss at step {s}" for inc in ("first", "second")
           for s, loss in out[inc].items() if loss != out["twin"][s]]
    mine = pol.tree_flatten_with_path(out["params"])
    theirs = dict(pol.tree_flatten_with_path(out["twin_params"]))
    bad += [pol.path_str(p) for p, t in mine if not torch.equal(t, theirs[p])]
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--crash-at", type=int, default=120)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    deterministic(device)

    cfg = small_llama()
    model = build(cfg, compute_dtype=torch.float32)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params, {args.steps} "
          f"steps @ batch {args.global_batch} x seq {args.seq_len} on "
          f"{device}")
    d = tempfile.mkdtemp(prefix="repro_torch_resume_")
    try:
        tc = TrainerConfig(
            steps=args.steps, ckpt_every=40, ckpt_dir=d,
            policy=pol.PARTLY_PERSISTENT, global_batch=args.global_batch,
            seq_len=args.seq_len, async_ckpt=True)
        out = twin_run(model, tc, args.crash_at, device)
        rep = out["saves"][-1] if out["saves"] else None
        print(f"[inc 1] step {args.crash_at - 1} "
              f"loss={out['first'][args.crash_at - 1]:.4f}; CRASH")
        print(f"[inc 2] restored step {out['resumed_at']} in "
              f"{out['restore_s']:.3f}s; the last checkpoint wrote "
              f"{(rep.bytes_written if rep else 0) / 2**20:.1f} MiB, "
              f"skipped {rep.bytes_skipped_derivable if rep else 0} B of "
              f"derivable state")
        crashed = out["second"][args.steps - 1]
        ref = out["twin"][args.steps - 1]
        print(f"\nfinal loss  crashed-run={crashed:.6f}  "
              f"uninterrupted={ref:.6f}  delta={abs(crashed - ref):.2e}")
        bad = mismatches(out)
        if bad:
            print(f"trajectories diverged: {bad[:8]}")
            return 1
        print("bit-consistent resume verified: every loss and the final "
              "parameters equal the uninterrupted run's.")
    finally:
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(d + "_ref", ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
