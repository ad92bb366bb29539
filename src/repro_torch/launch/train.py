"""Training launcher, the port of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--reduced|--full-size] [--policy partly] [--crash-at-step N] [--device cpu]

Runs the Trainer end to end on one device with the configured persistence
policy, crash-sim hooks, and respawn-from-checkpoint — the single-host
harness for the fault-tolerance contract.  It runs on the card unless
``--device`` names another device, computing in bf16 there and in f32 on
the CPU, as the reference does on its accelerator and on the CPU.
Parameters come from the port's seeded init, not the reference's JAX
init.  Every registered arch runs: dense attention, MoE, the context
archs (llama-3.2-vision-90b, whisper-large-v3: the pipeline draws each
step's context or frames), hymba-1.5b's hybrid layers and xlstm-1.3b's
mLSTM and sLSTM layers.

Fault-tolerance loop: the trainer runs in incarnations.  When the process
is told to crash (``--crash-at-step``), the incarnation ends and the next
one restores from the latest valid checkpoint and continues.  A crash
before the first checkpoint respawns from step 0, rebuilding everything
from the seed (the reference asserts there).  Checkpoints go to a
temporary directory unless ``--ckpt-dir`` names one.

On a card the launcher makes torch's kernels deterministic
(``torch.use_deterministic_algorithms``, with ``CUBLAS_WORKSPACE_CONFIG``
set before the first product), so a resumed run repeats an uninterrupted
one's bits.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.configs import base, registry
from repro_torch.core import policy as pol
from repro_torch.core.arena import resolve_device
from repro_torch.models.model import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

POLICIES = {
    "full": pol.FULLY_PERSISTENT,
    "partly": pol.PARTLY_PERSISTENT,
    "partly-q8": pol.PARTLY_Q8,
    "partly-drop": pol.PARTLY_DROP,
}


def deterministic(device: torch.device) -> None:
    """Make torch's kernels on ``device`` repeat their bits from run to
    run: on a card, cuBLAS with a fixed workspace and no
    nondeterministic algorithm."""
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced same-family config")
    ap.add_argument("--full-size", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--policy", default="partly", choices=list(POLICIES))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline-s", type=float, default=0.0)
    ap.add_argument("--crash-at-step", type=int, default=-1,
                    help="inject a crash after this step (fault-tolerance "
                         "demo); the launcher respawns from checkpoint")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    deterministic(device)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = base.reduced(cfg)
    model = build(cfg, compute_dtype=torch.float32
                  if device.type == "cpu" else torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as td:
        tc = TrainerConfig(
            steps=args.steps, ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir or td, policy=POLICIES[args.policy],
            seed=args.seed, global_batch=args.global_batch,
            seq_len=args.seq_len, microbatches=args.microbatches,
            deadline_s=args.deadline_s)
        trainer = Trainer(model, AdamWConfig(), tc, device=device)

        if args.resume and trainer.ckpt.valid():
            step = trainer.resume()
            print(f"[train] resumed incarnation at step {step}")
        else:
            trainer.init()
            print(f"[train] fresh start: {cfg.name} ({args.policy} "
                  f"persistence) on {device}")

        start = int(trainer.state.step)
        end = args.steps
        while start < end:
            run_until = min(end, args.crash_at_step) \
                if start <= args.crash_at_step < end else end
            trainer.run(run_until - start)
            start = int(trainer.state.step)
            if start == args.crash_at_step:
                print(f"[train] CRASH injected at step {start}; "
                      f"respawning...")
                trainer.crash()
                if trainer.ckpt.valid():
                    resumed = trainer.resume()
                    print(f"[train] incarnation 2 restored at step "
                          f"{resumed} (reconstructed pipeline cursor + rng)")
                else:
                    trainer.init()
                    trainer.pipeline.reconstruct_cursor(args.seed, 0)
                    resumed = 0
                    print("[train] incarnation 2: no checkpoint yet, "
                          "respawned from the seed at step 0")
                start = resumed
                args.crash_at_step = -1

        last = trainer.metrics_log[-1]
        rep = trainer.ckpt.last_report
        print(json.dumps({
            "final_step": last["step"], "final_loss": round(last["loss"], 4),
            "device": str(device),
            "ckpt_bytes_written": rep.bytes_written if rep else 0,
            "ckpt_bytes_skipped_derivable":
                rep.bytes_skipped_derivable if rep else 0,
        }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
