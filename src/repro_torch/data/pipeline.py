"""Deterministic synthetic token pipeline with a derivable cursor, the
port of ``repro.data.pipeline`` (numpy only; a copy, so the port imports
nothing of the reference).

The pipeline is a pure function of (seed, global step): batch i consists of
sample indices [i*GB, (i+1)*GB) permuted by a seeded hash.  After a crash
the cursor is reconstructed exactly from the persisted (seed, step) —
nothing else is checkpointed (DERIVABLE, core.reconstruct.pipeline_cursor).

Sample content is generated by a splitmix-style hash so every (seed, index,
position) yields the same token on any host — no data files, fully
reproducible across restarts and re-shardings.  Batches are numpy arrays,
byte-identical to the reference's; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


def _mix(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass
class Pipeline:
    cfg: ArchConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    step: int = 0   # cursor — DERIVABLE from (seed, step)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        gb, s = self.global_batch, self.seq_len
        idx = np.arange(gb, dtype=np.uint64) + np.uint64(step) * np.uint64(gb)
        base = _mix(idx ^ (np.uint64(self.seed) << np.uint64(32)))
        pos = np.arange(s + 1, dtype=np.uint64)
        toks = _mix(base[:, None] ^ (pos[None, :] * np.uint64(0x9E3779B97F4A7C15)))
        toks = (toks % np.uint64(self.cfg.vocab)).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "audio":
            out["frames"] = self.frames_at(step)
        if self.cfg.family == "vlm":
            out["context"] = self.context_at(step)
        return out

    def frames_at(self, step: int) -> np.ndarray:
        gb = self.global_batch
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        return (0.02 * rng.standard_normal(
            (gb, self.cfg.encoder_seq, self.cfg.d_model))).astype(np.float32)

    def context_at(self, step: int) -> np.ndarray:
        gb = self.global_batch
        rng = np.random.default_rng(self.seed * 2_000_003 + step)
        return (0.02 * rng.standard_normal(
            (gb, self.cfg.context_seq, self.cfg.d_model))).astype(np.float32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1

    # -- crash recovery ----------------------------------------------------
    def reconstruct_cursor(self, seed: int, step: int) -> None:
        """Rebuild the cursor from essential state (exact)."""
        self.seed = seed
        self.step = step
