"""Checkpoint catalog: a partly-persistent B+Tree over checkpoint history,
the port of ``repro.ckpt.manifest``.

Maps step -> (generation, bytes, n_leaves) across a training run: the
framework-level manifest workload for the paper's B+Tree (leaves
persisted, inner levels rebuilt on open).  It opens its arena with the
defaults, so integrity resolves through ``REPRO_INTEGRITY`` (on unless
set to 0); it survives crashes with the commit protocol of the
checkpoints it catalogs, its open-after-crash rebuild routes through
``RecoveryManager``, and the history queries ride the tree's chain-order
traversals (``BPTree.keys_in_order`` / ``max_key``).  The tree lives on
``device`` (the GPU unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.arena import open_arena
from repro_torch.core.recovery import RecoveryManager, RecoveryReport
from repro_torch.pstruct.bptree import BPTree


class CheckpointCatalog:
    def __init__(self, path: Optional[str], capacity: int = 4096,
                 mode: str = "partly", device=None):
        cap_nodes = max(64, capacity // 4)
        exists = path is not None and os.path.exists(path)
        self.arena = open_arena(
            path, BPTree.layout(cap_nodes, capacity, mode, name="cat"),
            device=device)
        self.tree = BPTree(self.arena, cap_nodes, capacity, mode, name="cat")
        self.last_recovery: Optional[RecoveryReport] = None
        if exists and self.arena.header_valid():
            mgr = RecoveryManager(self.arena)
            mgr.add("catalog", "pstruct.bptree", self.tree)
            self.last_recovery = mgr.recover()

    def record(self, step: int, generation: int, nbytes: int,
               n_leaves: int) -> None:
        vals = np.zeros((1, 7), np.int64)
        vals[0, :3] = [generation, nbytes, n_leaves]
        self.tree.insert_batch(np.array([step], np.int64), vals)
        self.arena.commit()

    def latest(self) -> Optional[Tuple[int, int, int, int]]:
        key = self.tree.max_key()
        if key is None:
            return None
        _, vals = self.tree.find_batch(np.array([key], np.int64))
        v = vals[0].tolist()
        return (key, int(v[0]), int(v[1]), int(v[2]))

    def steps(self) -> np.ndarray:
        """All recorded steps in order (one leaf-chain gather), as a host
        int64 array."""
        return self.tree.keys_in_order().cpu().numpy()
