"""Sample index: the B+Tree's live use-case, the port of
``repro.data.index``.

Maps sample id -> (shard, offset, length) for a sharded corpus.  Partly
persistent as the paper has it: only leaf nodes (and records and header)
reach storage; inner levels are rebuilt on recovery.  The tree's rows live
on the arena's device, so ``lookup`` returns tensors there.

The index does not pin ``integrity``: it resolves through
``REPRO_INTEGRITY`` (on by default), as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arena import open_arena
from repro_torch.core.recovery import RecoveryManager, RecoveryReport
from repro_torch.pstruct.bptree import BPTree


class SampleIndex:
    def __init__(self, path: Optional[str], capacity: int,
                 mode: str = "partly", device=None):
        cap_nodes = max(64, int(capacity / 8))
        self.arena = open_arena(
            path, BPTree.layout(cap_nodes, capacity, mode, name="idx"),
            device=device)
        self.tree = BPTree(self.arena, cap_nodes, capacity, mode, name="idx")
        self.last_recovery: Optional[RecoveryReport] = None

    def add(self, sample_ids, shards, offsets, lengths) -> None:
        """Insert (or update) ``sample_ids`` and commit."""
        vals = np.zeros((len(sample_ids), 7), np.int64)
        vals[:, 0] = shards
        vals[:, 1] = offsets
        vals[:, 2] = lengths
        self.tree.insert_batch(sample_ids, vals)
        self.arena.commit()

    def lookup(self, sample_ids
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
        """(found mask, shards, offsets, lengths), tensors on the index's
        device."""
        ok, vals = self.tree.find_batch(sample_ids)
        return ok, vals[:, 0], vals[:, 1], vals[:, 2]

    def recover(self) -> float:
        """Reconstruct after a crash through the recovery manager; returns
        seconds (the staged RecoveryReport lands in ``last_recovery``)."""
        mgr = RecoveryManager(self.arena)
        mgr.add("index", "pstruct.bptree", self.tree)
        report = mgr.recover()
        self.last_recovery = report
        return report.total_seconds
