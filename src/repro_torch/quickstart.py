"""Quickstart: the paper's technique on the port, the counterpart of
``examples/quickstart.py``.

Builds each of the three partly-persistent structures, runs a workload,
crashes, reconstructs, and prints the flush savings vs fully-persistent.
It runs on the GPU; ``--device cpu`` runs it on the CPU.  Integrity
sidecars and order snapshots follow ``REPRO_INTEGRITY`` and
``REPRO_SNAPSHOT`` as in the reference example (their lines are counted
apart from the ``lines`` printed).

    PYTHONPATH=src python -m repro_torch.quickstart [--n 20000] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.arena import open_arena
from repro_torch.pstruct.bptree import BPTree
from repro_torch.pstruct.dll import DoublyLinkedList
from repro_torch.pstruct.hashmap import Hashmap


def demo(kind: str, n: int, rng: np.random.Generator, device) -> str:
    """Run one structure in both modes; return its summary line.  Draws
    from ``rng`` exactly as the reference example draws from its own."""
    lines = {}
    for mode in ("full", "partly"):
        if kind == "dll":
            a = open_arena(None, DoublyLinkedList.layout(n + 64, mode),
                           device=device)
            s = DoublyLinkedList(a, n + 64, mode)
        elif kind == "bptree":
            a = open_arena(None, BPTree.layout(n, n * 2, mode),
                           device=device)
            s = BPTree(a, n, n * 2, mode)
        else:
            a = open_arena(None, Hashmap.layout(n + 64, mode), device=device)
            s = Hashmap(a, n + 64, mode)

        keys = rng.permutation(n).astype(np.int64)
        vals = rng.integers(0, 1 << 40, (n, 7)).astype(np.int64)
        for i in range(0, n, 1024):
            if kind == "dll":
                s.append_batch(vals[i:i + 1024])
            else:
                s.insert_batch(keys[i:i + 1024], vals[i:i + 1024])
        a.commit()
        lines[mode] = a.stats.lines

        if mode == "partly":
            # ---- crash: volatile state gone; reconstruct from essentials
            a.crash()
            a.reopen()
            s.reconstruct()
            if kind == "dll":
                if s.count != n:
                    raise RuntimeError(f"dll recovered {s.count} of {n}")
            else:
                ok, got = s.find_batch(keys)
                want = torch.from_numpy(vals).to(got.device)
                if not (bool(ok.all()) and bool((got == want).all())):
                    raise RuntimeError(f"{kind}: recovered map differs")
    save = (1 - lines["partly"] / lines["full"]) * 100
    return (f"{kind:8s}  fully={lines['full']:8d} lines   "
            f"partly={lines['partly']:8d} lines   saved={save:.0f}%   "
            f"(crash+reconstruct verified)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    rng = np.random.default_rng(0)
    print(f"inserting {args.n} entries into each structure, both modes:\n")
    for kind in ("dll", "bptree", "hashmap"):
        print(demo(kind, args.n, rng, args.device))
    print("\nDon't persist all: only the essential fields hit the arena; "
          "redundancy is rebuilt on restart.")


if __name__ == "__main__":
    main()
