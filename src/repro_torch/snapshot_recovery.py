"""Incremental order snapshots on the port: crash -> suffix-only replay, the
counterpart of ``examples/snapshot_recovery.py``.

Builds a DLL (the LRU ring behind the serving allocator) on a file-backed
arena, commits a large base in batches (each commit seals an order-snapshot
record), commits a small suffix of appends, then crashes and recovers
through ``RecoveryManager`` three times:

* clean: the newest record is adopted, nothing replayed;
* the newest record torn: the previous record plus a walk of the suffix;
* the whole snapshot ring corrupted: verification refuses it and the full
  contraction (or doubling) rank runs.

The recovered order is checked in every case.  It runs on the GPU;
``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python -m repro_torch.snapshot_recovery [--device cpu] [--base N]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core.arena import SNAP_SLOTS, open_arena, snap_record_parse
from repro_torch.core.recovery import RecoveryManager, RecoveryReport
from repro_torch.pstruct.dll import DoublyLinkedList

SUFFIX = 120


def tear_newest(struct) -> None:
    """Garble the newest intact record in the PERSISTED record ring, as a
    crash in the middle of its append would leave it."""
    pv = struct.snaprec._pview()
    recs = [(snap_record_parse(pv[s]), s) for s in range(SNAP_SLOTS)]
    pv[max((r[1], s) for r, s in recs if r is not None)[1], 3:] = -777


def corrupt_ring(struct) -> None:
    """Garble every persisted record and half of the persisted order
    mirror (the DLL's ring, the hashmap's chain links)."""
    struct.snaprec._pview()[:, 2:] = -777
    mirror = struct.snapring if hasattr(struct, "snapring") \
        else struct.snapchain
    mirror._pview()[::2] = 2 ** 40


def recover(arena, name: str, struct, reconstructor: str) -> RecoveryReport:
    """Crash ``arena`` and recover ``struct`` through RecoveryManager."""
    arena.crash()
    mgr = RecoveryManager(arena)
    mgr.add(name, reconstructor, struct)
    return mgr.recover()


def _show(report: RecoveryReport, name: str) -> dict:
    det = report.stage(name).detail
    print(f"  recovered in {report.total_seconds * 1e3:.2f} ms: "
          f"chain={det['chain']} replayed={det['replayed']} "
          f"(of {det['count']} live rows)")
    return det


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--base", type=int, default=20_000,
                   help="rows committed before the suffix")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    base = args.base
    with tempfile.TemporaryDirectory() as td:
        cap = base + SUFFIX + 64
        layout = DoublyLinkedList.layout(cap, name="lru", snapshot=True)
        a = open_arena(os.path.join(td, "arena"), layout, device=args.device)
        d = DoublyLinkedList(a, cap, name="lru", snapshot=True)

        rng = np.random.default_rng(0)
        for i in range(0, base, 4096):
            m = min(4096, base - i)
            d.append_batch(rng.integers(0, 1 << 40, (m, 7)).astype(np.int64))
            a.commit()     # each commit seals a snapshot record
        d.append_batch(rng.integers(0, 1 << 40, (SUFFIX, 7)).astype(np.int64))
        a.commit()
        want = d.to_list().clone()

        print(f"crash after committing {base} base + {SUFFIX} suffix rows "
              f"({a.stats.snapshot_lines} snapshot lines amortized over "
              f"{a.stats.epochs} epochs):")
        det = _show(recover(a, "lru", d, "pstruct.dll"), "lru")
        if not (det["chain"] == "snapshot" and det["replayed"] == 0):
            raise AssertionError(f"clean crash: {det}")
        if not torch.equal(d.to_list(), want):
            raise AssertionError("clean crash: recovered order differs")

        print("\ncrash again, newest record torn mid-append "
              "(checksum rejects it -> previous record + suffix walk):")
        tear_newest(d)
        det = _show(recover(a, "lru", d, "pstruct.dll"), "lru")
        if not (det["chain"] == "snapshot" and det["replayed"] == SUFFIX):
            raise AssertionError(f"torn record: {det}")
        if not torch.equal(d.to_list(), want):
            raise AssertionError("torn record: recovered order differs")

        print("\ncrash again, whole snapshot ring corrupted "
              "(verification refuses it -> full contraction rank):")
        corrupt_ring(d)
        det = _show(recover(a, "lru", d, "pstruct.dll"), "lru")
        if det["chain"] not in ("contract", "double"):
            raise AssertionError(f"corrupted ring: {det}")
        if not torch.equal(d.to_list(), want):
            raise AssertionError("corrupted ring: recovered order differs")
        a.close()
        print("\nrecovered order bit-identical in all three scenarios")


if __name__ == "__main__":
    main()
