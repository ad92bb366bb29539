"""The feature store's exactly-once recovery, on the port: the journal's
cost and the twin protocol.

* ``journal_report`` is the port of ``benchmarks/recovery_bench.py``
  ``journal_report``: 64 requests of 8 keys (of 256) with 4-word deltas
  applied to a ``FeatureStore``, journal on and off; per row the flushed
  lines, epochs and journal lines (deterministic, equal to the
  reference's) and the best of three crash-recover times (this device's).
  It asserts the journal's bound: at most one ring line per epoch, none
  with the journal off, and equal data lines either way.
* ``twin`` is the duplicate-admission oracle of
  ``tests/test_async_recovery.py``: apply a script's first ``boundary``
  requests, crash (torn inside the next request, or clean between two),
  recover, replay the WHOLE script; exactly the completed prefix must be
  refused, and the effects (every key's vector and count, the cursor, the
  journal's classes) must equal an uninterrupted twin's.

The command runs both on the card; ``--device cpu`` runs them on the CPU:

    PYTHONPATH=src python -m repro_torch.feature_recover [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.arena import resolve_device
from repro_torch.serve.feature_store import FeatureConfig, FeatureStore
from repro_torch.serve.journal import ST_DONE, ST_NEVER

Op = Tuple[int, np.ndarray, np.ndarray]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def requests(n_ops: int, keys_per_op: int, key_space: int, dim: int,
             seed: int = 0) -> List[Op]:
    """``n_ops`` requests ``(rid, keys, deltas)``: ``keys_per_op`` unique
    keys drawn from ``key_space``, deltas in [-9, 9], from numpy seeded by
    ``seed`` (journal_report's script at its own arguments)."""
    rng = np.random.default_rng(seed)
    ops = []
    for rid in range(n_ops):
        keys = rng.choice(key_space, size=keys_per_op,
                          replace=False).astype(np.int64)
        deltas = rng.integers(-9, 10, (keys_per_op, dim)).astype(np.int64)
        ops.append((rid, keys, deltas))
    return ops


def arena_fields(a) -> Dict:
    """The substrate fields the reference stamps on every bench row
    (``benchmarks/common.arena_fields``) for a single unpaged arena."""
    return {"commit_mode": a.commit_mode,
            "n_shards": getattr(a, "n_shards", 1),
            "arena_bytes": int(sum(r.nbytes for r in a.regions.values())),
            "block_bytes": 0, "cache_blocks": 0, "peak_resident_bytes": 0,
            "integrity": bool(a.integrity),
            "integrity_lines": int(a.stats.integrity_lines)}


def journal_report(n_ops: int = 64, repeats: int = 3, device=None) -> Dict:
    """Exactly-once journal cost, both sides, at the reference bench's
    size: journal lines per epoch on the write side, crash-to-served time
    on the recovery side, journal on and off."""
    device = resolve_device(device)
    ops = requests(n_ops, 8, 256, 4)
    rows: List[Dict] = []
    for journal in (True, False):
        cfg = FeatureConfig(n_keys=256, dim=4, n_samples=8 * n_ops + 64,
                            journal=journal)
        fs = FeatureStore(cfg, device=device)
        s0 = fs.arena.stats.snapshot()
        for op in ops:
            if not fs.apply(*op):
                raise AssertionError(f"request {op[0]} refused")
        d = fs.arena.stats.delta(s0)
        best = float("inf")
        for _ in range(repeats):
            fs.crash()
            _sync(device)
            t0 = time.perf_counter()
            fs.recover(concurrency=2)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        rows.append({"journal": journal, "n_ops": n_ops,
                     "recover_s": round(best, 6),
                     "epochs": int(d.epochs),
                     "lines": int(d.lines),
                     "lines_per_epoch": round(d.lines / d.epochs, 3),
                     "journal_lines": int(d.journal_lines),
                     "journal_lines_per_epoch":
                         round(d.journal_lines / d.epochs, 3),
                     **arena_fields(fs.arena)})
    on, off = rows
    # the piggybacked HEAD/TAIL ride the host header line: overhead is
    # at most one ring line per epoch, and the data ledgers match
    if not 0 < on["journal_lines"] <= on["epochs"]:
        raise AssertionError(f"journal lines above one per epoch: {on}")
    if off["journal_lines"] != 0 or on["lines"] != off["lines"]:
        raise AssertionError(f"journal off changed the data lines: "
                             f"{on} vs {off}")
    return {"rows": rows,
            "recover_overhead_x": round(
                rows[0]["recover_s"] / max(rows[1]["recover_s"], 1e-9), 3)}


def effects(fs: FeatureStore) -> Dict:
    """What a client can observe: every key's vector, the per-slot
    counts, the cursor and the journal's classes (host copies)."""
    return {"vectors": fs.lookup(np.arange(fs.cfg.n_keys)).cpu().numpy(),
            "counts": fs.counts.cpu().numpy(),
            "next_sample": fs.next_sample,
            "classify": dict(fs.journal.classify())}


def same_effects(got: Dict, want: Dict) -> bool:
    return (got["classify"] == want["classify"]
            and got["next_sample"] == want["next_sample"]
            and np.array_equal(got["counts"], want["counts"])
            and np.array_equal(got["vectors"], want["vectors"]))


def run_twin(cfg: FeatureConfig, ops: Sequence[Op], device) -> Dict:
    """The uninterrupted twin: every request applied; its effects and
    flush counters.  Raises if a request is refused or the journal takes
    more than one ring line per epoch."""
    fs = FeatureStore(cfg, device=device)
    s0 = fs.arena.stats.snapshot()
    _sync(fs.device)
    t0 = time.perf_counter()
    for op in ops:
        if not fs.apply(*op):
            raise AssertionError(f"twin refused request {op[0]}")
    _sync(fs.device)
    apply_s = time.perf_counter() - t0
    d = fs.arena.stats.delta(s0)
    if not 0 < d.journal_lines <= d.epochs:
        raise AssertionError(f"journal lines {d.journal_lines} outside "
                             f"(0, epochs={d.epochs}]")
    return {"effects": effects(fs), "apply_s": apply_s,
            "stats": dataclasses.asdict(d)}


def twin(cfg: FeatureConfig, ops: Sequence[Op], boundary: int,
         torn: bool = True, device=None, concurrency: int = 1,
         want: Optional[Dict] = None) -> Dict:
    """Crash at ``boundary`` (torn inside request ``boundary``, or clean
    after request ``boundary - 1``), recover, replay the whole script and
    hold the effects against the uninterrupted twin (``want``, from
    ``run_twin``; run here when None).  Returns the run's numbers; raises
    on any departure from the exactly-once contract."""
    device = resolve_device(device)
    if want is None:
        want = run_twin(cfg, ops, device)
    fs = FeatureStore(cfg, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for op in ops[:boundary]:
        if not fs.apply(*op):
            raise AssertionError(f"request {op[0]} refused before the "
                                 f"crash")
    _sync(device)
    out = {"boundary": boundary, "torn": torn, "n_ops": len(ops),
           "apply_s": time.perf_counter() - t0,
           "twin_apply_s": want["apply_s"]}
    if torn and boundary < len(ops):
        # data phase durable, commit not
        if fs.apply(*ops[boundary], _torn_crash=True) is not False:
            raise AssertionError("a torn apply reported success")
    else:
        fs.crash()
    _sync(device)
    t0 = time.perf_counter()
    rep = fs.recover(concurrency=concurrency)
    _sync(device)
    out["recover_s"] = time.perf_counter() - t0
    out["stages"] = {st.name: st.seconds for st in rep.stages}
    out["store_detail"] = rep.stage("store").detail
    if rep.valid != (boundary > 0):
        raise AssertionError(f"report valid={rep.valid} at boundary "
                             f"{boundary}")
    if fs.journal.classify() != {rid: ST_DONE for rid, _, _ in
                                 ops[:boundary]}:
        raise AssertionError("recovered journal classes are not the "
                             "committed prefix")
    if boundary < len(ops) and \
            fs.journal.state_of(ops[boundary][0]) != ST_NEVER:
        raise AssertionError("the crashed request left a committed trace")
    # the oracle: completed requests are refused, the rest apply once
    _sync(device)
    t0 = time.perf_counter()
    applied = [fs.apply(*op) for op in ops]
    _sync(device)
    out["replay_s"] = time.perf_counter() - t0
    out["refused"] = applied.count(False)
    if applied != [i >= boundary for i in range(len(ops))]:
        raise AssertionError(f"replay refused {out['refused']} requests, "
                             f"expected exactly the first {boundary}")
    if not same_effects(effects(fs), want["effects"]):
        raise AssertionError("effects after replay differ from the "
                             "uninterrupted twin's")
    out["stats"] = dataclasses.asdict(fs.arena.stats)
    out["twin_stats"] = want["stats"]
    return out


def oracle_config(journal: bool = True) -> FeatureConfig:
    """The duplicate-admission oracle's store (barrier commit, one
    shard)."""
    return FeatureConfig(n_keys=64, dim=3, n_samples=512, journal=journal)


def oracle_script(n_ops: int = 6, seed: int = 13) -> List[Op]:
    """The oracle's script: 1-5 unique keys of 64 per request, 3-word
    deltas in [-9, 9]."""
    rng = np.random.default_rng(seed)
    ops = []
    for rid in range(n_ops):
        m = int(rng.integers(1, 6))
        keys = rng.choice(64, size=m, replace=False).astype(np.int64)
        deltas = rng.integers(-9, 10, (m, 3)).astype(np.int64)
        ops.append((rid, keys, deltas))
    return ops


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps({"device": str(device),
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu")}))
    rep = journal_report(device=device)
    for r in rep["rows"]:
        print(json.dumps({"table": "journal_report", **r}))
    ops = oracle_script()
    want = run_twin(oracle_config(), ops, device)
    n = 0
    for torn in (False, True):
        for boundary in range(len(ops) + (0 if torn else 1)):
            twin(oracle_config(), ops, boundary, torn=torn, device=device,
                 want=want)
            n += 1
    print(f"exactly-once: {n} crash points (clean and torn) over "
          f"{len(ops)} requests, each replay refused exactly the "
          f"completed prefix and matched the uninterrupted twin")


if __name__ == "__main__":
    main()
