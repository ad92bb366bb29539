"""Bit rot -> scrub -> salvage: quarantine the loss, serve the rest.  The
port of ``examples/salvage_recovery.py``.

Builds a mixed three-structure arena (DLL + B+Tree + hashmap) on disk,
with integrity sidecars on (the default), crashes it, and flips ONE bit
in a committed B+Tree leaf: the media fault the sidecars exist for
(DESIGN.md §13).  A scrub names the exact region and row, and
``recover(salvage=True)`` quarantines the damaged keys while the other
two structures recover exactly.  Part two does the same to a serving
engine's token log (the reduced llama3.2-3b, parameters from a seeded
``torch.Generator``): the rid whose tokens rotted is refused with
``QuarantinedError`` until an explicit ``readmit`` closes it out.  The
scrub rows, the quarantined and degraded stages, the quarantined keys and
rids are the reference example's.

It runs on the card; ``--device cpu`` runs on the CPU:

    PYTHONPATH=src python -m repro_torch.salvage_recovery [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import faultinject as fi
from repro_torch.core.arena import (QuarantinedError, open_arena,
                                    resolve_device)
from repro_torch.core.recovery import RecoveryManager
from repro_torch.pstruct.bptree import BPTree
from repro_torch.pstruct.dll import DoublyLinkedList
from repro_torch.pstruct.hashmap import Hashmap


def build(path: str, device):
    """The example's mixed arena and its 30 committed operations."""
    layout = {}
    layout.update(DoublyLinkedList.layout(256, "partly", name="dll"))
    layout.update(BPTree.layout(256, 1024, "partly", name="bt"))
    layout.update(Hashmap.layout(512, "partly", name="hm"))
    a = open_arena(path, layout, device=device)
    d = DoublyLinkedList(a, 256, "partly", name="dll")
    t = BPTree(a, 256, 1024, "partly", name="bt")
    h = Hashmap(a, 512, "partly", name="hm")
    rng = np.random.default_rng(0)
    key = 0
    for i in range(30):
        m = int(rng.integers(2, 7))
        vals = rng.integers(0, 1 << 30, (m, 7)).astype(np.int64)
        keys = np.arange(key, key + m, dtype=np.int64)
        key += m
        with a.epoch():
            if i % 3 == 0:
                d.append_batch(vals)
            elif i % 3 == 1:
                t.insert_batch(keys, vals)
            else:
                h.insert_batch(keys, vals)
        a.commit()
    return a, d, t, h


def salvage_mixed(td: str, device) -> dict:
    a, d, t, h = build(os.path.join(td, "mixed.pm"), device)
    dll_order = d.order().cpu().numpy()
    bt_keys = t.keys_in_order().cpu().numpy()
    hm_size = int(h.size)
    leaf = int(t.leaves()[1])

    a.crash()
    fi.flip_bits(a, a.regions["bt.nodes"], leaf, byte=8, mask=0x40)
    print(f"crashed, then one bit flipped in committed leaf row {leaf} "
          f"of bt.nodes (media fault, not a torn write):")

    bad = a.scrub()
    for reg, rows in bad.items():
        print(f"  scrub: {reg} rows {rows.tolist()} fail their "
              f"line checksums")

    mgr = RecoveryManager(a)
    mgr.add("dll", "pstruct.dll", d)
    mgr.add("bt", "pstruct.bptree", t)
    mgr.add("hm", "pstruct.hashmap", h)
    rep = mgr.recover(salvage=True)
    print(f"  salvage recover in {rep.total_seconds * 1e3:.2f} ms: "
          f"quarantined={rep.quarantined} degraded={rep.degraded}")

    got = t.keys_in_order().cpu().numpy()
    lost = sorted(t.quarantined)
    if not set(got.tolist()) <= set(bt_keys.tolist()):
        raise AssertionError("bt: salvage invented keys")
    if not set(lost).isdisjoint(got.tolist()):
        raise AssertionError("bt: a survivor is quarantined")
    print(f"  bt: {got.size}/{bt_keys.size} keys survive, quarantined "
          f"keys {lost} are withheld (disjoint from survivors)")

    if not np.array_equal(d.order().cpu().numpy(), dll_order):
        raise AssertionError("dll: order differs after salvage")
    if int(h.size) != hm_size:
        raise AssertionError("hm: size differs after salvage")
    print(f"  dll ({dll_order.size} rows) and hm ({hm_size} keys) "
          f"recover bit-identical — the loss never spreads")
    return {"scrub": {k: v.tolist() for k, v in bad.items()},
            "quarantined": rep.quarantined, "degraded": rep.degraded,
            "bt_quarantined": lost}


def salvage_engine(td: str, device) -> dict:
    from repro_torch.configs import base, registry
    from repro_torch.models.model import build as build_model
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    model = build_model(base.reduced(registry.get("llama3.2-3b")),
                        compute_dtype=torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init_params(gen, device)
    eng = ServingEngine(model, params,
                        EngineConfig(max_batch=3, s_max=16,
                                     max_requests=16),
                        arena_path=os.path.join(td, "engine"),
                        device=device)
    eng.add_request(7, np.array([1, 2, 3], np.int64))
    eng.add_request(8, np.array([4, 5, 6, 9, 2], np.int64))
    eng.step()
    eng.crash()
    fi.flip_bits(eng.arena, eng.arena.regions["tokens"], 0,
                 byte=4, mask=0x10)           # rid 7's token-log row
    print("\nengine crashed, rid 7's token-log line rotted:")

    eng.recover(salvage=True)
    st = eng.last_recovery.stage("engine")
    print(f"  salvage recover: quarantined_rids="
          f"{st.detail['quarantined_rids']}, rid 8 serves on")
    out = eng.step()
    if 8 not in out or 7 in out:
        raise AssertionError(f"engine step served {sorted(out)}")

    try:
        eng.add_request(7, np.array([1, 2, 3], np.int64))
        raise AssertionError("quarantined rid was admitted")
    except QuarantinedError as e:
        print(f"  re-admitting rid 7 refused: {e}")

    eng.readmit([7])
    if eng.quarantined_rids:
        raise AssertionError("readmit left rids quarantined")
    print("  explicit readmit([7]) closes it out "
          f"(journal state: {eng.journal.state_of(7)}); "
          "corruption never silently re-enters the batch")
    return {"quarantined_rids": st.detail["quarantined_rids"],
            "journal_state": eng.journal.state_of(7)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as td:
        salvage_mixed(td, device)
        salvage_engine(td, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
