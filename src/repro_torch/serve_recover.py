"""Serving with partly-persistent request state and crash recovery, held
against an uninterrupted twin: the port of ``examples/serve_recover.py``.

Two engines share one model and its parameters and take the same requests
and steps.  One crashes (dropping KV caches, the request hashmap, the
paged-LRU metadata and the journal index) and recovers from its arenas;
the other never crashes.  Then:

* the recovered cache tree must equal the twin's (max abs error over the
  largest |k|, |v|, on the live slots);
* both serve more steps: tokens equal, logits within tolerance;
* a request finished before the crash is not re-admitted, and adding it
  again raises ``DuplicateRequestError``; a new request takes its slot.

The comparison covers caches and logits because greedy tokens alone prove
little: a small model with random weights and tied embeddings tends to
repeat its last input token.  The run prints how many distinct tokens it
generated.  Both engines' caches hold every logged token but the last
(``serve/engine.py``): the K/V caches are compared at positions
``[0, pos - 1)`` of each live slot, and a recurrent layer's leaves (a
hybrid layer's ``ssm`` state and ``conv`` tail, an mLSTM layer's ``c``,
``n``, ``m``, an sLSTM layer's ``c``, ``n``, ``h``, ``m``) whole, each
kind of leaf against its own largest |value|.  (The reference engine's
step feeds token p - 1 at position p after a prefill that already took
it, so its recovered caches differ from its twin's once tokens vary,
and a recurrent state takes a token twice.)

An arch with MoE layers takes another rule.  A prefill group routes its
tokens under a capacity that drops some of them, while decode routes one
token at a time and drops none (the reference's own behaviour), so a
re-prefilled cache cannot equal a cache that decoding built past the
first MoE layer.  There the recovered caches are held against a
crash-free prefill of the same token logs (a third engine admitting each
live request with its whole log), and serve on beside it with tokens
equal; against the decode-built twin only the first layer's caches,
which no MoE output feeds, are held, and the rest is reported with the
number of assignments the re-prefill dropped.

The xLSTM arch takes the same rule for another reason.  Its chunkwise
prefill and its step compute the same recurrences in other orders (the
chunk's log-decay sums cancel, the step multiplies), and the exponential
gates and running stabilizers carry those roundings forward through the
sequence and amplify them through the depth: at full width a re-prefill
parts from the decode-built caches past the first layer by more than any
rounding tolerance, as the reference's own prefill and decode part where
the gates' pre-activations are as large
(``tests/test_torch_xlstm_model.py``).  The first layer, fed by the
embedding alone, is held against the twin; a crash-free prefill of the
same logs is computed as the re-prefill is, and is held whole.

It runs llama3.2-3b at full width on the card; ``--device cpu`` runs on
the CPU, ``--layers`` cuts the depth, ``--reduced`` takes the reduced
smoke config, ``--arch`` another arch (any of the ten):

    PYTHONPATH=src python -m repro_torch.serve_recover [--device cpu]
    PYTHONPATH=src python -m repro_torch.serve_recover --arch xlstm-1.3b \\
        --reduced --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import base, registry
from repro_torch.core.arena import resolve_device
from repro_torch.core.policy import tree_flatten_with_path
from repro_torch.models.backbone import parse_tag
from repro_torch.models.model import Model
from repro_torch.serve.engine import EngineConfig, ServingEngine
from repro_torch.serve.journal import DuplicateRequestError

ARCH = "llama3.2-3b"
CACHE_TOL = 1e-4      # recovered vs twin cache, relative to max |k|, |v|
LOGIT_TOL = 1e-4      # recovered vs twin logits, relative to max |logit|
BF16_TOL = 2e-2       # both, when the engines compute in bf16
CROSS_LEAVES = ("xk", "xv")
# a recurrent layer's state leaves, by layer base: no ring over the token
# positions, so always compared whole
RECURRENT_LEAVES = {"hybrid": ("ssm", "conv"), "mlstm": ("c", "n", "m"),
                    "slstm": ("c", "n", "h", "m")}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompts_for(lens: Sequence[int], vocab: int, seed: int
                ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(n)).astype(np.int64) for n in lens]


def _held(n: int, cap: int) -> torch.Tensor:
    """The cache slots that hold positions [0, n): all of [0, n) in a
    linear cache, every slot of a ring of ``cap`` slots that has
    wrapped."""
    return torch.arange(min(n, cap))


def _first_layer(cache: Dict) -> Dict:
    """The first layer's part of a cache tree (superblock 0's first
    position, or the first remainder layer), in the tree's shape."""
    if "blocks" in cache:
        return {"blocks": {"pos0": {n: t[:1] for n, t in
                                    cache["blocks"]["pos0"].items()}}}
    return {"rem": {"rem0": cache["rem"]["rem0"]}}


def cache_error(a: ServingEngine, b: ServingEngine, slots,
                b_slots=None, first_layer: bool = False,
                whole: bool = False) -> Dict:
    """Max abs difference of two engines' caches over ``slots`` of ``a``
    (``b_slots`` of ``b``, the same slots by default), each K/V cache at
    the positions both engines hold there, ``[0, pos - 1)`` (the last
    token of the log is cached by the next decode step; a local layer's
    ring holds the last ``window`` of them), or every cache slot with
    ``whole``; a cross layer's context keys and values and a recurrent
    layer's state leaves (``RECURRENT_LEAVES``, known by the layer's
    base) always whole.  Each kind of leaf is held against the largest
    |value| of ``b``'s leaves of that kind: a K/V or cross leaf's kind is
    its name (``k``, ``xv``), a recurrent leaf's its base and name
    (``hybrid.ssm``, ``mlstm.c`` apart from ``slstm.c``).  ``rel_err`` is
    the largest of those ratios (``leaves`` has each), ``max_abs_err``
    and ``max_abs`` the largest difference and value overall.
    ``superblocks`` has each superblock's ratios.  ``first_layer``
    compares the first layer alone."""
    ca, cb = a.cache, b.cache
    if first_layer:
        ca, cb = _first_layer(ca), _first_layer(cb)
    b_slots = slots if b_slots is None else b_slots
    pattern, _, rem = a.model.cfg.pattern_plan()
    bases = {("blocks", f"pos{i}"): t for i, t in enumerate(pattern)}
    bases.update({("rem", f"rem{i}"): t for i, t in enumerate(rem)})
    errs: Dict[str, List[float]] = {}
    per_block: Dict[int, Dict[str, List[float]]] = {}

    def note(table, kind, x, y):
        e = table.setdefault(kind, [0.0, 0.0])
        e[0] = max(e[0], float((x - y).abs().max()))
        e[1] = max(e[1], float(y.abs().max()))
    for grp in ca:
        for pos in ca[grp]:
            base = parse_tag(bases[grp, pos])[0]
            recurrent = RECURRENT_LEAVES.get(base, ())
            for name, leaf in ca[grp][pos].items():
                other = cb[grp][pos][name]
                ax = 2 if grp == "blocks" else 1    # the cache slot axis
                kind = f"{base}.{name}" if name in recurrent else name
                for s, sb in zip(slots, b_slots):
                    x, y = ((t[:, i] if grp == "blocks" else t[i])
                            for t, i in ((leaf, s), (other, sb)))
                    # a context's keys and values and a recurrent state
                    # are no ring over the token positions
                    if not (whole or name in CROSS_LEAVES
                            or name in recurrent):
                        held = _held(int(b.pos[sb]) - 1,
                                     leaf.shape[ax]).to(leaf.device)
                        x, y = (t.index_select(ax - 1, held)
                                for t in (x, y))
                    note(errs, kind, x, y)
                    if grp == "blocks":
                        for j in range(x.shape[0]):
                            note(per_block.setdefault(j, {}), kind, x[j],
                                 y[j])

    def ratios(table):
        return {n: e / m if m else 0.0 for n, (e, m) in table.items()}
    return {"max_abs_err": max(e for e, _ in errs.values()),
            "max_abs": max(m for _, m in errs.values()),
            "rel_err": max(ratios(errs).values()), "leaves": ratios(errs),
            "superblocks": [ratios(per_block[j]) for j in sorted(per_block)]}


def _logit_err(eng: ServingEngine, twin: ServingEngine) -> float:
    """The largest logit difference of the last steps, relative to the
    twin's largest |logit|, over the requests both stepped and the real
    vocabulary (the padded entries hold the dtype's lowest value)."""
    err, v = 0.0, eng.model.cfg.vocab
    for rid, lg in eng.step_logits.items():
        if rid in twin.step_logits:
            ref = twin.step_logits[rid][:v]
            err = max(err, float((lg[:v] - ref).abs().max())
                      / float(ref.abs().max()))
    return err


def _step_both(eng: ServingEngine, twin: ServingEngine, log: Dict,
               key: str, reported: Optional[ServingEngine] = None) -> None:
    """One step of each engine; tokens must be equal, logits are compared
    relative to the twin's largest |logit|.  ``reported`` steps too, and
    its token agreement and logit difference are only logged."""
    _sync(eng.device)
    t0 = time.perf_counter()
    got = eng.step()
    _sync(eng.device)
    log.setdefault("slot_step_s", []).append(
        (time.perf_counter() - t0) / max(1, len(got)))
    want = twin.step()
    if got != want:
        raise AssertionError(f"{key}: tokens {got} != twin's {want}")
    log[f"{key}_logit_rel_err"] = max(log.get(f"{key}_logit_rel_err", 0.0),
                                      _logit_err(eng, twin))
    log.setdefault("tokens", []).extend(got.values())
    if reported is not None:
        other = reported.step()
        log["decode_twin_same_tokens"] = log.get(
            "decode_twin_same_tokens", 0) + sum(
            other.get(r) == t for r, t in got.items())
        log["decode_twin_logit_rel_err"] = max(
            log.get("decode_twin_logit_rel_err", 0.0),
            _logit_err(eng, reported))


def run(cfg, device, *, prompt_lens: Sequence[int], max_batch: int,
        s_max: int, steps: int = 8, max_requests: int = 64, seed: int = 0,
        concurrency: int = 1, params=None,
        workdir: Optional[str] = None, n_shards: int = 1,
        commit_mode: str = "barrier",
        steps_after: Optional[int] = None,
        compute_dtype=torch.float32,
        check: Optional[Callable[[ServingEngine, ServingEngine],
                                 None]] = None) -> Dict:
    """The twin protocol at ``cfg``: admit one request per prompt length to
    both engines, serve ``steps``, finish the first request, serve
    ``steps`` more, crash and recover one engine, compare caches, check
    the finished rid, admit a new request on its slot and serve
    ``steps_after`` (default ``steps``) further.  The engines compute in
    ``compute_dtype`` (f32 by default; bf16 loosens both tolerances to
    ``BF16_TOL``) over parameters drawn in ``compute_dtype`` when
    ``params`` is None.  An arch with MoE or xLSTM layers holds the
    recovered engine against a crash-free prefill of the same token logs
    (see the module's docstring).  ``n_shards`` shards the engines' arenas;
    ``commit_mode`` is their commit protocol.  ``check``, when given, is
    called with the recovered engine and its twin after the last step.
    Returns the run's numbers; raises on any mismatch."""
    from repro_torch.models.moe import collect_drops
    device = resolve_device(device)
    model = Model(cfg, compute_dtype=compute_dtype)
    if params is None:
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        params = model.init_params(g, device, compute_dtype)
    tol = CACHE_TOL if compute_dtype == torch.float32 else BF16_TOL
    logit_tol = LOGIT_TOL if compute_dtype == torch.float32 else BF16_TOL
    # the prefill rule: the decode-built twin is held on its first layer
    prefill_rule = cfg.moe is not None or cfg.xlstm is not None
    ec = EngineConfig(max_batch=max_batch, s_max=s_max,
                      max_requests=max_requests, n_shards=n_shards,
                      commit_mode=commit_mode)
    prompts = prompts_for(list(prompt_lens) + [prompt_lens[-1]], cfg.vocab,
                          seed)
    rids = [1000 + i for i in range(len(prompt_lens))]
    out: Dict = {"arch": cfg.name, "layers": cfg.n_layers,
                 "d_model": cfg.d_model, "device": str(device),
                 "dtype": str(compute_dtype).split(".")[-1],
                 "params": sum(t.numel() for _, t in
                               tree_flatten_with_path(params)),
                 "prompt_lens": list(prompt_lens), "steps": steps}
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        eng = ServingEngine(model, params, ec, os.path.join(td, "eng"),
                            device=device)
        twin = ServingEngine(model, params, ec, os.path.join(td, "twin"),
                             device=device)
        out["kv_cache_bytes"] = sum(t.numel() * t.element_size() for _, t
                                    in tree_flatten_with_path(eng.cache))
        prefill = []
        for rid, prompt in zip(rids, prompts):
            _sync(device)
            t0 = time.perf_counter()
            eng.add_request(rid, prompt)
            _sync(device)
            # the admission prefills every prompt token but the last
            prefill.append({"tokens": len(prompt),
                            "prefilled": len(prompt) - 1,
                            "seconds": time.perf_counter() - t0})
            twin.add_request(rid, prompt)
        out["prefill"] = prefill
        log: Dict = {}
        for _ in range(steps):
            _step_both(eng, twin, log, "before")
        done = rids[0]
        freed = int(np.flatnonzero(eng.slot_rid == done)[0])
        eng.finish_request(done)
        twin.finish_request(done)
        for _ in range(steps):
            _step_both(eng, twin, log, "before")
        live = np.flatnonzero(eng.slot_rid >= 0)
        # ---- crash and recover
        eng.crash()
        admitted = []
        # a group of logs of tl tokens re-prefills tl - 1 of them
        eng.on_slot_ready = lambda sl, tl, s: admitted.append(
            {"slots": [int(x) for x in sl], "tokens": int(tl),
             "prefilled": int(tl) - 1, "admitted_s": s})
        with collect_drops() as drops:
            out["recover_s"] = eng.recover(concurrency=concurrency)
        eng.on_slot_ready = None
        rep = eng.last_recovery
        out["stages"] = {st.name: st.seconds for st in rep.stages}
        out["engine_detail"] = rep.stage("engine").detail
        out["groups"] = admitted
        ref = None
        if prefill_rule:
            out["reprefill_dropped"] = int(sum(int(d) for d in drops))
            out["cache_vs_decode_twin"] = cache_error(eng, twin, live)
            out["cache"] = cache_error(eng, twin, live, first_layer=True)
            # the crash-free prefill of the same token logs
            ref = ServingEngine(model, params, ec, os.path.join(td, "ref"),
                                device=device)
            ref_slots = []
            for s in live:
                toks = eng.tok_region.read_at([s], slice(0, int(eng.pos[s])))
                ref_slots.append(ref.add_request(
                    int(eng.slot_rid[s]), toks[0].cpu().numpy().astype(
                        np.int64)))
            out["cache_vs_prefill"] = cache_error(eng, ref, live, ref_slots,
                                                  whole=True)
            if out["cache_vs_prefill"]["rel_err"] > tol:
                raise AssertionError(f"recovered cache differs from a "
                                     f"crash-free prefill of the same "
                                     f"token logs: "
                                     f"{out['cache_vs_prefill']}")
        else:
            out["cache"] = cache_error(eng, twin, live)
        if out["cache"]["rel_err"] > tol:
            raise AssertionError(f"recovered cache differs from the twin's: "
                                 f"{out['cache']}")
        # ---- the finished request stays finished; its slot takes new work
        if done in eng.slot_rid.tolist():
            raise AssertionError(f"finished request {done} re-admitted")
        try:
            eng.add_request(done, prompts[0])
        except DuplicateRequestError:
            pass
        else:
            raise AssertionError(f"re-adding finished request {done} was "
                                 f"not refused")
        new_rid = 1000 + len(prompt_lens)
        slots = (eng.add_request(new_rid, prompts[-1]),
                 twin.add_request(new_rid, prompts[-1]))
        if slots != (freed, freed):
            raise AssertionError(f"new request seated on {slots}, not on "
                                 f"the freed slot {freed}")
        if ref is not None:
            ref.add_request(new_rid, prompts[-1])
        for _ in range(steps if steps_after is None else steps_after):
            if ref is None:
                _step_both(eng, twin, log, "after")
            else:
                _step_both(eng, ref, log, "after", reported=twin)
        out["logit_rel_err"] = {k: log[f"{k}_logit_rel_err"]
                                for k in ("before", "after")}
        if ref is not None:
            out["decode_twin"] = {
                "same_tokens": log["decode_twin_same_tokens"],
                "logit_rel_err": log["decode_twin_logit_rel_err"]}
        if out["logit_rel_err"]["after"] > logit_tol:
            raise AssertionError(f"logits after recovery differ from the "
                                 f"{'prefill' if prefill_rule else 'twin'}'s: "
                                 f"{out['logit_rel_err']}")
        out["decode_ms_per_slot_step"] = 1e3 * float(np.median(
            log["slot_step_s"]))
        if check is not None:
            check(eng, twin)
        out["distinct_tokens"] = len(set(log["tokens"]))
        out["tokens_generated"] = len(log["tokens"])
        out["stats"] = dataclasses.asdict(eng.arena.stats)
        out["paging_stats"] = dataclasses.asdict(eng.paging.arena.stats)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    p.add_argument("--arch", default=ARCH, choices=list(registry.ARCHS),
                   help=f"the model (default {ARCH})")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth to N layers")
    p.add_argument("--reduced", action="store_true",
                   help="the reduced smoke config instead of full width")
    args = p.parse_args(argv)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = base.reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    lens = [24, 24, 16, 16, 8, 8, 4, 4]
    out = run(cfg, args.device, prompt_lens=lens, max_batch=len(lens),
              s_max=64, steps=8)
    print(f"{out['arch']} x{out['layers']} d_model {out['d_model']} on "
          f"{out['device']}: {len(lens)} requests, recovered in "
          f"{out['recover_s']:.3f} s, stages {out['stages']}")
    for key, what in (("cache", "cache vs twin"),
                      ("cache_vs_decode_twin", "every layer vs twin"),
                      ("cache_vs_prefill", "cache vs crash-free prefill")):
        if key in out:
            e = out[key]
            print(f"{what}: max abs err {e['max_abs_err']:.3e} over max "
                  f"|value| {e['max_abs']:.3e}; relative, by leaf: "
                  + ", ".join(f"{n} {r:.2e}" for n, r in
                              e["leaves"].items()))
    print(f"logits vs twin (relative): {out['logit_rel_err']}; "
          f"{out['distinct_tokens']} distinct of {out['tokens_generated']} "
          f"tokens generated")
    print(json.dumps({"flush": out["stats"]}))
    print("post-recovery generations identical to the uninterrupted twin")


if __name__ == "__main__":
    main()
