"""The reduced xlstm-1.3b (one superblock of seven mLSTM layers and an
sLSTM layer, and an mLSTM layer after it; d_model 64, 4 heads, mLSTM dv
16 and dk 8, sLSTM dh 16, chunk 16) served through both packages on the
CPU (its training: ``test_torch_xlstm_train.py``; the mixers alone:
``test_torch_xlstm.py``).

Parameters are drawn by the port's seeded init, which keeps the
reference's rule (zeros for 0-d and 1-d leaves, ``min(0.02, fan_in **
-0.5) * N(0, 1)`` for the others), as numpy; the reference takes them as
they are and the port through ``interop.params_from_numpy``, so both
hold the same weights (the reference's own init of them costs about 20 s
on one core, and its draws are no more the reference's than these).
Tolerances: f32 logits within 1e-4 of the
largest |logit|, caches within 1e-5 of each leaf kind's largest |value|
(a kind is the layer base and the leaf name: ``mlstm.c`` apart from
``slstm.c``), greedy tokens equal; each layer's output within 1e-5.  The
bf16 case holds the port's bf16 logits against the reference's f32 run
no further than the reference's own bf16 run lies from it (the
reference's bf16 xLSTM runs under jit here).  The engine: a crashed and
recovered engine against its uninterrupted twin (``serve_recover.run``),
a one-token prompt, and ``serve_recover.cache_error``'s leaf kinds.
``chip_smoke.py`` phases 4 and 20 run this arch on the card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import backbone as JB
from repro.models.model import build as jbuild
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core.policy import (path_str, tree_flatten_with_path,
                                     tree_map)
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import backbone as TB
from repro_torch.models.model import build as tbuild
from repro_torch.serve import engine as TE
from repro_torch.serve_recover import cache_error, run

ARCH = "xlstm-1.3b"
TOL, CACHE_TOL = 1e-4, 1e-5
PROMPT = 32                  # two mLSTM chunks of 16
S_MAX = 48


def _models(dtype="float32", loss_chunk=512):
    return (jbuild(jbase.reduced(jreg.get(ARCH)),
                   compute_dtype=getattr(jnp, dtype), loss_chunk=loss_chunk),
            tbuild(tbase.reduced(treg.get(ARCH)),
                   compute_dtype=getattr(torch, dtype),
                   loss_chunk=loss_chunk))


@functools.lru_cache(maxsize=None)
def _reference(dtype="float32"):
    """The reference model's prefill(params, tokens) at S_MAX and
    decode_step(params, cache, tokens, pos), jitted."""
    jm = _models(dtype)[0]
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                              s_max=S_MAX))
    return prefill, jax.jit(jm.decode_step)


@functools.lru_cache(maxsize=None)
def _params():
    """The reduced xlstm's parameters from the port's seeded init, as
    numpy."""
    _, tm = _models()
    gen = torch.Generator()
    gen.manual_seed(1)
    return tree_map(lambda t: t.numpy(), tm.init_params(gen, "cpu"))


def _kinds(cfg) -> dict:
    """{(group, position): layer base} of the cache tree."""
    pattern, _, rem = cfg.pattern_plan()
    out = {("blocks", f"pos{i}"): t for i, t in enumerate(pattern)}
    out.update({("rem", f"rem{i}"): t for i, t in enumerate(rem)})
    return out


def _cache_ok(cfg, got, want) -> None:
    """Every leaf kind (layer base and leaf name) of two cache trees
    within CACHE_TOL of the kind's largest |value|."""
    errs = {}
    for (grp, pos), tag in _kinds(cfg).items():
        assert sorted(got[grp][pos]) == sorted(want[grp][pos])
        for name, t in got[grp][pos].items():
            w = np.asarray(want[grp][pos][name], np.float32)
            assert tuple(t.shape) == w.shape, (pos, name)
            e, m = errs.get((tag, name), (0.0, 0.0))
            errs[tag, name] = (max(e, float(np.abs(t.float().numpy()
                                                   - w).max())),
                               max(m, float(np.abs(w).max())))
    assert set(errs) == {("mlstm", n) for n in "cnm"} | {
        ("slstm", n) for n in "cnhm"}
    for kind, (e, m) in errs.items():
        assert e <= CACHE_TOL * m, (kind, e, m)


def test_xlstm_config_cache_specs_and_params_match_reference():
    """The config, cache shapes and dtypes, the parameter count, every
    parameter leaf's shape against the reference's ``param_specs``, and
    every xLSTM parameter leaf carried by ``params_from_numpy`` with its
    shape and values."""
    jm, tm = _models()
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.n_layers == 9 and tm.cfg.xlstm.chunk == 16
    specs, want = tm.cache_specs(2, 96), jm.cache_specs(2, 96)
    for grp in specs:
        for pos in specs[grp]:
            assert sorted(specs[grp][pos]) == sorted(want[grp][pos])
            for name, t in specs[grp][pos].items():
                w = want[grp][pos][name]
                assert tuple(t.shape) == tuple(w.shape)
                assert str(t.dtype).split(".")[-1] == str(w.dtype)
    assert tm.cfg.param_count() == jm.cfg.param_count()
    pn = _params()
    assert jax.tree.map(np.shape, pn) == jax.tree.map(
        lambda a: tuple(a.shape), JB.param_specs(jm.cfg))
    tp = params_from_numpy(pn, "cpu")
    seen = set()
    for path, t in tree_flatten_with_path(tp):
        name = path_str(path)
        want_leaf = pn
        for key in name.split("/"):
            want_leaf = want_leaf[key]
        assert tuple(t.shape) == want_leaf.shape and t.dtype == torch.float32
        assert np.array_equal(t.numpy(), want_leaf)
        seen.add(name.split("/")[-1])
    assert {"w_if", "b_if", "w_og", "wo", "w_in", "b_in", "r", "wq",
            "wk", "wv", "out_norm"} <= seen
    d, h = tm.cfg.d_model, tm.cfg.n_heads
    blk = tp["blocks"]
    assert tuple(blk["pos0"]["w_if"].shape[1:]) == (d, 2, h)
    assert tuple(blk["pos0"]["wo"].shape[1:]) == (h, 16, d)
    assert tuple(blk["pos7"]["w_in"].shape[1:]) == (d, 4, h, d // h)
    assert tuple(blk["pos7"]["r"].shape[1:]) == (4, h, d // h, d // h)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("tag", ["mlstm", "slstm"])
def test_xlstm_layer_matches_reference(tag, mode):
    """One layer of the reduced config (superblock 0's position 0 or 7)
    against the reference's ``apply_layer``: 32 tokens (two mLSTM
    chunks) in train and prefill mode, the new caches; in decode, one
    token on the reference's prefill caches."""
    jm, tm = _models()
    pos = "pos0" if tag == "mlstm" else "pos7"
    pn = jax.tree.map(lambda a: a[0], _params()["blocks"][pos])
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    x = np.random.default_rng(2).standard_normal(
        (2, PROMPT, tm.cfg.d_model)).astype(np.float32)
    if mode == "decode":
        _, jc = JB.apply_layer(jm.cfg, tag, jp, jnp.asarray(x),
                               mode="prefill", s_max=S_MAX)
        x1 = np.random.default_rng(3).standard_normal(
            (2, 1, tm.cfg.d_model)).astype(np.float32)
        jy, jc2 = JB.apply_layer(jm.cfg, tag, jp, jnp.asarray(x1),
                                 mode="decode", cache=jc,
                                 pos=jnp.asarray(PROMPT, jnp.int32))
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        ty, tc2 = TB.apply_layer(tm.cfg, tag, tp, torch.from_numpy(x1),
                                 mode="decode", cache=tc, pos=PROMPT)
    else:
        jy, jc2 = JB.apply_layer(jm.cfg, tag, jp, jnp.asarray(x), mode=mode,
                                 s_max=S_MAX)
        ty, tc2 = TB.apply_layer(tm.cfg, tag, tp, torch.from_numpy(x),
                                 mode=mode, s_max=S_MAX)
    top = float(np.abs(np.asarray(jy)).max())
    assert float(np.abs(ty.numpy() - np.asarray(jy)).max()) <= 1e-5 * top
    if mode == "train":
        assert jc2 is None and tc2 is None
    else:
        assert sorted(tc2) == sorted(jc2)
        for name, t in tc2.items():
            w = np.asarray(jc2[name])
            assert float(np.abs(t.numpy() - w).max()) <= \
                CACHE_TOL * float(np.abs(w).max()), name


def test_xlstm_prefill_and_decode_match_reference():
    """A prompt of 32 tokens (two chunks in every mLSTM layer), then eight
    greedy decode steps through both packages, f32: logits, caches and
    tokens; then ``test_arch_smoke``'s rule on the port, a prefill of 31
    tokens and a decode step at 31 against the prefill of 32, within 1e-4
    of the largest |logit|."""
    _, tm = _models()
    jprefill, jdecode = _reference()
    pn = _params()
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    toks = np.random.default_rng(5).integers(0, 256, (2, PROMPT))
    jl, jc = jprefill(jp, jnp.asarray(toks, jnp.int32))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_max=S_MAX)
    top = float(np.abs(np.asarray(jl)).max())
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= TOL * top
    _cache_ok(tm.cfg, tc, jc)
    tok = np.argmax(np.asarray(jl), -1)
    seen = set(tok.tolist())
    for pos in range(PROMPT, PROMPT + 8):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        top = float(np.abs(np.asarray(jl)).max())
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= TOL * top
        _cache_ok(tm.cfg, tc, jc)
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.argmax(np.asarray(jl), -1))
        tok = np.argmax(np.asarray(jl), -1)
        seen |= set(tok.tolist())
    assert len(seen) > 3
    full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                         s_max=S_MAX)
    _, kv = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :-1])},
                       s_max=S_MAX)
    inc, _ = tm.decode_step(tp, kv, torch.from_numpy(toks[:, -1]),
                            PROMPT - 1)
    assert float((inc - full).abs().max()) <= TOL * float(full.abs().max())


def test_xlstm_bf16_no_further_from_f32_than_reference():
    """bf16 compute over the same parameters: a prefill of 32 tokens and
    four decode steps fed the reference's f32 tokens.  The port's bf16
    logits lie no further from the reference's f32 run than the
    reference's own bf16 run does: their RMS difference over the run's
    logits, as a fraction of the largest |logit|, at most 1.1 times the
    reference's (the two bf16 runs round in other orders), and every
    step's largest difference within 1.5 times the reference's largest
    over the run.  (Not hymba's 5e-2: nine rounded recurrent layers put
    the reference's own bf16 run 2-6 % of the largest |logit| from its
    f32 run at these prompts.)"""
    pn = _params()
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    tm16 = _models("bfloat16")[1]
    toks = np.random.default_rng(6).integers(0, 256, (2, PROMPT))
    runs = {}
    for dtype in ("float32", "bfloat16"):
        prefill, decode = _reference(dtype)
        lg, c = prefill(jp, jnp.asarray(toks, jnp.int32))
        out = [np.asarray(lg, np.float32)]
        for pos in range(PROMPT, PROMPT + 4):
            # both dtypes take the f32 run's greedy tokens
            tok = np.argmax(runs["float32"][pos - PROMPT] if runs else
                            out[-1], -1)
            lg, c = decode(jp, c, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(pos, jnp.int32))
            out.append(np.asarray(lg, np.float32))
        runs[dtype] = out
    want = runs["float32"]
    lg, c = tm16.prefill(tp, {"tokens": torch.from_numpy(toks)},
                         s_max=S_MAX)
    got = [lg.float().numpy()]
    for pos in range(PROMPT, PROMPT + 4):
        lg, c = tm16.decode_step(tp, c, torch.from_numpy(
            np.argmax(want[pos - PROMPT], -1)), pos)
        got.append(lg.float().numpy())
    top = max(np.abs(w).max() for w in want)

    def rms(run):
        return float(np.sqrt(np.mean([np.mean((r - w) ** 2)
                                      for r, w in zip(run, want)])))
    ours, theirs = rms(got) / top, rms(runs["bfloat16"]) / top
    assert ours <= 1.1 * theirs, (ours, theirs)
    worst = max(np.abs(r - w).max() / np.abs(w).max()
                for r, w in zip(runs["bfloat16"], want))
    for w, g in zip(want, got):
        assert np.abs(g - w).max() <= 1.5 * worst * np.abs(w).max()


def test_large_gains_part_prefill_and_decode_in_both_packages():
    """With the weights of two or more axes scaled by 16 (gate
    pre-activations as large as the published widths' 2048-term sums
    make them), a prefill of 65 tokens and a prefill of 64 then a decode
    step give the first mLSTM layer (fed by the embedding alone) the same
    state within 1e-4 in both packages, while the sLSTM layer's ``c`` and
    ``n`` part by more than 5e-4 in the reference itself: the chunk's
    log-decay sums and the step's products round differently, and the
    exponential gates carry that through the sequence and amplify it
    through the depth.  The port parts no further than 3x the reference.
    So a full-width engine is held against a crash-free prefill, its
    decode-built twin on the first layer (``serve_recover``'s prefill
    rule)."""
    jm, tm = _models()
    pn = jax.tree.map(lambda a: a * 16.0 if a.ndim >= 2 else a, _params())
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    n = 64
    toks = np.random.default_rng(1).integers(1, 256, (1, n + 1))
    parts = {}
    for name, m, p, t, pos in (
            ("ref", jm, jp, jnp.asarray(toks, jnp.int32),
             jnp.asarray(n, jnp.int32)),
            ("port", tm, tp, torch.from_numpy(toks), n)):
        _, full = m.prefill(p, {"tokens": t}, s_max=n + 2)
        _, kv = m.prefill(p, {"tokens": t[:, :n]}, s_max=n + 2)
        _, kv = m.decode_step(p, kv, t[:, n], pos)
        parts[name] = {}
        for layer in ("pos0", "pos7"):
            for leaf, got in kv["blocks"][layer].items():
                want = np.array(full["blocks"][layer][leaf])
                parts[name][layer, leaf] = float(
                    np.abs(np.array(got) - want).max() / np.abs(want).max())
    for name, got in parts.items():
        assert max(e for (lay, _), e in got.items() if lay == "pos0") \
            <= 1e-4, (name, got)
        assert got["pos7", "c"] > 5e-4 and got["pos7", "n"] > 5e-4, \
            (name, got)
    for key, e in parts["port"].items():
        if key[0] == "pos7":
            assert e <= 3 * parts["ref"][key], (key, parts)


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_twin_recovery(dtype, monkeypatch):
    """The twin protocol on the reduced xlstm: prompts of 20 (one chunk,
    the fallback), 33 (two chunks and a token) and 1, a crash after eight
    steps, the re-prefill, four more.  ``run`` holds the xLSTM arch by the
    prefill rule (the recovered caches against a crash-free prefill of
    the same logs, the decode-built twin on its first layer: at full
    width they part past it); at this size the decode-built twin holds
    on every layer too.  Every recurrent leaf kind within 1e-5 of its
    largest |value| in f32 (2e-2 in bf16), against the prefill and
    against the twin; tokens equal the prefill engine's, and the twin's
    too."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    cfg = tbase.reduced(treg.get(ARCH))
    dt = getattr(torch, dtype)
    out = run(cfg, "cpu", prompt_lens=(20, 33, 1), max_batch=3, s_max=56,
              steps=4, max_requests=16, compute_dtype=dt)
    tol = CACHE_TOL if dtype == "float32" else 2e-2
    assert set(out["cache"]["leaves"]) == {"mlstm.c", "mlstm.n", "mlstm.m"}
    for key in ("cache_vs_decode_twin", "cache_vs_prefill"):
        leaves = out[key]["leaves"]
        assert set(leaves) == {"mlstm.c", "mlstm.n", "mlstm.m", "slstm.c",
                               "slstm.n", "slstm.h", "slstm.m"}
        assert max(leaves.values()) <= tol, (key, leaves)
    assert out["logit_rel_err"]["after"] <= max(tol, TOL)
    # the four steps after the recovery serve three slots
    assert out["decode_twin"]["same_tokens"] == 4 * 3
    assert out["decode_twin"]["logit_rel_err"] <= max(tol, TOL)
    assert out["distinct_tokens"] > 3


def test_one_token_prompt_seats_zero_caches(tmp_path):
    """A one-token prompt prefills nothing: its slot's caches are the zero
    caches ``init_cache`` gives (m too: the reference's initial
    stabilizer is 0), even where an earlier request left its own, and
    its first step's logits equal a prefill of that token."""
    _, tm = _models()
    tp = params_from_numpy(_params(), "cpu")
    eng = TE.ServingEngine(tm, tp, TE.EngineConfig(max_batch=1, s_max=16,
                                                   max_requests=8),
                           str(tmp_path / "e"), device="cpu")
    eng.add_request(1, np.arange(1, 9))
    eng.step()
    eng.finish_request(1)
    eng.add_request(2, np.array([7]))
    leaves = tree_flatten_with_path(eng.cache)
    assert {path_str(p).split("/")[-1] for p, _ in leaves} == {
        "c", "n", "m", "h"}
    assert all(not t.any() for _, t in leaves)
    eng.step()
    want, _ = tm.prefill(tp, {"tokens": torch.tensor([[7]])}, s_max=16)
    top = float(want.abs().max())
    assert float((eng.step_logits[2] - want[0]).abs().max()) <= TOL * top


def test_cache_error_keeps_leaf_kinds_apart_and_states_whole(tmp_path):
    """Two engines with the same request of 3 tokens (the caches hold 2),
    one with an entry of head 3 (past the log's length: a ring over token
    positions would cut heads 2 and 3 away) moved in superblock 0's first
    mLSTM ``c`` by 2e-3 of the largest |mlstm.c| and in its sLSTM ``c`` by
    1e-3 of the largest |slstm.c|.  ``cache_error`` sees both, whole, each
    against its own kind's largest |value|: ``mlstm.c`` reads 2e-3 (one
    shared ``c`` kind would hold it against the sLSTM's larger values and
    read under 1e-3) and ``slstm.c`` 1e-3."""
    _, tm = _models()
    tp = params_from_numpy(_params(), "cpu")
    ec = TE.EngineConfig(max_batch=2, s_max=16, max_requests=8)
    a, b = (TE.ServingEngine(tm, tp, ec, str(tmp_path / n), device="cpu")
            for n in ("a", "b"))
    for e in (a, b):
        e.add_request(5, np.array([3, 9, 4]))
    slot = int(np.flatnonzero(a.slot_rid == 5)[0])
    # each kind's largest |c|, over its layers (the remainder's too)
    kinds = {n: TB.parse_tag(t)[0] for n, t in _kinds(tm.cfg).items()}
    tops = {}
    for (grp, pos), base in kinds.items():
        top = float(b.cache[grp][pos]["c"].abs().max())
        tops[base] = max(tops.get(base, 0.0), top)
    for pos, name, frac, at in (("pos0", "mlstm", 2e-3, (3, 2, 5)),
                                ("pos7", "slstm", 1e-3, (3, 5))):
        a.cache["blocks"][pos]["c"][(0, slot) + at] += frac * tops[name]
    assert tops["slstm"] > 2 * tops["mlstm"]
    err = cache_error(a, b, [slot])
    assert abs(err["leaves"]["mlstm.c"] - 2e-3) < 2e-5
    assert abs(err["leaves"]["slstm.c"] - 1e-3) < 1e-5
    assert err["leaves"]["mlstm.n"] == err["leaves"]["slstm.h"] == 0.0
    assert err["rel_err"] == err["leaves"]["mlstm.c"]


def test_launch_serve_xlstm_crash_returns_zero(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    assert tserve.main(["--arch", ARCH, "--crash", "--device", "cpu"]) == 0
    assert "[serve] recovered" in capsys.readouterr().out
