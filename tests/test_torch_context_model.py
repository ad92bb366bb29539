"""The context archs, llama-3.2-vision-90b (a gated cross-attention image
layer every fifth layer) and whisper-large-v3 (a bidirectional encoder
over audio frames, every decoder layer self- then cross-attending to
it), served through both packages on the CPU (their training:
``test_torch_context_train.py``).

Reduced configs (``repro/configs/base.py`` ``reduced``): context_seq and
encoder_seq 16, two encoder layers.  Parameters come from the
reference's JAX init, scaled by 8 as tests/test_torch_gemma.py scales
them (so greedy tokens vary), with every ``xgate`` set to 1: the
reference's init zeroes it, and ``tanh(0) = 0`` would shut the image
layers.  They reach the port through ``interop.params_from_numpy``.  The
context and the frames are N(0, 1) from a numpy seed.  Tolerances: f32
logits within 1e-4 of their largest |logit| and caches within 1e-5 of
their largest |value| (tests/test_torch_gemma.py's), greedy tokens
equal; a decode step against the longer prefill within 1e-4
(tests/test_arch_smoke.py's rule); bf16 logits within 5e-2 of the
largest |logit| of the reference's f32 run.  The engine feeds a context
of zeros, as the reference's engine does.
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
from repro.models.model import build as jbuild
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build as tbuild
from repro_torch.serve import engine as TE
from repro_torch.serve_recover import run

CONTEXTS = ("llama-3.2-vision-90b", "whisper-large-v3")
PROMPT, S_MAX = 12, 24


def _models(arch, dtype="float32", loss_chunk=512):
    return (jbuild(jbase.reduced(jreg.get(arch)),
                   compute_dtype=getattr(jnp, dtype), loss_chunk=loss_chunk),
            tbuild(tbase.reduced(treg.get(arch)),
                   compute_dtype=getattr(torch, dtype),
                   loss_chunk=loss_chunk))


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    """The reference's prefill (at ``S_MAX``) and decode_step under
    ``jax.jit``, compiled once per arch and shape."""
    jm, _ = _models(arch)
    return (jax.jit(functools.partial(jm.prefill, s_max=S_MAX)),
            jax.jit(jm.decode_step))


def _open_gates(path, a):
    """Every ``xgate`` leaf at 1 (see the module's docstring)."""
    if any(getattr(k, "key", None) == "xgate" for k in path):
        return np.ones_like(a)
    return a


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's init of the reduced ``arch``, weights scaled by 8,
    every ``xgate`` 1, as numpy."""
    jm, _ = _models(arch)
    jp = jm.init_params(jax.random.PRNGKey(1))
    jp = jax.tree.map(lambda a: np.asarray(a * 8 if a.ndim >= 2 else a), jp)
    return jax.tree_util.tree_map_with_path(_open_gates, jp)


def _context(cfg, batch, seed):
    """{"context" or "frames": (batch, C, d) N(0, 1) f32} for ``cfg``."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {"context": rng.standard_normal(
        (batch, cfg.context_seq, cfg.d_model)).astype(np.float32)}


def _batches(cfg, toks, ctx):
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             **{k: jnp.asarray(v) for k, v in ctx.items()}},
            {"tokens": torch.from_numpy(toks),
             **{k: torch.from_numpy(v) for k, v in ctx.items()}})


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()) / float(
        np.abs(want).max())


def _tree_rel(got, want) -> float:
    """The largest difference of two cache trees over the largest |value|
    of ``want``."""
    def walk(g, w):
        if isinstance(g, dict):
            assert sorted(g) == sorted(w)
            pairs = [walk(g[k], w[k]) for k in g]
            return max(e for e, _ in pairs), max(t for _, t in pairs)
        assert tuple(g.shape) == tuple(w.shape)
        w = np.asarray(w, np.float32)
        return float(np.abs(g.float().numpy() - w).max()), \
            float(np.abs(w).max())
    err, top = walk(got, want)
    return err / top


@pytest.mark.parametrize("arch", CONTEXTS)
def test_context_configs_and_specs_match_reference(arch):
    """Configs, parameter shapes (the encoder's included) and cache specs
    (the cross caches context_seq / encoder_seq long) equal the
    reference's."""
    jm, tm = _models(arch)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    want = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(jm.param_specs())[0]}
    got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
           jax.tree_util.tree_flatten_with_path(tm.param_specs())[0]}
    assert got == want
    assert any("enc_blocks" in k for k in got) == (jm.cfg.family == "audio")
    specs, jspecs = tm.cache_specs(2, S_MAX), jm.cache_specs(2, S_MAX)
    cross = 0
    for grp in specs:
        for pos in specs[grp]:
            assert sorted(specs[grp][pos]) == sorted(jspecs[grp][pos])
            for name, t in specs[grp][pos].items():
                assert tuple(t.shape) == tuple(jspecs[grp][pos][name].shape)
                cross += name == "xk"
    assert cross >= 1


@pytest.mark.parametrize("arch", CONTEXTS)
def test_context_prefill_and_decode_match_reference(arch):
    """A seeded context, a prompt of 12 tokens, then six decode steps:
    logits within 1e-4 and caches within 1e-5 of their largest values,
    greedy tokens equal and varying."""
    jm, tm = _models(arch)
    pn = _params(arch)
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    toks = np.random.default_rng(5).integers(0, 256, (2, PROMPT))
    jb, tb = _batches(tm.cfg, toks, _context(tm.cfg, 2, 6))
    prefill, decode = _jitted(arch)
    jl, jc = prefill(jp, jb)
    tl, tc = tm.prefill(tp, tb, s_max=S_MAX)
    assert _rel(tl, jl) < 1e-4
    assert _tree_rel(tc, jc) < 1e-5
    tok = np.argmax(np.asarray(jl), -1)
    seen = set(tok.tolist())
    for pos in range(PROMPT, PROMPT + 6):
        jl, jc = decode(jp, jc, jnp.asarray(tok, jnp.int32),
                        jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        assert _rel(tl, jl) < 1e-4
        assert _tree_rel(tc, jc) < 1e-5
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.argmax(np.asarray(jl), -1))
        tok = np.argmax(np.asarray(jl), -1)
        seen |= set(tok.tolist())
    assert len(seen) > 3


@pytest.mark.parametrize("arch", CONTEXTS)
def test_decode_matches_longer_prefill_in_both_packages(arch):
    """The reference's own rule (tests/test_arch_smoke.py): a prefill of
    n tokens and a decode step at n give the last logits of a prefill of
    n + 1, within 1e-4, in each package; and the port's within 1e-4 of
    the reference's."""
    jm, tm = _models(arch)
    pn = _params(arch)
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    toks = np.random.default_rng(8).integers(0, 256, (2, PROMPT + 1))
    ctx = _context(tm.cfg, 2, 9)
    jb, tb = _batches(tm.cfg, toks, ctx)
    jshort, tshort = _batches(tm.cfg, toks[:, :PROMPT], ctx)
    prefill, decode = _jitted(arch)
    jfull, _ = prefill(jp, jb)
    _, jkv = prefill(jp, jshort)
    jinc, _ = decode(jp, jkv, jnp.asarray(toks[:, PROMPT], jnp.int32),
                     jnp.asarray(PROMPT, jnp.int32))
    tfull, _ = tm.prefill(tp, tb, s_max=S_MAX)
    _, tkv = tm.prefill(tp, tshort, s_max=S_MAX)
    tinc, _ = tm.decode_step(tp, tkv, torch.from_numpy(toks[:, PROMPT]),
                             PROMPT)
    assert _rel(tinc, tfull.numpy()) < 1e-4
    np.testing.assert_allclose(np.asarray(jinc), np.asarray(jfull),
                               atol=1e-4 * float(np.abs(jfull).max()))
    assert _rel(tinc, jinc) < 1e-4


def _reference_decode(arch, jp, prompt, steps):
    """Greedy tokens and logits of one request through the reference
    model with a context of zeros, each step feeding the last token at
    its own position p - 1 (the port engine's convention)."""
    cfg = jbase.reduced(jreg.get(arch))
    prefill, decode = _jitted(arch)
    batch = {"tokens": jnp.asarray(prompt[None], jnp.int32)}
    if cfg.family == "audio":
        batch["frames"] = jnp.zeros((1, cfg.encoder_seq, cfg.d_model))
    else:
        batch["context"] = jnp.zeros((1, cfg.context_seq, cfg.d_model))
    log = [int(t) for t in prompt]
    _, kv = prefill(jp, batch)
    logits = []
    for _ in range(steps):
        lg, kv = decode(jp, kv, jnp.asarray([log[-1]], jnp.int32),
                        jnp.int32(len(log) - 1))
        logits.append(np.asarray(lg[0], np.float32))
        log.append(int(np.argmax(logits[-1])))
    return log[len(prompt):], logits


@pytest.mark.parametrize("arch", CONTEXTS)
def test_engine_with_zero_context_matches_reference(arch, tmp_path,
                                                    monkeypatch):
    """The port's engine prefills with a context of zeros, as the
    reference's engine does (``repro/serve/engine.py:216-223``): every
    step, before and after a crash and recovery, gives the reference
    model's tokens with zero contexts, and logits within 1e-4 of the
    largest |logit|; the cross caches stay zero and decode writes nothing
    back into them."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    _, tm = _models(arch)
    pn = _params(arch)
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    steps = 4
    prompts = {101: np.array([1, 2, 3, 4], np.int64),
               202: np.array([9, 8, 7], np.int64)}
    want = {rid: _reference_decode(arch, jp, pr, 3 * steps)
            for rid, pr in prompts.items()}
    eng = TE.ServingEngine(tm, tp, TE.EngineConfig(max_batch=2, s_max=S_MAX,
                                                   max_requests=16),
                           arena_path=str(tmp_path / "port"), device="cpu")
    for rid, pr in prompts.items():
        eng.add_request(rid, pr)
    copies = []
    real = torch.Tensor.copy_

    def spy(dst, src, *a, **kw):
        copies.append(tuple(dst.shape))
        return real(dst, src, *a, **kw)
    n = 0
    for phase in range(3):
        if phase == 2:
            eng.crash()
            eng.recover()
        for _ in range(steps):
            monkeypatch.setattr(torch.Tensor, "copy_", spy)
            got = eng.step()
            monkeypatch.setattr(torch.Tensor, "copy_", real)
            for rid, tok in got.items():
                toks, logits = want[rid]
                assert tok == toks[n], (rid, n)
                ref = logits[n]
                err = np.abs(eng.step_logits[rid].numpy() - ref).max()
                assert err <= 1e-4 * np.abs(ref).max(), (rid, n, err)
            n += 1
    cross = [t for grp in eng.cache.values() for c in grp.values()
             for name, t in c.items() if name in ("xk", "xv")]
    assert cross and not any(t.any() for t in cross)
    ctx_len = tm.cfg.encoder_seq if tm.cfg.family == "audio" \
        else tm.cfg.context_seq
    assert copies and not any(ctx_len in shp[1:3] for shp in copies)
    assert len({t for toks, _ in want.values() for t in toks}) > 3


@pytest.mark.parametrize("arch", CONTEXTS)
def test_context_twin_recovery(arch, monkeypatch):
    """The twin protocol (phase 15's rule) on the reduced context archs:
    the recovered caches, cross caches whole, within 1e-4 of the
    uninterrupted twin's, tokens equal, logits within 1e-4."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    cfg = tbase.reduced(treg.get(arch))
    out = run(cfg, "cpu", prompt_lens=(14, 9, 5), max_batch=3, s_max=32,
              steps=3, max_requests=16)
    assert out["cache"]["rel_err"] <= 1e-4
    assert out["logit_rel_err"]["after"] <= 1e-4
    assert out["engine_detail"]["prefill_groups"] == 2


@pytest.mark.parametrize("arch", CONTEXTS)
def test_launch_serve_context_crash_returns_zero(arch, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    assert tserve.main(["--arch", arch, "--crash", "--device", "cpu"]) == 0
    assert "[serve] recovered" in capsys.readouterr().out


def test_context_bf16_prefill_and_decode():
    """bf16 compute over the reduced whisper's parameters and a seeded
    context, held against the reference's f32 run: a prefill of 12 tokens
    and four decode steps, logits within 5e-2 of the largest |logit|,
    greedy tokens equal wherever the reference's top-2 gap exceeds that
    tolerance."""
    arch = "whisper-large-v3"
    jm, tm32 = _models(arch)
    tm16 = _models(arch, "bfloat16")[1]
    pn = _params(arch)
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    toks = np.random.default_rng(12).integers(0, 256, (2, PROMPT))
    jb, tb = _batches(tm16.cfg, toks, _context(tm16.cfg, 2, 13))
    jl, jc = jm.prefill(jp, jb, s_max=S_MAX)
    want, fed = [np.asarray(jl)], []
    for pos in range(PROMPT, PROMPT + 4):
        fed.append(np.argmax(want[-1], -1))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(fed[-1], jnp.int32),
                                jnp.asarray(pos, jnp.int32))
        want.append(np.asarray(jl))
    lg, c = tm16.prefill(tp, tb, s_max=S_MAX)
    assert c["blocks"]["pos0"]["xk"].dtype == torch.bfloat16
    got = [lg.float().numpy()]
    for pos, tok in zip(range(PROMPT, PROMPT + 4), fed):
        lg, c = tm16.decode_step(tp, c, torch.from_numpy(tok), pos)
        got.append(lg.float().numpy())
    for w, g in zip(want, got):
        top = np.abs(w).max()
        assert np.abs(g - w).max() <= 5e-2 * top
        srt = np.sort(w, -1)
        clear = (srt[:, -1] - srt[:, -2]) > 5e-2 * top
        assert np.array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear])
