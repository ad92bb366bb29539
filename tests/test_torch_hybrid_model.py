"""The reduced hymba-1.5b (one superblock of a full-attention and seven
sliding-window hybrid layers, and a full one after it; d_model 64, 4
heads, window 8, SSM state 4) served through both packages on the CPU
(its training: ``test_torch_hybrid_train.py``).

Parameters come from the reference's JAX init, every matrix but
``a_log`` scaled by 4 (so greedy tokens vary), and reach the port
through ``interop.params_from_numpy``.  Tolerances: f32 logits within
1e-4, caches within 1e-5 of each leaf's largest |value| (``k``, ``v``,
the ``ssm`` state, the ``conv`` tail), greedy tokens equal; each hybrid
layer's output within 1e-5.  The bf16 case holds the port's bf16 logits
against the reference's f32 run no further than the reference's own bf16
run lies from it (the reference's bf16 hybrid runs under jit here).
The engine: a crashed and recovered engine against its uninterrupted
twin (``serve_recover.run``: ``ssm`` and ``conv`` within 1e-5, tokens
equal), and the parent's rule, a prefill of the whole log with the last
token fed again, which moves a recurrent state by more than that.
``chip_smoke.py`` phases 4 and 19 run this arch on the card.
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
from repro_torch.core.policy import path_str, tree_flatten_with_path
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import backbone as TB
from repro_torch.models.model import build as tbuild
from repro_torch.serve import engine as TE
from repro_torch.serve_recover import cache_error, prompts_for, run

ARCH = "hymba-1.5b"
SCALE = 4.0
TOL, CACHE_TOL = 1e-4, 1e-5


def _models(dtype="float32", loss_chunk=512):
    return (jbuild(jbase.reduced(jreg.get(ARCH)),
                   compute_dtype=getattr(jnp, dtype), loss_chunk=loss_chunk),
            tbuild(tbase.reduced(treg.get(ARCH)),
                   compute_dtype=getattr(torch, dtype),
                   loss_chunk=loss_chunk))


@functools.lru_cache(maxsize=None)
def _reference(dtype="float32"):
    """The reference model's prefill(params, tokens, s_max) and
    decode_step(params, cache, tokens, pos), jitted."""
    jm = _models(dtype)[0]
    prefill = jax.jit(lambda p, t, s_max: jm.prefill(p, {"tokens": t},
                                                     s_max=s_max),
                      static_argnums=2)
    return prefill, jax.jit(jm.decode_step)


@functools.lru_cache(maxsize=None)
def _params():
    """The reference's init of the reduced hymba, every leaf of two or
    more axes but ``a_log`` scaled by SCALE, as numpy."""
    jm, _ = _models()
    jp = jm.init_params(jax.random.PRNGKey(1))

    def scale(path, a):
        name = jax.tree_util.keystr(path)
        big = a.ndim >= 2 and "a_log" not in name
        return np.asarray(a * SCALE if big else a)
    return jax.tree_util.tree_map_with_path(scale, jp)


def _leaf_errs(got, want, out=None) -> dict:
    """{leaf name: (max abs difference, max |want|)} over two cache
    trees."""
    out = {} if out is None else out
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            if isinstance(got[k], dict):
                _leaf_errs(got[k], want[k], out)
            else:
                w = np.asarray(want[k], np.float32)
                assert tuple(got[k].shape) == w.shape, k
                e, m = out.get(k, (0.0, 0.0))
                out[k] = (max(e, float(np.abs(got[k].float().numpy()
                                              - w).max())),
                          max(m, float(np.abs(w).max())))
    return out


def _cache_ok(got, want) -> None:
    errs = _leaf_errs(got, want)
    assert set(errs) == {"k", "v", "ssm", "conv"}
    for name, (e, m) in errs.items():
        assert e <= CACHE_TOL * m, (name, e, m)


def test_hybrid_config_and_cache_specs_match_reference():
    jm, tm = _models()
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.n_layers == 9 and tm.cfg.window == 8
    specs, want = tm.cache_specs(2, 96), jm.cache_specs(2, 96)
    for grp in specs:
        for pos in specs[grp]:
            assert sorted(specs[grp][pos]) == sorted(want[grp][pos])
            for name, t in specs[grp][pos].items():
                w = want[grp][pos][name]
                assert tuple(t.shape) == tuple(w.shape)
                assert str(t.dtype).split(".")[-1] == str(w.dtype)
    assert tm.cfg.param_count() == jm.cfg.param_count()


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("tag", ["hybrid:full", "hybrid:local"])
def test_hybrid_layer_matches_reference(tag, mode):
    """One hybrid layer of the reduced config (superblock 0's position 0
    or 1) against the reference's ``apply_layer``: 13 tokens (past the
    window of 8) in train and prefill mode, the new caches; in decode,
    one token at position 13 on the reference's prefill caches."""
    jm, tm = _models()
    pos = "pos0" if tag == "hybrid:full" else "pos1"
    pn = jax.tree.map(lambda a: a[0], _params()["blocks"][pos])
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    x = np.random.default_rng(2).standard_normal(
        (2, 13, tm.cfg.d_model)).astype(np.float32)
    if mode == "decode":
        _, jc = JB.apply_layer(jm.cfg, tag, jp, jnp.asarray(x),
                               mode="prefill", s_max=16)
        x1 = np.random.default_rng(3).standard_normal(
            (2, 1, tm.cfg.d_model)).astype(np.float32)
        jy, jc2 = JB.apply_layer(jm.cfg, tag, jp, jnp.asarray(x1),
                                 mode="decode", cache=jc,
                                 pos=jnp.asarray(13, jnp.int32))
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        ty, tc2 = TB.apply_layer(tm.cfg, tag, tp, torch.from_numpy(x1),
                                 mode="decode", cache=tc, pos=13)
    else:
        jy, jc2 = JB.apply_layer(jm.cfg, tag, jp, jnp.asarray(x), mode=mode,
                                 s_max=16)
        ty, tc2 = TB.apply_layer(tm.cfg, tag, tp, torch.from_numpy(x),
                                 mode=mode, s_max=16)
    top = float(np.abs(np.asarray(jy)).max())
    assert float(np.abs(ty.numpy() - np.asarray(jy)).max()) <= 1e-5 * top
    if mode == "train":
        assert jc2 is None and tc2 is None
    else:
        _cache_ok(tc2, jc2)


def _serve_both(prompt_len: int, steps: int, s_max: int = 48):
    """Prefill of two prompts, then ``steps`` greedy decode steps through
    both packages, f32: each step's logits must agree within 1e-4 of the
    largest |logit|, the caches within CACHE_TOL, the tokens exactly.
    Returns the tokens seen."""
    _, tm = _models()
    jprefill, jdecode = _reference()
    pn = _params()
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    toks = np.random.default_rng(5).integers(0, 256, (2, prompt_len))
    jl, jc = jprefill(jp, jnp.asarray(toks, jnp.int32), s_max)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_max=s_max)
    top = float(np.abs(np.asarray(jl)).max())
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= TOL * top
    _cache_ok(tc, jc)
    tok = np.argmax(np.asarray(jl), -1)
    seen = set(tok.tolist())
    for pos in range(prompt_len, prompt_len + steps):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        top = float(np.abs(np.asarray(jl)).max())
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= TOL * top
        _cache_ok(tc, jc)
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.argmax(np.asarray(jl), -1))
        tok = np.argmax(np.asarray(jl), -1)
        seen |= set(tok.tolist())
    return seen


@pytest.mark.parametrize("prompt_len", [5, 20])
def test_hybrid_prefill_and_decode_match_reference(prompt_len):
    """A prompt shorter than the window (5) and one that wraps the local
    layers' ring of 8 (20), then eight decode steps past it."""
    seen = _serve_both(prompt_len, 8)
    assert len(seen) > 3


def test_hybrid_decode_matches_prefill():
    """``test_arch_smoke``'s rule on the port: a prefill of 11 tokens and a
    decode step at 11 against the prefill of 12, within 1e-4 of the
    largest |logit| (the reference's own tolerance there), and the two
    packages' incremental logits within 1e-4 of each other."""
    jm, tm = _models()
    pn = _params()
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    toks = np.random.default_rng(9).integers(0, 256, (2, 12))
    full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_max=16)
    _, kv = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :11])},
                       s_max=16)
    inc, _ = tm.decode_step(tp, kv, torch.from_numpy(toks[:, 11]), 11)
    top = float(full.abs().max())
    assert float((inc - full).abs().max()) <= TOL * top
    _, jkv = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :11], jnp.int32)},
                        s_max=16)
    jinc, _ = jm.decode_step(jp, jkv, jnp.asarray(toks[:, 11], jnp.int32),
                             jnp.asarray(11, jnp.int32))
    assert float(np.abs(inc.numpy() - np.asarray(jinc)).max()) <= TOL * top


def test_hybrid_bf16_no_further_from_f32_than_reference():
    """bf16 compute over the same parameters: a prefill of 20 tokens and
    four decode steps fed the reference's f32 tokens, for two prompt
    draws.  The port's bf16 logits lie no further from the reference's
    f32 run than the reference's own bf16 run does: their RMS difference
    over the run's logits, as a fraction of the largest |logit|, at most
    1.1 times the reference's (the two bf16 runs round in other orders:
    the flash kernel scales q in f32, so a step's largest difference
    trades places between them; the mamba branch is the reference's bit
    for bit), and every step's largest within 5e-2 (chip_smoke's
    FLASH_PREFILL_TOL)."""
    pn = _params()
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    tm16 = _models("bfloat16")[1]
    for seed in (6, 7):
        toks = np.random.default_rng(seed).integers(0, 256, (2, 20))
        runs = {}
        for dtype in ("float32", "bfloat16"):
            prefill, decode = _reference(dtype)
            lg, c = prefill(jp, jnp.asarray(toks, jnp.int32), 32)
            out = [np.asarray(lg, np.float32)]
            for pos in range(20, 24):
                # both dtypes take the f32 run's greedy tokens
                tok = np.argmax(runs["float32"][pos - 20] if runs else
                                out[-1], -1)
                lg, c = decode(jp, c, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(pos, jnp.int32))
                out.append(np.asarray(lg, np.float32))
            runs[dtype] = out
        want = runs["float32"]
        lg, c = tm16.prefill(tp, {"tokens": torch.from_numpy(toks)},
                             s_max=32)
        got = [lg.float().numpy()]
        for pos in range(20, 24):
            lg, c = tm16.decode_step(tp, c, torch.from_numpy(
                np.argmax(want[pos - 20], -1)), pos)
            got.append(lg.float().numpy())
        top = max(np.abs(w).max() for w in want)

        def rms(run):
            return float(np.sqrt(np.mean([np.mean((r - w) ** 2)
                                          for r, w in zip(run, want)])))
        ours, theirs = rms(got) / top, rms(runs["bfloat16"]) / top
        assert ours <= 1.1 * theirs, (seed, ours, theirs)
        for w, g in zip(want, got):
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max()


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_twin_recovery(dtype, monkeypatch):
    """The twin protocol on the reduced hymba: prompts past the window,
    a crash after eight steps, the re-prefill, eight more.  The recovered
    ``ssm`` state and ``conv`` tail, and the K/V caches, equal the
    uninterrupted twin's within 1e-5 of their largest |value| in f32
    (2e-2 in bf16), tokens equal."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    cfg = tbase.reduced(treg.get(ARCH))
    dt = getattr(torch, dtype)
    out = run(cfg, "cpu", prompt_lens=(20, 13, 1), max_batch=3, s_max=48,
              steps=4, max_requests=16, compute_dtype=dt)
    tol = CACHE_TOL if dtype == "float32" else 2e-2
    leaves = out["cache"]["leaves"]
    assert set(leaves) == {"k", "v", "hybrid.ssm", "hybrid.conv"}
    assert max(leaves.values()) <= tol, leaves
    assert out["logit_rel_err"]["after"] <= max(tol, TOL)
    assert out["distinct_tokens"] > 3


class _ParentRule(TE.ServingEngine):
    """The parent's engine rule: admission and recovery prefill the whole
    log (the last token included), and the step feeds that token again."""

    def _prefill_slots(self, slots, tokens):
        n = torch.as_tensor(tokens).shape[1] + 1
        super()._prefill_slots(slots, self.tok_region.read_at(
            slots, slice(0, n)))


def _recovered_vs_twin(engine_cls, tmp_path):
    """Two engines of ``engine_cls`` on the reduced hymba (f32, the scaled
    reference parameters): two requests, six steps, one crashed and
    recovered; ``cache_error`` of the recovered caches against the
    twin's, then the next three steps' tokens of each."""
    _, tm = _models()
    tp = params_from_numpy(_params(), "cpu")
    ec = TE.EngineConfig(max_batch=2, s_max=48, max_requests=16)
    tmp_path.mkdir()
    engines = [engine_cls(tm, tp, ec, str(tmp_path / n), device="cpu")
               for n in ("twin", "crashed")]
    for e in engines:
        for rid, p in zip((101, 202), prompts_for((20, 9), 256, 4)):
            e.add_request(rid, p)
        for _ in range(6):
            e.step()
    twin, eng = engines
    eng.crash()
    eng.recover()
    live = np.flatnonzero(eng.slot_rid >= 0)
    err = cache_error(eng, twin, live)
    return err, [twin.step() for _ in range(3)], [eng.step()
                                                  for _ in range(3)]


def test_recovered_state_equals_twin_where_parent_rule_drifts(tmp_path):
    """The engine's rule (the caches hold every logged token but the last)
    gives a recovered ``ssm`` state equal to the uninterrupted twin's
    within 1e-5 and the twin's next tokens.  Under the parent's rule the
    twin's state took the prompt's last token twice and the recovered
    one the log's last token once more than the twin: the states part by
    more than a hundred times that tolerance."""
    err, want, got = _recovered_vs_twin(TE.ServingEngine, tmp_path / "new")
    assert err["leaves"]["hybrid.ssm"] <= CACHE_TOL
    assert err["leaves"]["hybrid.conv"] <= CACHE_TOL
    assert got == want
    old, _, _ = _recovered_vs_twin(_ParentRule, tmp_path / "old")
    assert old["leaves"]["hybrid.ssm"] > 100 * CACHE_TOL, old["leaves"]


def test_one_token_prompt_seats_zero_caches(tmp_path):
    """A one-token prompt prefills nothing: its slot's caches are the zero
    caches ``init_cache`` gives, even where an earlier request left its
    own, and its first step's logits equal a prefill of that token."""
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
        "k", "v", "ssm", "conv"}
    assert all(not t.any() for _, t in leaves)
    eng.step()
    want, _ = tm.prefill(tp, {"tokens": torch.tensor([[7]])}, s_max=16)
    top = float(want.abs().max())
    assert float((eng.step_logits[2] - want[0]).abs().max()) <= TOL * top


def test_launch_serve_hymba_crash_returns_zero(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    assert tserve.main(["--arch", ARCH, "--crash", "--device", "cpu"]) == 0
    assert "[serve] recovered" in capsys.readouterr().out
