"""The reduced MoE archs, dbrx-132b (every layer MoE, top-4 of 16 cut to
top-2 of 4) and llama4-maverick-400b-a17b (dense and MoE layers
interleaved, a shared expert), served through both packages on the CPU
(their training: ``test_torch_moe_train.py``).

Parameters come from the reference's JAX init, scaled by 8 as
tests/test_torch_gemma.py scales them (so greedy tokens vary), and reach
the port through ``interop.params_from_numpy``. Prompts of 80 tokens are
longer than the reduced router group of 64 (one group of 80), and
128-token training sequences route in two groups. Tolerances: f32 logits
within 1e-4 and caches within 1e-5 of their largest |k|, |v| with greedy
tokens equal; the loss within 1e-5 relative and each gradient leaf
within 1e-4 of its own largest |grad|
(tests/test_torch_gemma_train.py's); the Trainer's losses within 1e-6
relative and its parameters within 1e-7; a resumed run bit for bit. The
bf16 case compares routing first (ids equal wherever the f32
k-th/(k+1)-th margin exceeds the bf16 error of the logits), then logits
within 5e-2 of the largest |logit| of the reference's f32 run.
``chip_smoke.py`` phases 4 and 17 run these archs on the card.
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
from repro_torch.models import moe as TM
from repro_torch.models.model import build as tbuild
from repro_torch.serve_recover import run

MOES = ("dbrx-132b", "llama4-maverick-400b-a17b")
LOSS_CHUNK = 64     # two chunks of the 128-token sequences


def _models(arch, dtype="float32", loss_chunk=LOSS_CHUNK):
    return (jbuild(jbase.reduced(jreg.get(arch)),
                   compute_dtype=getattr(jnp, dtype), loss_chunk=loss_chunk),
            tbuild(tbase.reduced(treg.get(arch)),
                   compute_dtype=getattr(torch, dtype),
                   loss_chunk=loss_chunk))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's init of the reduced ``arch``, scaled by 8, as
    numpy."""
    jm, _ = _models(arch)
    jp = jm.init_params(jax.random.PRNGKey(1))
    return jax.tree.map(lambda a: np.asarray(a * 8 if a.ndim >= 2 else a),
                        jp)


def _tree_err(got, want) -> float:
    """The largest difference of two cache trees over the largest |value|
    of ``want`` (the scaled weights make |k| and |v| reach 5-6)."""
    err, top = _tree_abs(got, want)
    return err / top


def _tree_abs(got, want):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        pairs = [_tree_abs(got[k], want[k]) for k in got]
        return max(e for e, _ in pairs), max(t for _, t in pairs)
    assert tuple(got.shape) == tuple(want.shape)
    want = np.asarray(want, np.float32)
    return (float(np.abs(got.float().numpy() - want).max()),
            float(np.abs(want).max()))


@pytest.mark.parametrize("arch", MOES)
def test_moe_configs_and_cache_specs_match_reference(arch):
    jm, tm = _models(arch)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.moe.router_group == 64 and tm.cfg.moe.n_experts == 4
    specs, want = tm.cache_specs(2, 96), jm.cache_specs(2, 96)
    for grp in specs:
        for pos in specs[grp]:
            assert sorted(specs[grp][pos]) == sorted(want[grp][pos])
            for name, t in specs[grp][pos].items():
                assert tuple(t.shape) == tuple(want[grp][pos][name].shape)
    shapes = {k: tuple(v.shape) for k, v in
              tm.param_specs()["blocks"][f"pos{len(tm.cfg.layer_pattern) - 1}"]
              ["moe"].items()}
    assert ("s_gate" in shapes) == (arch != "dbrx-132b")


@pytest.mark.parametrize("arch", MOES)
def test_moe_prefill_and_decode_match_reference(arch):
    """A prompt of 80 tokens (past the router group of 64), then eight
    decode steps: logits within 1e-4, caches within 1e-5 of their largest
    |k|, |v|, greedy tokens equal, and tokens that vary."""
    jm, tm = _models(arch)
    pn = _params(arch)
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    s_max = 96
    toks = np.random.default_rng(5).integers(0, 256, (2, 80))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        s_max=s_max)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_max=s_max)
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) < 1e-4
    assert _tree_err(tc, jc) < 1e-5
    tok = np.argmax(np.asarray(jl), -1)
    seen = set(tok.tolist())
    for pos in range(80, 88):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) < 1e-4
        assert _tree_err(tc, jc) < 1e-5
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.argmax(np.asarray(jl), -1))
        tok = np.argmax(np.asarray(jl), -1)
        seen |= set(tok.tolist())
    assert len(seen) > 3


def test_launch_serve_dbrx_crash_returns_zero(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    assert tserve.main(["--arch", "dbrx-132b", "--crash", "--device",
                        "cpu"]) == 0
    assert "[serve] recovered" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOES)
def test_moe_twin_recovery_against_prefill(arch, dtype, monkeypatch):
    """The engine's crash and re-prefill on a reduced MoE arch: prompts
    past the router group, so the re-prefill's groups drop assignments
    that decoding never drops.  The recovered caches equal a crash-free
    prefill of the same token logs and serve on with equal tokens; the
    decode-built twin is held on the first layer only and reported.  In
    bf16 (parameters and compute) within 2e-2, f32 within 1e-5 (caches)
    and 1e-4 (logits)."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    cfg = tbase.reduced(treg.get(arch))
    dt = getattr(torch, dtype)
    out = run(cfg, "cpu", prompt_lens=(100, 24), max_batch=3, s_max=160,
              steps=4, max_requests=16, compute_dtype=dt)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert out["dtype"] == dtype
    assert out["cache_vs_prefill"]["rel_err"] <= tol
    assert out["cache"]["rel_err"] <= tol
    assert out["logit_rel_err"]["after"] <= max(tol, 1e-4)
    assert out["reprefill_dropped"] > 0
    assert out["cache_vs_decode_twin"]["rel_err"] > out["cache"]["rel_err"]
    assert set(out["decode_twin"]) == {"same_tokens", "logit_rel_err"}


# ----------------------------------------------------------------- bf16

@pytest.mark.parametrize("arch", MOES)
def test_moe_bf16_prefill_and_decode(arch):
    """bf16 compute over the same parameters, held against the
    reference's f32 run (the reference's MoE does not run in bf16 on the
    CPU: XLA's CPU dot refuses bf16 x bf16 = f32 there).  Routing first:
    each MoE call's expert ids in bf16 equal the f32 run's wherever the
    f32 margin between the k-th and (k+1)-th logit exceeds the bf16
    error of the logits (their largest distance from the f32 logits);
    then a prefill of 80 tokens and four decode steps: logits within 5e-2
    of the largest |logit| of the reference's, greedy tokens equal
    wherever the reference's top-2 gap exceeds that tolerance."""
    jm, tm32 = _models(arch)
    tm16 = _models(arch, "bfloat16")[1]
    pn = _params(arch)
    jp, tp = jax.tree.map(jnp.asarray, pn), params_from_numpy(pn, "cpu")
    toks = np.random.default_rng(6).integers(0, 256, (2, 80))
    routes = []
    real = TM._route

    def spy(x, router, k):
        w, e = real(x, router, k)
        routes.append((torch.matmul(x.float(), router.float()), e))
        return w, e

    def serve(model, steps):
        """Prefill, then decode the reference's tokens; the logits."""
        out = []
        lg, c = model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              s_max=96)
        out.append(lg.float().numpy())
        for pos, tok in zip(range(80, 84), steps):
            lg, c = model.decode_step(tp, c, torch.from_numpy(tok), pos)
            out.append(lg.float().numpy())
        return out
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        s_max=96)
    want, fed = [np.asarray(jl)], []
    for pos in range(80, 84):
        fed.append(np.argmax(want[-1], -1))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(fed[-1], jnp.int32),
                                jnp.asarray(pos, jnp.int32))
        want.append(np.asarray(jl))
    TM._route = spy
    try:
        serve(tm32, fed)
        n32 = len(routes)
        got = serve(tm16, fed)
    finally:
        TM._route = real
    assert n32 == len(routes) - n32 > 0
    for (l32, e32), (l16, e16) in zip(routes[:n32], routes[n32:]):
        k = e32.shape[-1]
        srt = torch.sort(l32, -1, descending=True).values
        margin = srt[..., k - 1] - srt[..., k]
        clear = margin > (l16 - l32).abs().max()
        assert torch.equal(e16[clear], e32[clear])
    for w, g in zip(want, got):
        top = np.abs(w).max()
        assert np.abs(g - w).max() <= 5e-2 * top
        srt = np.sort(w, -1)
        clear = (srt[:, -1] - srt[:, -2]) > 5e-2 * top
        assert np.array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear])
