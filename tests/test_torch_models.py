"""repro_torch model layers, attention and the prefill/decode programs vs
the JAX reference, on the CPU in f32.

Inputs are drawn with numpy from a seed and handed to both packages; the
reference's parameters reach the port through ``interop.params_from_numpy``
so both compute the same function.  Tolerances: 2e-5 for single layers
(f32 summation order), f32 2e-5 / bf16 2e-2 for attention against the
Pallas kernel in interpret mode (the reference's own kernel tests), 1e-4
on logits and 1e-5 on caches through the whole reduced model.  On the CPU
``blockwise_attention`` runs ``flash_attention_plain``; the kernel is held
to the same plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import backbone as JB
from repro.models import layers as JL
from repro.models.model import build as jbuild
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core.policy import tree_map
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import backbone as TB
from repro_torch.models import layers as TL
from repro_torch.models.model import build as tbuild

TOL = 2e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(
        want, np.float32), atol=tol, rtol=tol)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ layers

def _layer_cases():
    """name -> fn(rng) returning (port result, reference result)."""
    def norms(rng):
        x, g, b = _rand(rng, 2, 5, 32), _rand(rng, 32), _rand(rng, 32)
        return (torch.cat([TL.rms_norm(torch.from_numpy(x),
                                       torch.from_numpy(g)),
                           TL.layer_norm(torch.from_numpy(x),
                                         torch.from_numpy(g),
                                         torch.from_numpy(b))]),
                np.concatenate([JL.rms_norm(x, g), JL.layer_norm(x, g, b)]))

    def rope(rng):
        xs = (_rand(rng, 2, 6, 3, 16), _rand(rng, 2, 6, 2, 3, 16))
        pos = (np.arange(6), np.arange(6) + 2040)
        return (torch.cat([TL.apply_rope(torch.from_numpy(x),
                                         torch.from_numpy(p),
                                         500000.0).reshape(-1)
                           for x in xs for p in pos]),
                np.concatenate([np.asarray(JL.apply_rope(
                    x, jnp.asarray(p), 500000.0)).reshape(-1)
                    for x in xs for p in pos]))

    def mlp(rng):
        x, wg, wu = _rand(rng, 2, 3, 32), _rand(rng, 32, 48, scale=0.2), \
            _rand(rng, 32, 48, scale=0.2)
        wd = _rand(rng, 48, 32, scale=0.2)
        t = [torch.from_numpy(a) for a in (x, wg, wu, wd)]
        return (torch.cat([TL.gated_mlp(*t, act) for act in ("silu",
                                                              "gelu")]),
                np.concatenate([JL.gated_mlp(x, wg, wu, wd, act)
                                for act in ("silu", "gelu")]))

    def qkv(rng):
        x = _rand(rng, 2, 5, 32)
        w = {k: _rand(rng, 32, h, 8, scale=0.2)
             for k, h in (("wq", 4), ("wk", 2), ("wv", 2))}
        nq, nk = _rand(rng, 8), _rand(rng, 8)
        pos = np.arange(5)
        jp = JL.AttnParams(**w, wo=None, q_norm=nq, k_norm=nk)
        tp = TL.AttnParams(**{k: torch.from_numpy(v) for k, v in w.items()},
                           wo=None, q_norm=torch.from_numpy(nq),
                           k_norm=torch.from_numpy(nk))
        got = TL.project_qkv(torch.from_numpy(x), tp, 2,
                             positions=torch.from_numpy(pos), theta=1e4)
        want = JL.project_qkv(x, jp, 2, positions=jnp.asarray(pos),
                              theta=1e4)
        return (torch.cat([t.reshape(-1) for t in got]),
                np.concatenate([np.asarray(a).reshape(-1) for a in want]))

    def attention(rng):
        q, k, v = _rand(rng, 2, 24, 2, 3, 16), _rand(rng, 2, 24, 2, 16), \
            _rand(rng, 2, 24, 2, 16)
        t = [torch.from_numpy(a) for a in (q, k, v)]
        return (torch.cat([TL.blockwise_attention(*t, causal=c).reshape(-1)
                           for c in (True, False)]),
                np.concatenate([np.asarray(JL.blockwise_attention(
                    q, k, v, causal=c, q_block=8, kv_block=8)).reshape(-1)
                    for c in (True, False)]))

    def decode(rng):
        q, kc, vc = _rand(rng, 2, 1, 2, 3, 16), _rand(rng, 2, 10, 2, 16), \
            _rand(rng, 2, 10, 2, 16)
        kvpos = np.array([8, 9, 10, 11, 12, -1, 6, 7, 4, 5])
        got, want = [], []
        for kw in ({}, {"window": 3}, {"softcap": 2.0}):
            got.append(TL.decode_attention(
                *[torch.from_numpy(a) for a in (q, kc, vc, kvpos)], 11,
                **kw).reshape(-1))
            want.append(np.asarray(JL.decode_attention(
                q, kc, vc, jnp.asarray(kvpos), jnp.asarray(11),
                **kw)).reshape(-1))
        return torch.cat(got), np.concatenate(want)

    def out_proj(rng):
        a, wo = _rand(rng, 2, 5, 2, 3, 8), _rand(rng, 6, 8, 32, scale=0.3)
        return (TL.attn_out(torch.from_numpy(a), torch.from_numpy(wo)),
                JL.attn_out(a, wo))

    def ring(rng):
        cache, val = _rand(rng, 2, 8, 2, 4), _rand(rng, 2, 1, 2, 4)
        got = [TL.ring_slot_positions(p, 8).float() for p in (3, 8, 21)]
        got += [TL.ring_write(torch.from_numpy(cache), torch.from_numpy(val),
                              p, 8).reshape(-1) for p in (3, 21)]
        want = [np.asarray(JL.ring_slot_positions(jnp.asarray(p), 8),
                           np.float32) for p in (3, 8, 21)]
        want += [np.asarray(JL.ring_write(cache, val, jnp.asarray(p),
                                          8)).reshape(-1) for p in (3, 21)]
        return torch.cat(got), np.concatenate(want)

    def seat(rng):
        k = _rand(rng, 2, 11, 2, 4)
        return (torch.cat([TB._seat_cache(torch.from_numpy(k), c).reshape(-1)
                           for c in (16, 11, 4)]),
                np.concatenate([np.asarray(JB._seat_cache(k, c)).reshape(-1)
                                for c in (16, 11, 4)]))

    return {f.__name__: f for f in (norms, rope, mlp, qkv, attention, decode,
                                    out_proj, ring, seat)}


@pytest.mark.parametrize("case", sorted(_layer_cases()))
def test_layer_matches_reference(case):
    got, want = _layer_cases()[case](np.random.default_rng(len(case)))
    _close(got, want)


# ------------------------------------------------------- flash attention

@pytest.mark.parametrize("h,sq,skv,d,bq,bk,causal", [
    (2, 256, 256, 64, 128, 128, True),
    (3, 128, 128, 128, 64, 32, True),
    (1, 256, 512, 64, 128, 128, False),
    (4, 64, 64, 32, 64, 64, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(h, sq, skv, d, bq, bk, causal, dtype):
    rng = np.random.default_rng(h * sq + d)
    q, k, v = (_rand(rng, h, s, d) for s in (sq, skv, skv))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jflash(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
                  block_q=bq, block_k=bk, interpret=True)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          causal=causal)
    assert got.dtype == tdt and got.shape == (h, sq, d)
    _close(got, np.asarray(want, np.float32),
           2e-2 if dtype == "bfloat16" else 2e-5)
    assert launch_counts()["flash_attention"] == 0


def test_flash_plain_gqa_matches_repeated_layout():
    """Grouped K/V (query head h reads KV head h // G) equals the Pallas
    kernel on K/V repeated per group, the layout of the reference's
    kernel-vs-blockwise test, and the reference's blockwise path."""
    b, s, nk, g, dh = 1, 128, 2, 2, 32
    rng = np.random.default_rng(11)
    q, k, v = _rand(rng, b, s, nk, g, dh), _rand(rng, b, s, nk, dh), \
        _rand(rng, b, s, nk, dh)
    qh = q.transpose(0, 2, 3, 1, 4).reshape(b * nk * g, s, dh)
    kh = k.transpose(0, 2, 1, 3).reshape(b * nk, s, dh)
    vh = v.transpose(0, 2, 1, 3).reshape(b * nk, s, dh)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (qh, kh, vh)))
    rep = jflash(jnp.asarray(qh), jnp.repeat(jnp.asarray(kh), g, axis=0),
                 jnp.repeat(jnp.asarray(vh), g, axis=0), causal=True,
                 block_q=64, block_k=64, interpret=True)
    _close(got, rep)
    blk = JL.blockwise_attention(q, k, v, causal=True, q_block=64,
                                 kv_block=64)
    _close(got, np.asarray(blk).transpose(0, 2, 3, 1, 4).reshape(
        b * nk * g, s, dh))


def _wgmma_tile_model(q, k, v, causal, bq=128, bk=128):
    """The bf16 tensor-core kernel's arithmetic, tile by tile, in torch on
    the CPU: bf16 Q and K products summed in f32, the scale applied to the
    f32 scores, an online rescale per KV tile, P rounded to bf16 before
    P.V, and the output rounded to bf16 once.  q (H, Sq, D), k, v (H / G,
    Skv, D), all bf16; query head h reads KV head h // G."""
    h, sq, d = q.shape
    g, skv = h // k.shape[0], k.shape[1]
    scale = 1.0 / np.sqrt(d)
    out = torch.empty_like(q)
    for hh in range(h):
        kh, vh = k[hh // g].float(), v[hh // g].float()
        for q0 in range(0, sq, bq):
            rows = q[hh, q0:q0 + bq].float()
            qpos = torch.arange(q0, q0 + rows.shape[0])[:, None]
            m = torch.full((rows.shape[0], 1), -1e30)
            l = torch.zeros_like(m)
            acc = torch.zeros(rows.shape[0], d)
            for k0 in range(0, min(skv, q0 + bq) if causal else skv, bk):
                s = (rows @ kh[k0:k0 + bk].T) * scale
                if causal:
                    kpos = torch.arange(k0, k0 + s.shape[1])[None, :]
                    s = torch.where(kpos > qpos, -1e30, s)
                m_new = torch.maximum(m, s.amax(1, keepdim=True))
                p = torch.where(s > -0.5e30, torch.exp(s - m_new), 0.0)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(1, keepdim=True)
                acc = acc * alpha + p.bfloat16().float() @ vh[k0:k0 + bk]
                m = m_new
            out[hh, q0:q0 + bq] = (acc / torch.clamp(l, min=1e-30)).bfloat16()
    return out


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_design_rounding_within_bf16_tolerance(d, causal):
    """Design (a) of csrc/flash_attention.cu rounds P to bf16 before P.V,
    a rounding the Pallas kernel does not have; at a ragged length and
    group 3 its tile model stays within the reference's bf16 tolerance of
    the Pallas kernel in interpret mode (K/V repeated per group)."""
    h, g, s = 3, 3, 1000
    rng = np.random.default_rng(d + int(causal))
    q, k, v = (_rand(rng, n, s, d) for n in (h, h // g, h // g))
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = _wgmma_tile_model(qb, kb, vb, causal)
    want = jflash(*(jnp.repeat(jnp.asarray(a, jnp.bfloat16), r, axis=0)
                    for a, r in ((q, 1), (k, g), (v, g))),
                  causal=causal, block_q=200, block_k=200, interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == (h, s, d)
    _close(got, np.asarray(want, np.float32), 2e-2)


def test_flash_attention_checks():
    q = torch.zeros(6, 8, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(4, 8, 16), torch.zeros(4, 8, 16))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(3, 8, 8), torch.zeros(3, 8, 8))
    with pytest.raises(TypeError):
        flash_attention(q.double(), torch.zeros(3, 8, 16).double(),
                        torch.zeros(3, 8, 16).double())
    # a window and a softcap are ported now: each matches the reference's
    # layer (tests/test_torch_gemma.py sweeps them)
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 1, 4, 1, 1, 8), _rand(rng, 1, 4, 1, 8), \
        _rand(rng, 1, 4, 1, 8)
    for kw in ({"window": 2}, {"softcap": 30.0}):
        got = TL.blockwise_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v)), causal=True, **kw)
        _close(got, np.asarray(JL.blockwise_attention(q, k, v, causal=True,
                                                      **kw)))


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def reduced_llama():
    jcfg = jbase.reduced(jreg.get("llama3.2-3b"))
    jm = jbuild(jcfg, compute_dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = tbuild(tbase.reduced(treg.get("llama3.2-3b")),
                compute_dtype=torch.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def test_params_round_trip(reduced_llama):
    _, jp, _, tp = reduced_llama
    back = params_to_numpy(tp)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _tree_err(got, want) -> float:
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        return max(_tree_err(got[k], want[k]) for k in got)
    assert tuple(got.shape) == tuple(want.shape)
    return float(np.abs(got.numpy() - np.asarray(want)).max())


def test_model_prefill_and_decode_match_reference(reduced_llama):
    jm, jp, tm, tp = reduced_llama
    assert tm.cache_specs(2, 12)["blocks"]["pos0"]["k"].shape == \
        jm.cache_specs(2, 12)["blocks"]["pos0"]["k"].shape
    toks = np.random.default_rng(5).integers(0, 256, (2, 9))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        s_max=16)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_max=16)
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) < 1e-4
    assert _tree_err(tc, jc) < 1e-5
    tok = np.argmax(np.asarray(jl), -1)
    for pos in range(9, 13):
        before = {k: v.clone() for k, v in tc["blocks"]["pos0"].items()}
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos, jnp.int32))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        # decode is functional: the input caches are left as they were
        assert all(torch.equal(before[k], tc["blocks"]["pos0"][k])
                   for k in before)
        tc = tc2
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) < 1e-4
        assert _tree_err(tc, jc) < 1e-5
        assert np.array_equal(tl.argmax(-1).numpy(), np.argmax(
            np.asarray(jl), -1))
        tok = np.argmax(np.asarray(jl), -1)


@pytest.mark.parametrize("tag", ["hybrid:cross", "attn_local",
                                 # every layer base is ported; a variant
                                 # a base lacks is not (hybrid: full and
                                 # local; the xLSTM bases: full)
                                 pytest.param("slstm:local", id="slstm"),
                                 "hybrid:bidir", "mlstm:local",
                                 pytest.param("mlstm:bidir", id="mlstm"),
                                 pytest.param("slstm:cross", id="slstm")])
def test_non_dense_layer_tags_raise(tag):
    cfg = tbase.reduced(treg.get("llama3.2-3b"))
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match=tag.split(":")[-1]):
        TB.apply_layer(cfg, tag, {}, x, mode="prefill")


def test_train_mode_and_context_families_raise(reduced_llama):
    # train mode is ported now: one dense layer's full-sequence forward,
    # no cache, against the reference's (1e-5, f32 sums in another order);
    # the vlm/audio contexts, the hybrid and the xLSTM layers are ported
    # too: a reduced xLSTM model prefills and decodes (its parity with
    # the reference: tests/test_torch_xlstm_model.py)
    jm, jp, tm, tp = reduced_llama
    x = np.random.default_rng(9).standard_normal(
        (2, 7, tm.cfg.d_model)).astype(np.float32)
    jy, jc = JB.apply_layer(jm.cfg, "dense",
                            jax.tree.map(lambda a: a[0],
                                         jp["blocks"]["pos0"]),
                            jnp.asarray(x), mode="train")
    ty, tc = TB.apply_layer(tm.cfg, "dense",
                            tree_map(lambda t: t[0], tp["blocks"]["pos0"]),
                            torch.from_numpy(x), mode="train")
    assert jc is None and tc is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError):
        TB.apply_layer(tm.cfg, "dense", {}, torch.from_numpy(x),
                       mode="serve")
    xl = tbuild(tbase.reduced(treg.get("xlstm-1.3b")),
                compute_dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    xp = xl.init_params(gen, "cpu")
    logits, kv = xl.prefill(xp, {"tokens": torch.zeros(1, 4,
                                                       dtype=torch.int64)})
    assert logits.shape == (1, xl.cfg.vocab_padded)
    assert bool(torch.isfinite(logits[:, :xl.cfg.vocab]).all())
    assert sorted(kv["blocks"]["pos0"]) == ["c", "m", "n"]
    assert sorted(kv["blocks"]["pos7"]) == ["c", "h", "m", "n"]
    step, _ = xl.decode_step(xp, kv, torch.zeros(1, dtype=torch.int64), 4)
    assert bool(torch.isfinite(step[:, :xl.cfg.vocab]).all())
