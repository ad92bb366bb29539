"""repro_torch's gemma slice against the JAX reference, on the CPU in f32:
sliding-window and softcapped attention, gemma3-27b and gemma2-9b
prefill and decode through ring caches, their serving launchers and the
engine's twin recovery; then the substrate's leftovers: the reference's
positional arguments (``pack_flush_rows``, ``use_pack_kernel``), bf16
checkpoint leaves and ``dequantize_blockwise(dtype=)``.

Inputs are drawn with numpy from a seed and handed to both packages; the
reference's parameters reach the port through ``interop.params_from_numpy``.
Tolerances are ``tests/test_torch_models.py``'s: 2e-5 for attention (f32
summation order), 1e-4 on logits and 1e-5 on caches through the reduced
models (window 8, head width 16).  Files, images, FlushStats and the
dequantized bf16 words are compared exactly.  On the CPU every wrapper
takes its plain version; ``chip_smoke.py`` holds the kernels to them.
"""
import dataclasses
import inspect
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import manager as JM
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.core import arena as RA
from repro.core import policy as jpol
from repro.kernels import quant_pack as JQ
from repro.models import layers as JL
from repro.models.model import build as jbuild
from repro_torch.ckpt import manager as TM
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core import arena as TA
from repro_torch.core import policy as tpol
from repro_torch.core.policy import tree_map
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import launch_counts
from repro_torch.kernels import quant_pack as TQ
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models.model import build as tbuild
from repro_torch.optim.adamw import AdamWConfig, init_moments
from repro_torch.serve_recover import _held, run
from repro_torch.train.state import new_state

import test_torch_ckpt as CK
import test_torch_sharded as SH

GEMMAS = ("gemma3-27b", "gemma2-9b")
POLICIES = ("FULLY_PERSISTENT", "PARTLY_PERSISTENT", "PARTLY_Q8",
            "PARTLY_DROP")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 2.0, 50.0])
@pytest.mark.parametrize("window", [1, 3, 8, "S+5"])
@pytest.mark.parametrize("s", [7, 33, 64])
def test_windowed_softcapped_attention_matches_reference(s, window, softcap,
                                                         causal):
    """blockwise_attention (the flash plain version on the CPU) against the
    reference's XLA layer: GQA group 2, a window from one key to past the
    sequence, scores capped at 2 (every score bent) and 50 (gemma2's)."""
    w = s + 5 if window == "S+5" else window
    rng = np.random.default_rng(s * 100 + (w if w < s else 99))
    q = _rand(rng, 2, s, 2, 2, 16) * 2
    k, v = _rand(rng, 2, s, 2, 16) * 2, _rand(rng, 2, s, 2, 16)
    want = JL.blockwise_attention(q, k, v, causal=causal, window=w,
                                  softcap=softcap)
    got = TL.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal, window=w, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert launch_counts()["flash_attention"] == 0


def test_window_past_the_sequence_is_plain_causal():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, 4, 40, 32)) for _ in range(3))
    full = FA.flash_attention(q, k, v)
    assert torch.equal(FA.flash_attention(q, k, v, window=40), full)
    assert not torch.equal(FA.flash_attention(q, k, v, window=39), full)


def test_lse_is_of_the_capped_scores():
    """The lse the forward keeps for the backward is the logsumexp of the
    capped, masked scores."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_rand(rng, 2, 20, 16) * 3) for _ in range(3))
    out, lse = FA.flash_attention_plain(q, k, v, window=5, softcap=2.0,
                                        return_lse=True)
    s = 2.0 * torch.tanh(q @ k.transpose(1, 2) / 4.0 / 2.0)
    ahead = torch.arange(20)[:, None] - torch.arange(20)[None, :]
    s = torch.where((ahead >= 0) & (ahead < 5), s, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(out, torch.softmax(s, -1) @ v, atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("kw", [{"window": 4}, {"softcap": 30.0}, {"d": 256}])
def test_grad_with_window_softcap_or_d256_goes_through_the_function(kw):
    """With grad enabled, a window, a softcap or head width 256 runs
    FlashAttentionFn (on the CPU: the plain forward and backward), whose
    grads equal torch autograd through the plain forward."""
    d = kw.pop("d", 16)
    rng = np.random.default_rng(d)
    base = [torch.from_numpy(_rand(rng, 2, 8, d) * 2) for _ in range(3)]
    do = torch.from_numpy(_rand(rng, 2, 8, d))
    leaves = [t.clone().requires_grad_(True) for t in base]
    out = FA.flash_attention(*leaves, **kw)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    ref = [t.clone().requires_grad_(True) for t in base]
    want = torch.autograd.grad(FA.flash_attention_plain(*ref, **kw), ref, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert launch_counts()["flash_attention_bwd"] == 0


def test_bad_window_or_softcap_raise():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q, window=-1)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q, softcap=-1.0)


# ---------------------------------------------------------------- models

@pytest.fixture(scope="module", params=GEMMAS)
def gemma(request):
    jcfg = jbase.reduced(jreg.get(request.param))
    jm = jbuild(jcfg, compute_dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(1))
    # scaled weights make greedy tokens vary (the random init echoes)
    jp = jax.tree.map(lambda a: a * 8 if a.ndim >= 2 else a, jp)
    tm = tbuild(tbase.reduced(treg.get(request.param)),
                compute_dtype=torch.float32)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tree_err(got, want) -> float:
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        return max(_tree_err(got[k], want[k]) for k in got)
    assert tuple(got.shape) == tuple(want.shape)
    return float(np.abs(got.numpy() - np.asarray(want)).max())


def test_gemma_configs_match_reference(gemma):
    jm, _, tm, _ = gemma
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert "dense:local" in tm.cfg.layer_pattern and tm.cfg.window == 8
    specs = tm.cache_specs(2, 24)
    want = jm.cache_specs(2, 24)
    for grp in specs:
        for pos in specs[grp]:
            for name, t in specs[grp][pos].items():
                assert tuple(t.shape) == tuple(want[grp][pos][name].shape)


def test_gemma_prefill_and_decode_match_reference(gemma):
    """A prompt longer than the window, then decode past the local rings'
    wrap: logits within 1e-4, caches within 1e-5, greedy tokens equal."""
    jm, jp, tm, tp = gemma
    s_max = 24
    toks = np.random.default_rng(5).integers(0, 256, (2, 11))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        s_max=s_max)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, s_max=s_max)
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) < 1e-4
    assert _tree_err(tc, jc) < 1e-5
    tok = np.argmax(np.asarray(jl), -1)
    seen = set(tok.tolist())
    for pos in range(11, 22):               # the rings of 8 wrap twice
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


@pytest.mark.parametrize("arch", GEMMAS)
def test_gemma_serving_launcher(arch, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    assert tserve.main(["--arch", arch, "--crash", "--device", "cpu"]) == 0
    assert "[serve] recovered" in capsys.readouterr().out


def test_gemma3_twin_recovery(monkeypatch):
    """The engine's crash and grouped re-prefill on reduced gemma3 beside
    an uninterrupted twin: prompts past the window, decode past the
    rings' wrap; the recovered rings equal the twin's where both hold the
    same position."""
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    cfg = tbase.reduced(treg.get("gemma3-27b"))
    out = run(cfg, "cpu", prompt_lens=(20, 20, 12, 5), max_batch=4,
              s_max=40, steps=4, max_requests=16)
    assert out["cache"]["rel_err"] <= 1e-5
    assert out["logit_rel_err"]["after"] <= 1e-4
    assert out["engine_detail"]["prefill_groups"] == 3


def test_held_ring_slots():
    # both engines' caches hold positions [0, n), the log but its last
    # token (serve/engine.py): a linear cache's first n slots, every slot
    # of a ring that has wrapped
    assert _held(5, 8).tolist() == [0, 1, 2, 3, 4]
    assert _held(8, 8).tolist() == list(range(8))
    assert _held(13, 8).tolist() == list(range(8))


# ------------------------------------------------- positional arguments

def _params(fn):
    return [p for p in inspect.signature(fn).parameters if p != "self"]


@pytest.mark.parametrize("name", ["Arena", "ShardedArena"])
def test_arena_signatures_match_reference(name):
    # the reference's parameters in its order, then the port's device=
    assert _params(getattr(TA, name).__init__) == \
        _params(getattr(RA, name).__init__) + ["device"]


def test_checkpoint_manager_signature_matches_reference():
    assert _params(TM.CheckpointManager.__init__) == \
        _params(JM.CheckpointManager.__init__)


def test_reference_positional_calls_open_shadow_arenas(tmp_path):
    for pkg in (RA, TA):
        kw = {"device": "cpu"} if pkg is TA else {}
        a = pkg.Arena(None, 0.0, 0, "shadow", **kw)
        b = pkg.ShardedArena(None, 4, 0.0, 0, "shadow", **kw)
        assert a.commit_mode == b.commit_mode == "shadow"
        assert a.pack_flush_rows == b.pack_flush_rows == 0
        assert all(sh.commit_mode == "shadow" for sh in b.shards)
    for mgr in (JM, TM):
        m = mgr.CheckpointManager(str(tmp_path / mgr.__name__),
                                  tpol.PARTLY_Q8 if mgr is TM
                                  else jpol.PARTLY_Q8, False, True)
        assert m.use_pack_kernel is True and m.incremental is False


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("rows", [0, 1, 10 ** 6])
def test_pack_flush_rows_changes_no_byte(rows, n_shards, monkeypatch):
    """The reference picks its Pallas gather or numpy by pack_flush_rows;
    the port always gathers through pack_rows: images and FlushStats equal
    in both packages at every threshold."""
    monkeypatch.delenv("REPRO_INTEGRITY", raising=False)
    monkeypatch.delenv("REPRO_PAGED", raising=False)
    out = {}
    for pkg in SH.PKG:
        a, d, t, h = SH._mixed(pkg, n_shards, pack_flush_rows=rows)
        assert a.pack_flush_rows == rows
        SH._trace(a, d, t, h)
        out[pkg] = (SH._image(a), SH._stats(a))
    assert out["port"] == out["ref"]
    if rows == 10 ** 6:
        a, d, t, h = SH._mixed("port", n_shards)
        SH._trace(a, d, t, h)
        assert (SH._image(a), SH._stats(a)) == out["port"]


# -------------------------------------------------------- bf16 leaves

def _bf16_state():
    """test_torch_ckpt's state with bf16 moments (the trainer's
    ``AdamWConfig(moment_dtype="bfloat16")``)."""
    st = CK.np_state()
    bf = lambda t: jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), t)
    return st._replace(mu=bf(st.mu), nu=bf(st.nu))


def _port_state(st):
    port = state_from_numpy(st, "cpu")        # bf16 leaves as their words
    assert port.mu["w"].dtype == torch.bfloat16
    return port


def _words(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("incremental", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_bf16_leaves_write_reference_files(tmp_path, policy, incremental):
    st = _bf16_state()
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    rj = JM.CheckpointManager(jd, getattr(jpol, policy),
                              incremental=incremental).save(
        CK.jax_state(st))
    rt = TM.CheckpointManager(td, getattr(tpol, policy),
                              incremental=incremental).save(_port_state(st))
    assert CK.report_fields(rt) == CK.report_fields(rj)
    assert CK.dir_bytes(td) == CK.dir_bytes(jd)
    manifest = json.load(open(os.path.join(td, "manifest.json")))
    mu = manifest["leaves"].get("mu/w")
    if policy != "PARTLY_DROP":
        assert mu["dtype"] == "bfloat16" and mu["quantized"] is False
        with np.load(os.path.join(td, mu["file"])) as z:
            assert z["x"].dtype.str == "|V2"     # np.load's name of '<V2'
        raw = open(os.path.join(td, mu["file"]), "rb").read()
        assert b"'descr': '<V2'" in raw


@pytest.mark.parametrize("policy", POLICIES)
def test_bf16_leaves_round_trip_in_the_port(tmp_path, policy):
    """The port restores what both packages write; the reference's own
    restore raises on the same files (ROADMAP Queue 3 departure 14)."""
    st = _bf16_state()
    spec = _port_state(st)
    for writer in ("ref", "port"):
        d = str(tmp_path / writer)
        if writer == "ref":
            JM.CheckpointManager(d, getattr(jpol, policy)).save(
                CK.jax_state(st))
        else:
            TM.CheckpointManager(d, getattr(tpol, policy)).save(spec)
        back = TM.CheckpointManager(d, getattr(tpol, policy)).restore(
            spec, device="cpu")
        for (path, a), (_, b) in zip(tpol.tree_flatten_with_path(
                back.as_dict()), tpol.tree_flatten_with_path(spec.as_dict())):
            assert a.dtype == b.dtype, path
            if policy == "PARTLY_DROP" and path[0] in ("mu", "nu"):
                assert not _words(a).any()
            elif path != ("rng",):
                assert torch.equal(_words(a), _words(b)), path
    if policy != "PARTLY_DROP":
        with pytest.raises(ValueError, match="cast"):
            JM.CheckpointManager(str(tmp_path / "ref"), getattr(
                jpol, policy)).restore(CK.jax_spec(st))


def test_bf16_moments_train_state_saves_and_resumes(tmp_path):
    params = {"w": torch.randn(8, 300), "b": torch.randn(16)}
    mu, nu = init_moments(params, AdamWConfig(moment_dtype="bfloat16"))
    mu = tree_map(lambda t: t + 0.5, mu)
    st = new_state(params, mu, nu, seed=3, device="cpu")
    m = TM.CheckpointManager(str(tmp_path), tpol.PARTLY_Q8)
    assert not m.save(st).quantized
    back = m.restore(st, device="cpu")
    assert back.mu["w"].dtype == torch.bfloat16
    assert torch.equal(back.mu["w"], st.mu["w"])


# ---------------------------------------------------------- dequantize

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_dtype_matches_reference_bitwise(dtype):
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((16, 512)) * 10.0 ** rng.uniform(
        -6, 3, (16, 1))).astype(np.float32)
    q, s = JQ.quantize_blockwise(jnp.asarray(x), interpret=True)
    want = np.asarray(JQ.dequantize_blockwise(q, s, dtype=getattr(
        jnp, dtype), interpret=True))
    qt, st = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))
    got = TQ.dequantize_blockwise(qt, st, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        _words(got).numpy().view(np.uint8),
        np.ascontiguousarray(want).view(np.uint8))
    with pytest.raises(TypeError):
        TQ.dequantize_blockwise(qt, st, torch.float16)
