"""repro_torch's gemma training against the JAX reference, on the CPU in
f32: gemma3-27b's sliding-window layers and gemma2-9b's window and score
softcap, its final logit softcap and the tied head in the chunked loss,
through ``FlashAttentionFn`` (on CPU tensors the plain forward and
``flash_attention_bwd_plain``).

Inputs are drawn with numpy from a seed and handed to both packages; the
reference's parameters reach the port through ``interop.params_from_numpy``
and its train states through ``state_from_numpy``.  The reduced configs
(window 8, head width 16) train on sequences of 20 and 32 tokens, longer
than the window.  Tolerances: the loss within 1e-5 relative and each
gradient leaf within 1e-4 of its own largest |grad| (f32 sums in another
order through the scaled weights and both caps); the Trainer's losses
within 1e-6 relative and its parameters within 1e-7 (tests/
test_torch_train.py's bounds for llama3.2-3b); a resumed run bit for bit.
``chip_smoke.py`` phases 2, 4 and 16 hold the kernels on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.core import policy as jpol
from repro.optim import adamw as jadamw
from repro.models.model import build as jbuild
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core import policy as tpol
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import launch_counts
from repro_torch.launch import train as tlaunch
from repro_torch.models import backbone as TB
from repro_torch.models.model import build as tbuild
from repro_torch.core.policy import tree_flatten_with_path
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig
from repro_torch.train_resume import mismatches, twin_run

GEMMAS = ("gemma3-27b", "gemma2-9b")
LOSS_CHUNK = 10     # two chunks of the 20-token sequences


def _models(arch, loss_chunk=LOSS_CHUNK):
    return (jbuild(jbase.reduced(jreg.get(arch)), compute_dtype=jnp.float32,
                   loss_chunk=loss_chunk),
            tbuild(tbase.reduced(treg.get(arch)),
                   compute_dtype=torch.float32, loss_chunk=loss_chunk))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's loss and gradients of the reduced ``arch`` on two
    sequences of 20 tokens, its weights scaled by 8 as the serving tests'
    ``gemma`` fixture scales them (logits large enough for gemma2's final
    cap to bend them), and those parameters as numpy."""
    mj, _ = _models(arch)
    pj = mj.init_params(jax.random.PRNGKey(1))
    pj = jax.tree.map(lambda a: a * 8 if a.ndim >= 2 else a, pj)
    rng = np.random.default_rng(7)
    batch = {n: rng.integers(0, mj.cfg.vocab, (2, 20)).astype(np.int32)
             for n in ("tokens", "labels")}
    lj, gj = jax.jit(jax.value_and_grad(mj.loss))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, pj), batch, float(lj),
            [np.asarray(x) for x in jax.tree.leaves(gj)])


@pytest.mark.parametrize("remat", ["full", "none", "dots"])
@pytest.mark.parametrize("arch", GEMMAS)
def test_gemma_loss_and_grads_match_reference(arch, remat, monkeypatch):
    """Model.loss and every gradient leaf of reduced gemma3 (five local
    layers, one global, one local more) and gemma2 (local, global, local;
    softcaps 50 and 30) against jax.value_and_grad of the reference's
    loss, under each remat policy; the attention runs through
    FlashAttentionFn with its window and cap."""
    cfg = tbase.reduced(treg.get(arch))
    assert cfg.window == 8 and "dense:local" in cfg.layer_pattern
    _, mt = _models(arch)
    pn, batch, lj, want = _reference(arch)
    monkeypatch.setitem(TB.REMAT, "policy", remat)
    pt = params_from_numpy(pn, "cpu")
    leaves = [x.detach().requires_grad_()
              for _, x in tpol.tree_flatten_with_path(pt)]
    seen = []
    real = FA.FlashAttentionFn.backward

    def backward(ctx, do):
        seen.append((ctx.window, ctx.softcap))
        return real(ctx, do)
    monkeypatch.setattr(FA.FlashAttentionFn, "backward",
                        staticmethod(backward))
    before = launch_counts()
    lt = mt.loss(tpol.tree_unflatten(pt, leaves),
                 {k: torch.from_numpy(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    assert launch_counts() == before       # CPU tensors launch nothing
    # one backward a layer, with the layer's window and the arch's cap
    tags = [t for t in cfg.layer_pattern * 2][:cfg.n_layers]
    assert sorted(seen) == sorted(
        (cfg.window if t.endswith("local") else 0, cfg.attn_softcap)
        for t in tags)
    assert abs(float(lt.detach()) - lj) <= 1e-5 * abs(lj)
    assert len(gt) == len(want)
    for a, b in zip(gt, want):
        assert a.shape == b.shape
        top = float(np.abs(b).max())
        assert top > 0
        assert float(np.abs(a.numpy() - b).max()) <= 1e-4 * top


def _trainer_config(cls, tmp, **kw):
    base = dict(steps=8, ckpt_every=4, ckpt_dir=str(tmp),
                policy=jpol.PARTLY_PERSISTENT if cls is JTrainerConfig
                else tpol.PARTLY_PERSISTENT, global_batch=4, seq_len=32,
                async_ckpt=False)
    base.update(kw)
    return cls(**base)


def test_gemma2_trainer_four_steps_match_reference(tmp_path):
    """The reduced gemma2 Trainer over four steps from the reference's
    initial state: every step's loss and lr, then the parameters."""
    mj, mt = _models("gemma2-9b", loss_chunk=512)
    jt = JTrainer(mj, jadamw.AdamWConfig(),
                  _trainer_config(JTrainerConfig, tmp_path / "j",
                                  ckpt_every=0))
    jt.init()
    tt = TTrainer(mt, tadamw.AdamWConfig(),
                  _trainer_config(TTrainerConfig, tmp_path / "t",
                                  ckpt_every=0), device="cpu")
    tt.state = state_from_numpy(jax.tree.map(np.asarray, jt.state), "cpu")
    jt.run(4)
    tt.run(4)
    assert len(tt.metrics_log) == len(jt.metrics_log) == 4
    for a, b in zip(tt.metrics_log, jt.metrics_log):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        assert a["lr"] == b["lr"]
    want = [np.asarray(x) for x in jax.tree.leaves(jt.state.params)]
    got = [x.numpy() for _, x in tpol.tree_flatten_with_path(tt.state.params)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    assert int(tt.state.step) == 4


@pytest.mark.parametrize("policy", ["PARTLY_PERSISTENT", "FULLY_PERSISTENT"])
def test_gemma2_crash_resume_bit_consistent(tmp_path, policy):
    """A reduced gemma2 run crashed after step 6 and resumed from its
    step-4 checkpoint: every loss and the final parameters equal an
    uninterrupted run's bit for bit."""
    _, mt = _models("gemma2-9b", loss_chunk=512)
    tc = _trainer_config(TTrainerConfig, tmp_path / "a",
                         policy=getattr(tpol, policy))
    out = twin_run(mt, tc, crash_at=6, device="cpu")
    assert out["resumed_at"] == 4
    assert sorted(out["second"]) == [4, 5, 6, 7]
    assert mismatches(out) == []
    assert [r.step for r in out["saves"]] == [4, 8]


@pytest.mark.parametrize("arch", GEMMAS)
def test_launch_train_gemma_crash_returns_zero(arch, tmp_path, capsys):
    """``launch.train --arch <gemma> --device cpu --crash-at-step 6
    --steps 10``: the reduced model trains, crashes after step 6 (before
    its first checkpoint at 10), respawns from the seed and finishes."""
    rc = tlaunch.main(["--arch", arch, "--device", "cpu", "--crash-at-step",
                       "6", "--steps", "10", "--ckpt-dir", str(tmp_path)])
    said = capsys.readouterr().out
    assert rc == 0
    assert "CRASH injected at step 6" in said
    assert "no checkpoint yet" in said
    assert '"final_step": 9' in said


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_update_in_chunks_equals_the_whole_leaf(moments, monkeypatch):
    """AdamW updates a leaf past UPDATE_CHUNK elements a chunk at a time
    (the full-width gemma3 embedding's temporaries): the new parameters
    and moments equal the whole-leaf update's bit for bit."""
    rng = np.random.default_rng(3)
    cfg = tadamw.AdamWConfig(moment_dtype=moments)
    dt = torch.bfloat16 if moments == "bfloat16" else torch.float32

    def tree(scale, dtype=torch.float32):
        return {"big": torch.from_numpy(rng.standard_normal((300, 41))
                                        .astype(np.float32) * scale)
                .to(dtype),
                "small": torch.from_numpy(rng.standard_normal(7)
                                          .astype(np.float32) * scale)
                .to(dtype)}
    p, g = tree(1.0), tree(3.0)
    m, v = tree(0.1, dt), {k: x.abs() for k, x in tree(0.01, dt).items()}
    whole = tadamw.update(p, g, m, v, 5, 2e-4, cfg)
    monkeypatch.setattr(tadamw, "UPDATE_CHUNK", 1000)   # 13 chunks
    parts = tadamw.update(p, g, m, v, 5, 2e-4, cfg)
    assert torch.equal(whole[3], parts[3])
    for a, b in zip(whole[:3], parts[:3]):
        for (pa, x), (pb, y) in zip(tree_flatten_with_path(a),
                                    tree_flatten_with_path(b)):
            assert pa == pb and x.dtype == y.dtype and torch.equal(x, y)
