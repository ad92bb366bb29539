"""repro_torch's training slice vs the JAX reference, on the CPU.

The same inputs, made with numpy from a seed (parameters: the reference's
JAX init converted with ``interop.params_from_numpy``), go through the
reference and the port:

* the gradient of attention: the port's ``flash_attention_bwd_plain`` and
  its autograd wiring (``FlashAttentionFn``, which on CPU tensors runs the
  plain forward and backward) against ``jax.grad`` of the reference's
  ``blockwise_attention``, and against torch autograd through
  ``flash_attention_plain``;
* ``Model.loss`` and its gradients, under each remat policy;
* ``WarmupCosine``, ``global_norm`` and ``update``; the pipeline's batches
  (byte-identical);
* the train step with microbatches and with a bf16 gradient rounding; the
  ``Trainer`` over four steps; crash/resume bit-consistency in the port
  under each policy the reference's ``tests/test_train_serve.py`` runs;
  the ``launch.train`` entry point.

Each tolerance is stated where it is used.  The CUDA backward kernel is
held against the same plain version on the card by ``chip_smoke.py``.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.core import policy as jpol
from repro.data.pipeline import Pipeline as JPipeline
from repro.models import layers as jlayers
from repro.models.model import build as jbuild
from repro.optim import adamw as jadamw
from repro.optim.schedule import WarmupCosine as JWarmupCosine
from repro.train.state import new_state as j_new_state
from repro.train.step import build_train_step as j_build_train_step
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core import policy as tpol
from repro_torch.data.pipeline import Pipeline as TPipeline
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import launch_counts
from repro_torch.launch import train as tlaunch
from repro_torch.models import backbone as TB
from repro_torch.models.model import build as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import WarmupCosine as TWarmupCosine
from repro_torch.train.step import build_train_step as t_build_train_step
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig
from repro_torch.train_resume import mismatches, twin_run

ARCH = "llama3.2-3b"
GRAD_TOL = 1e-5     # of the largest |grad|: f32 sums in another order


# ------------------------------------------------------- attention grads

def _attn_inputs(g, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    h = 4
    q = rng.standard_normal((h, sq, d)).astype(np.float32)
    k = rng.standard_normal((h // g, skv, d)).astype(np.float32)
    v = rng.standard_normal((h // g, skv, d)).astype(np.float32)
    do = rng.standard_normal((h, sq, d)).astype(np.float32)
    return q, k, v, do


def _jax_attention_grads(q, k, v, do, g, causal):
    """jax.grad of the reference layer, with the kernel's (H, S, D) heads
    as the layer's (B=1, S, K=H/G, G, D)."""
    h, sq, d = q.shape

    def layer(q, k, v):
        q5 = q.reshape(h // g, g, sq, d).transpose(2, 0, 1, 3)[None]
        k4 = k.transpose(1, 0, 2)[None]
        v4 = v.transpose(1, 0, 2)[None]
        out = jlayers.blockwise_attention(q5, k4, v4, causal=causal)
        return out[0].transpose(1, 2, 0, 3).reshape(h, sq, d)

    @jax.jit
    def value_and_vjp(q, k, v, do):
        out, vjp = jax.vjp(layer, q, k, v)
        return out, vjp(do)

    out, grads = value_and_vjp(q, k, v, do)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _assert_grads_close(got, want, what):
    top = max(float(np.abs(w).max()) for w in want)
    for name, a, b in zip("qkv", got, want):
        err = float(np.abs(np.asarray(a) - b).max())
        assert err <= GRAD_TOL * top, (what, name, err, top)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("sq,skv", [(1, 37), (37, 37), (37, 130),
                                    (130, 37), (130, 130), (1, 1)])
@pytest.mark.parametrize("g", [1, 2])
def test_attention_grads_match_reference(g, sq, skv, d, causal):
    q, k, v, do = _attn_inputs(g, sq, skv, d, seed=sq * 1000 + skv + d + g)
    out_j, grads_j = _jax_attention_grads(q, k, v, do, g, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    # the plain backward from the plain forward's output and lse
    o, lse = FA.flash_attention_plain(tq, tk, tv, causal=causal,
                                      return_lse=True)
    np.testing.assert_allclose(o.numpy(), out_j, rtol=0,
                               atol=GRAD_TOL * float(np.abs(out_j).max()))
    plain = FA.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse,
                                         causal=causal)
    _assert_grads_close([x.numpy() for x in plain], grads_j, "plain")
    # the autograd wiring: FlashAttentionFn on CPU tensors
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    before = launch_counts()
    out = FA.flash_attention(*leaves, causal=causal)
    fn = torch.autograd.grad(out, leaves, tdo)
    assert launch_counts() == before      # CPU tensors launch nothing
    assert out.grad_fn is not None and "FlashAttentionFn" in \
        type(out.grad_fn).__name__
    _assert_grads_close([x.numpy() for x in fn], grads_j, "function")
    # torch autograd through the plain forward
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    auto = torch.autograd.grad(
        FA.flash_attention_plain(*leaves, causal=causal), leaves, tdo)
    _assert_grads_close([x.numpy() for x in plain],
                        [x.numpy() for x in auto], "autograd")


def test_lse_and_backward_wrapper_checks():
    q, k, v, do = (torch.from_numpy(x) for x in _attn_inputs(2, 9, 9, 16, 1))
    o, lse = FA.flash_attention_plain(q, k, v, return_lse=True)
    # causal row 0 sees key 0 only: its lse is its one scaled score
    s00 = (q[:, 0] * k.repeat_interleave(2, 0)[:, 0]).sum(-1) / 4.0
    np.testing.assert_allclose(lse[:, 0].numpy(), s00.numpy(), rtol=1e-6)
    assert lse.shape == (4, 9) and lse.dtype == torch.float32
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(q, k, v, o, do, lse[:, :3])
    with pytest.raises(TypeError):
        FA.flash_attention_bwd(q, k, v, o.double(), do, lse)
    # no grad wanted: the plain forward, no autograd node
    assert FA.flash_attention(q, k, v).grad_fn is None


# ----------------------------------------------------------- Model.loss

def _models(loss_chunk=16, layers=2):
    cfgj = dataclasses.replace(jbase.reduced(jreg.get(ARCH)),
                               n_layers=layers)
    cfgt = dataclasses.replace(tbase.reduced(treg.get(ARCH)),
                               n_layers=layers)
    return (jbuild(cfgj, compute_dtype=jnp.float32, loss_chunk=loss_chunk),
            tbuild(cfgt, compute_dtype=torch.float32,
                   loss_chunk=loss_chunk))


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _torch_tree(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _reference_loss():
    """The reference's loss and grads of the reduced llama3.2-3b at 2
    layers, 48 tokens in loss chunks of 16, and the converted params."""
    mj, _ = _models(loss_chunk=16)
    pj = mj.init_params(jax.random.PRNGKey(0))
    batch = _batch(mj.cfg, 2, 48, seed=3)
    lj, gj = jax.jit(jax.value_and_grad(mj.loss))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, pj), batch, float(lj),
            [np.asarray(x) for x in jax.tree.leaves(gj)])


@pytest.mark.parametrize("remat", ["full", "none", "dots"])
def test_model_loss_and_grads_match_reference(remat, monkeypatch):
    _, mt = _models(loss_chunk=16)
    pn, batch, lj, want = _reference_loss()
    pt = params_from_numpy(pn, "cpu")
    monkeypatch.setitem(TB.REMAT, "policy", remat)
    leaves = [x.detach().requires_grad_()
              for _, x in tpol.tree_flatten_with_path(pt)]
    lt = mt.loss(tpol.tree_unflatten(pt, leaves), _torch_tree(batch))
    gt = torch.autograd.grad(lt, leaves)
    # loss: f32 sums in another order, 1e-6 relative
    assert abs(float(lt.detach()) - lj) <= 1e-6 * abs(lj)
    top = max(float(np.abs(w).max()) for w in want)
    assert len(want) == len(gt)
    for a, b in zip(gt, want):
        assert float(np.abs(a.numpy() - b).max()) <= GRAD_TOL * top


def test_model_loss_single_chunk_and_unported_layers():
    mj, mt = _models(loss_chunk=512)
    pj = mj.init_params(jax.random.PRNGKey(1))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    batch = _batch(mj.cfg, 3, 20, seed=4)     # 20 < 512: one chunk
    lj = mj.loss(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    lt = mt.loss(pt, _torch_tree(batch))
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    # MoE trains now (tests/test_torch_moe_model.py), and so do xlstm's
    # layers: a finite loss whose gradient reaches the sLSTM recurrent
    # weights (parity with the reference: tests/test_torch_xlstm_train.py)
    xl = tbuild(tbase.reduced(treg.get("xlstm-1.3b")),
                compute_dtype=torch.float32)
    g = torch.Generator()
    g.manual_seed(0)
    xp = xl.init_params(g, "cpu")
    r = xp["blocks"]["pos7"]["r"].requires_grad_()
    lx = xl.loss(xp, _torch_tree(batch))
    assert bool(torch.isfinite(lx))
    (gr,) = torch.autograd.grad(lx, [r])
    assert bool(torch.isfinite(gr).all()) and bool(gr.abs().max() > 0)


# -------------------------------------------------------- optimizer, data

@pytest.mark.parametrize("kw", [{}, {"total_steps": 12},
                                {"total_steps": 240, "warmup_steps": 10}])
def test_warmup_cosine_matches_reference(kw):
    j, t = JWarmupCosine(**kw), TWarmupCosine(**kw)
    want = np.array([np.asarray(j(s)) for s in range(j.total_steps + 1)],
                    np.float32)
    got = np.array([t(s).numpy() for s in range(j.total_steps + 1)],
                   np.float32)
    # the warm-up is exact; past it XLA's f32 cos is not torch's (neither
    # rounds correctly): a cos one ulp apart moves the lr by at most one
    # ulp of the peak lr (2.9e-11), which near the floor is a few ulp of
    # the lr itself
    warm = np.arange(j.total_steps + 1) < j.warmup_steps
    np.testing.assert_array_equal(got[warm], want[warm])
    peak_ulp = float(np.spacing(np.float32(j.peak_lr)))
    assert float(np.abs(got - want).max()) <= peak_ulp


def _np_tree(rng, scale):
    return {"w": (rng.standard_normal((16, 24)) * scale).astype(np.float32),
            "b": {"x": (rng.standard_normal(7) * scale).astype(np.float32),
                  "a": (rng.standard_normal((3, 5)) * scale
                        ).astype(np.float32)}}


@pytest.mark.parametrize("step,gscale", [(0, 1.0), (5, 0.01), (99, 30.0)])
def test_global_norm_and_update_match_reference(step, gscale):
    rng = np.random.default_rng(step)
    p, g = _np_tree(rng, 0.1), _np_tree(rng, gscale)
    m, v = _np_tree(rng, 1e-3), jax.tree.map(np.abs, _np_tree(rng, 1e-5))
    cfg = jadamw.AdamWConfig()
    lr = 2.5e-4
    jp, jm, jv, jn = jadamw.update(
        *(jax.tree.map(jnp.asarray, x) for x in (p, g, m, v)),
        jnp.asarray(step, jnp.int32), jnp.float32(lr), cfg)
    tp, tm, tv, tn = tadamw.update(
        *(params_from_numpy(x, "cpu") for x in (p, g, m, v)), step, lr,
        tadamw.AdamWConfig())
    # f32 in the reference's order of operations; XLA may fuse into FMAs
    # and its pow is not torch's: 1e-6 relative
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(tadamw.global_norm(
        params_from_numpy(g, "cpu"))), float(jadamw.global_norm(g)),
        rtol=1e-6)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, want)),
                        [x for _, x in tpol.tree_flatten_with_path(got)]):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(a).max()))


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_pipeline_batches_byte_identical(seed):
    for arch in (ARCH, "whisper-large-v3", "llama-3.2-vision-90b"):
        cj, ct = jbase.reduced(jreg.get(arch)), tbase.reduced(treg.get(arch))
        pj, pt = JPipeline(cj, 4, 16, seed=seed), TPipeline(ct, 4, 16,
                                                           seed=seed)
        for step in (0, 1, 7, 123456):
            bj, bt = pj.batch_at(step), pt.batch_at(step)
            assert sorted(bj) == sorted(bt)
            for key in bj:
                assert bj[key].dtype == bt[key].dtype
                assert bj[key].tobytes() == bt[key].tobytes()
    pt.reconstruct_cursor(seed, 5)
    assert (pt.seed, pt.step) == (seed, 5)
    assert next(iter(pt))["tokens"].tobytes() == \
        pj.batch_at(5)["tokens"].tobytes()


# ---------------------------------------------------------- train step

def _step_pair(microbatches, sync):
    mj, mt = _models(loss_chunk=512)
    pj = mj.init_params(jax.random.PRNGKey(2))
    mu, nu = jadamw.init_moments(pj, jadamw.AdamWConfig())
    sj = j_new_state(pj, mu, nu, 5)
    st = state_from_numpy(jax.tree.map(np.asarray, sj), "cpu")
    sched_j, sched_t = JWarmupCosine(warmup_steps=2, total_steps=10), \
        TWarmupCosine(warmup_steps=2, total_steps=10)
    fj = j_build_train_step(mj, jadamw.AdamWConfig(), sched_j,
                            microbatches=microbatches, grad_sync_dtype=sync)
    ft = t_build_train_step(mt, tadamw.AdamWConfig(), sched_t,
                            microbatches=microbatches, grad_sync_dtype=sync)
    return mj, sj, st, fj, ft


@pytest.mark.parametrize("microbatches,sync", [(2, None), (1, "bfloat16")])
def test_train_step_matches_reference(microbatches, sync):
    mj, sj, st, fj, ft = _step_pair(microbatches, sync)
    fj = jax.jit(fj)
    for step in range(3):
        batch = _batch(mj.cfg, 4, 24, seed=10 + step)
        sj, metj = fj(sj, {k: jnp.asarray(v) for k, v in batch.items()})
        st, mett = ft(st, _torch_tree(batch))
        # loss: f32 sums in another order (bf16-rounded grads do not touch
        # it), 1e-6 relative; lr exact in the warm-up
        np.testing.assert_allclose(float(mett["loss"]), float(metj["loss"]),
                                   rtol=1e-6)
        assert float(mett["lr"]) == float(metj["lr"])
        # grad norm: 1e-5 relative; with bf16 rounding a grad that lands
        # on a rounding boundary may round the other way
        np.testing.assert_allclose(float(mett["grad_norm"]),
                                   float(metj["grad_norm"]), rtol=1e-5)
    assert int(st.step) == 3
    np.testing.assert_array_equal(st.rng.numpy(), np.asarray(sj.rng))
    # params after three steps.  The warm-up's learning rates are 0,
    # 1.5e-4 and 3e-4, and an Adam step moves an element by at most about
    # lr * (1 + wd |p|) whatever its gradient, so two runs whose updates
    # disagreed completely would part by up to ~9e-4.  Rounding alone keeps
    # them within 1e-6 (4e-6 with bf16 rounding, where an element whose
    # gradient lies near a bf16 rounding boundary can round the other way
    # and move by a few ulp of its gradient's share of the update).
    tol = 4e-6 if sync else 1e-6
    want = [np.asarray(x) for x in jax.tree.leaves(sj.params)]
    got = [x.numpy() for _, x in tpol.tree_flatten_with_path(st.params)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def test_train_step_refuses_shardings():
    mj, mt = _models()
    with pytest.raises(NotImplementedError, match="param_shardings"):
        t_build_train_step(mt, tadamw.AdamWConfig(), TWarmupCosine(),
                           param_shardings={})


# -------------------------------------------------------------- trainer

def _trainer_config(cls, tmp, **kw):
    base = dict(steps=8, ckpt_every=4, ckpt_dir=str(tmp),
                policy=jpol.PARTLY_PERSISTENT if cls is JTrainerConfig
                else tpol.PARTLY_PERSISTENT, global_batch=4, seq_len=32,
                async_ckpt=False)
    base.update(kw)
    return cls(**base)


def test_trainer_four_steps_match_reference(tmp_path):
    mj, mt = _models(loss_chunk=512)
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
    for a, b in zip(tt.metrics_log, jt.metrics_log):
        assert a["step"] == b["step"]
        # f32 sums in another order: 1e-6 relative; the lr of the
        # warm-up's first steps is exact
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        assert a["lr"] == b["lr"]
    # the warm-up's learning rates (0, 3e-6, 6e-6, 9e-6) bound how far two
    # runs' params could part at all (about 2 * 1.8e-5 in sum); rounding
    # keeps them within 1e-7
    want = [np.asarray(x) for x in jax.tree.leaves(jt.state.params)]
    got = [x.numpy() for _, x in tpol.tree_flatten_with_path(tt.state.params)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    assert int(tt.state.step) == 4


@pytest.mark.parametrize("policy", ["PARTLY_PERSISTENT", "FULLY_PERSISTENT"])
def test_trainer_crash_resume_bit_consistent(tmp_path, policy):
    """The reference's contract (tests/test_train_serve.py), held exactly:
    a resumed run's every loss and final parameters equal an uninterrupted
    run's, bit for bit."""
    _, mt = _models(loss_chunk=512)
    tc = _trainer_config(TTrainerConfig, tmp_path / "a",
                         policy=getattr(tpol, policy))
    out = twin_run(mt, tc, crash_at=6, device="cpu")
    assert out["resumed_at"] == 4
    assert sorted(out["second"]) == [4, 5, 6, 7]
    assert mismatches(out) == []
    assert [r.step for r in out["saves"]] == [4, 8]


def test_trainer_drop_policy_resumes_with_divergence(tmp_path):
    """partly+drop restores params exactly but re-warms moments — the
    documented approximation; training continues finitely."""
    _, mt = _models(loss_chunk=512)
    tr = TTrainer(mt, tadamw.AdamWConfig(),
                  _trainer_config(TTrainerConfig, tmp_path, steps=6,
                                  ckpt_every=3, policy=tpol.PARTLY_DROP),
                  device="cpu")
    tr.init()
    tr.run(4)
    tr.crash()
    assert tr.resume() == 3
    mu = [x for _, x in tpol.tree_flatten_with_path(tr.state.mu)]
    assert all(float(x.abs().sum()) == 0.0 for x in mu)
    tr.run(2)
    assert math.isfinite(tr.metrics_log[-1]["loss"])


def test_trainer_deadline_and_shardings(tmp_path):
    _, mt = _models(loss_chunk=512)
    tr = TTrainer(mt, tadamw.AdamWConfig(),
                  _trainer_config(TTrainerConfig, tmp_path,
                                  deadline_s=1e-9), device="cpu")
    tr.init()
    with pytest.raises(TimeoutError, match="deadline"):
        tr.run(1)
    with pytest.raises(NotImplementedError, match="shardings"):
        TTrainer(mt, tadamw.AdamWConfig(),
                 _trainer_config(TTrainerConfig, tmp_path), shardings={},
                 device="cpu")


@pytest.mark.parametrize("extra", [[], ["--ckpt-every", "4"]])
def test_launch_train_crash_returns_zero(tmp_path, capsys, extra):
    rc = tlaunch.main(["--arch", ARCH, "--crash-at-step", "6", "--steps",
                       "10", "--device", "cpu", "--global-batch", "2",
                       "--seq-len", "16", "--ckpt-dir", str(tmp_path),
                       *extra])
    said = capsys.readouterr().out
    assert rc == 0
    assert "CRASH injected at step 6" in said
    assert ("restored at step 4" in said) if extra else \
        ("no checkpoint yet" in said)
    assert '"final_step": 9' in said
