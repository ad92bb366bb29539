"""The reduced xlstm-1.3b trained through both packages on the CPU:
``Model.loss`` and every gradient leaf against ``jax.value_and_grad`` of
the reference under each remat policy, on two sequences of 32 tokens,
so that each mLSTM layer runs two chunks of 16, each recomputed in its
backward inside the superblock's own remat, and the sLSTM layer's
gradient goes through its custom backward; the Trainer over four steps
from one initial state; a crash and resume bit for bit;
``launch.train``.  Parameters and helpers are
``test_torch_xlstm_model.py``'s (the port's seeded init, which keeps the
reference's rule, taken by both packages).  Tolerances
``test_torch_hybrid_train.py``'s (the loss within 1e-5 relative, each
gradient leaf within 1e-4 of its own largest |grad|; the Trainer's
losses within 1e-6 relative and its parameters within 1e-7).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.optim import adamw as jadamw
from repro.train.trainer import Trainer as JTrainer
from repro.train.state import new_state as jnew_state
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core import policy as tpol
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.models import backbone as TB
from repro_torch.models import xlstm as TX
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig
from repro_torch.train_resume import mismatches, twin_run

from test_torch_xlstm_model import ARCH, _models, _params

SEQ = 32            # two mLSTM chunks of 16
LOSS_CHUNK = 16     # two loss chunks


@functools.lru_cache(maxsize=None)
def _reference_loss():
    jm, _ = _models(loss_chunk=LOSS_CHUNK)
    rng = np.random.default_rng(7)
    batch = {n: rng.integers(0, jm.cfg.vocab, (2, SEQ)).astype(np.int32)
             for n in ("tokens", "labels")}
    lj, gj = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, _params()),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(lj), [np.asarray(x) for x in jax.tree.leaves(gj)]


@pytest.mark.parametrize("remat", ["full", "none", "dots"])
def test_xlstm_loss_and_grads_match_reference(remat, monkeypatch):
    """Model.loss and every gradient leaf (every mLSTM and sLSTM leaf
    among them, each non-zero) against jax.value_and_grad of the
    reference's loss on two sequences of 32 tokens, under each remat
    policy.  The sLSTM scan's backward runs once (one sLSTM layer); each
    mLSTM chunk's body runs at least twice, the forward and the
    recomputation in its backward: two chunks in each of the 8 mLSTM
    layers."""
    _, mt = _models(loss_chunk=LOSS_CHUNK)
    batch, lj, want = _reference_loss()
    monkeypatch.setitem(TB.REMAT, "policy", remat)
    chunks, scans = [], []
    real_chunk, real_bwd = TX._mlstm_chunk, TX._SLSTMScan.backward

    def chunk_spy(*args):
        chunks.append(args[3].shape[2])
        return real_chunk(*args)

    def bwd_spy(ctx, *grads):
        scans.append(grads[0].shape[1])
        return real_bwd(ctx, *grads)
    monkeypatch.setattr(TX, "_mlstm_chunk", chunk_spy)
    monkeypatch.setattr(TX._SLSTMScan, "backward", staticmethod(bwd_spy))
    pt = params_from_numpy(_params(), "cpu")
    leaves = [x.detach().requires_grad_()
              for _, x in tpol.tree_flatten_with_path(pt)]
    lt = mt.loss(tpol.tree_unflatten(pt, leaves),
                 {k: torch.from_numpy(v) for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves)
    assert abs(float(lt.detach()) - lj) <= 1e-5 * abs(lj)
    assert len(gt) == len(want)
    seen = set()
    for (path, _), a, b in zip(tpol.tree_flatten_with_path(pt), gt, want):
        name = tpol.path_str(path)
        assert a.shape == b.shape
        top = float(np.abs(b).max())
        assert float(np.abs(a.numpy() - b).max()) <= 1e-4 * top, name
        if name.startswith(("blocks/", "rem/")):
            assert top > 0, name
            seen.add(name.split("/")[-1])
    assert {"w_if", "b_if", "w_og", "wo", "w_in", "b_in", "r", "wq",
            "wk", "wv", "out_norm"} <= seen
    assert set(chunks) == {16} and len(chunks) >= 2 * 2 * 8
    assert scans == [SEQ]


def _trainer_config(cls, tmp, **kw):
    # two sequences of 16 tokens a step: the step's arithmetic, not its
    # size, is what these tests hold
    base = dict(steps=8, ckpt_every=4, ckpt_dir=str(tmp),
                policy=jpol.PARTLY_PERSISTENT if cls is JTrainerConfig
                else tpol.PARTLY_PERSISTENT, global_batch=2, seq_len=16,
                async_ckpt=False)
    base.update(kw)
    return cls(**base)


def test_xlstm_trainer_four_steps_match_reference(tmp_path):
    """The reduced Trainer over four steps from one initial state (the
    reference's ``new_state`` over the port-drawn parameters, as its
    ``Trainer.init`` builds it over its own): every step's loss and lr,
    then the parameters."""
    mj, mt = _models()
    jc = _trainer_config(JTrainerConfig, tmp_path / "j", ckpt_every=0)
    jt = JTrainer(mj, jadamw.AdamWConfig(), jc)
    params = jax.tree.map(jnp.asarray, _params())
    jt.state = jnew_state(params, *jadamw.init_moments(params, jt.opt),
                          jc.seed)
    tt = TTrainer(mt, tadamw.AdamWConfig(), _trainer_config(
        TTrainerConfig, tmp_path / "t", ckpt_every=0), device="cpu")
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


def test_xlstm_crash_resume_bit_consistent(tmp_path):
    """A reduced run crashed after step 6 and resumed from its step-4
    checkpoint: every loss and the final parameters equal an
    uninterrupted run's bit for bit."""
    _, mt = _models()
    tc = _trainer_config(TTrainerConfig, tmp_path / "a")
    out = twin_run(mt, tc, crash_at=6, device="cpu")
    assert out["resumed_at"] == 4
    assert mismatches(out) == []


def test_launch_train_xlstm_crash_returns_zero(tmp_path, capsys):
    rc = tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--crash-at-step", "6", "--steps", "10",
                       "--ckpt-every", "4", "--global-batch", "2",
                       "--seq-len", "16", "--ckpt-dir", str(tmp_path)])
    said = capsys.readouterr().out
    assert rc == 0
    assert "CRASH injected at step 6" in said and '"final_step": 9' in said
    assert "incarnation 2 restored at step 4" in said
