"""The reduced hymba-1.5b trained through both packages on the CPU:
``Model.loss`` and every gradient leaf against ``jax.value_and_grad`` of
the reference under each remat policy, on sequences of 256 tokens, so
that the scan runs two chunks of 128 and each is recomputed in the
backward inside the superblock's own remat; the Trainer over four steps;
a crash and resume bit for bit; ``launch.train``.  Parameters and
helpers are ``test_torch_hybrid_model.py``'s; tolerances
``test_torch_moe_train.py``'s (the loss within 1e-5 relative, each
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
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core import policy as tpol
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.models import backbone as TB
from repro_torch.models import ssm as TS
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig
from repro_torch.train_resume import mismatches, twin_run

from test_torch_hybrid_model import ARCH, _models, _params

SEQ = 256           # two scan chunks of 128
LOSS_CHUNK = 128    # two loss chunks


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
def test_hybrid_loss_and_grads_match_reference(remat, monkeypatch):
    """Model.loss and every gradient leaf (the mamba leaves among them)
    against jax.value_and_grad of the reference's loss on two sequences
    of 256 tokens, under each remat policy.  Each scan chunk's states are
    computed at least twice (the forward and the recomputation in its
    backward): two chunks in each of the 9 layers."""
    _, mt = _models(loss_chunk=LOSS_CHUNK)
    batch, lj, want = _reference_loss()
    monkeypatch.setitem(TB.REMAT, "policy", remat)
    calls = []
    real = TS._chunk_states

    def spy(*args):
        calls.append(args[1].shape[1])
        return real(*args)
    monkeypatch.setattr(TS, "_chunk_states", spy)
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
        if "/mamba/" in name:
            assert top > 0, name
            seen.add(name.split("/")[-1])
    assert seen == {"in_proj", "conv", "x_proj", "dt_w", "dt_bias",
                    "a_log", "d_skip"}
    assert set(calls) == {128} and len(calls) >= 2 * 2 * 9


def _trainer_config(cls, tmp, **kw):
    # two sequences of 16 tokens a step: the step's arithmetic, not its
    # size, is what these tests hold
    base = dict(steps=8, ckpt_every=4, ckpt_dir=str(tmp),
                policy=jpol.PARTLY_PERSISTENT if cls is JTrainerConfig
                else tpol.PARTLY_PERSISTENT, global_batch=2, seq_len=16,
                async_ckpt=False)
    base.update(kw)
    return cls(**base)


def test_hybrid_trainer_four_steps_match_reference(tmp_path):
    """The reduced Trainer over four steps from the reference's initial
    state: every step's loss and lr, then the parameters."""
    mj, mt = _models()
    jt = JTrainer(mj, jadamw.AdamWConfig(),
                  _trainer_config(JTrainerConfig, tmp_path / "j",
                                  ckpt_every=0))
    jt.init()
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


def test_hybrid_crash_resume_bit_consistent(tmp_path):
    """A reduced run crashed after step 6 and resumed from its step-4
    checkpoint: every loss and the final parameters equal an
    uninterrupted run's bit for bit."""
    _, mt = _models()
    tc = _trainer_config(TTrainerConfig, tmp_path / "a")
    out = twin_run(mt, tc, crash_at=6, device="cpu")
    assert out["resumed_at"] == 4
    assert mismatches(out) == []


def test_launch_train_hymba_crash_returns_zero(tmp_path, capsys):
    rc = tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--crash-at-step", "6", "--steps", "10",
                       "--ckpt-every", "4", "--global-batch", "2",
                       "--seq-len", "16", "--ckpt-dir", str(tmp_path)])
    said = capsys.readouterr().out
    assert rc == 0
    assert "CRASH injected at step 6" in said and '"final_step": 9' in said
    assert "incarnation 2 restored at step 4" in said
