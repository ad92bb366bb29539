"""The context archs (llama-3.2-vision-90b, whisper-large-v3) trained
through both packages on the CPU: ``Model.loss`` and every gradient leaf
against ``jax.value_and_grad`` of the reference under each remat policy
(the encoder's ``enc_blocks`` among them: the context reaches each
checkpointed superblock as an argument, so its gradient flows under
every policy) and the Trainer over four steps; the crash and resume and
``launch.train`` are ``test_torch_context_resume.py``'s.  Parameters, contexts, tolerances and helpers
are ``test_torch_context_model.py``'s (every ``xgate`` 1; the loss within
1e-5 relative, each gradient leaf within 1e-4 of its own largest |grad|;
the Trainer's losses within 1e-6 relative and its parameters within
1e-7, tests/test_torch_moe_train.py's).
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
from repro_torch.models import backbone as TB
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.train.trainer import TrainerConfig as TTrainerConfig

from test_torch_context_model import (CONTEXTS, _context, _models,
                                      _open_gates, _params)

LOSS_CHUNK = 16     # two chunks of the 32-token sequences


@functools.lru_cache(maxsize=None)
def _reference_loss(arch):
    jm, _ = _models(arch, loss_chunk=LOSS_CHUNK)
    rng = np.random.default_rng(7)
    batch = {n: rng.integers(0, jm.cfg.vocab, (2, 32)).astype(np.int32)
             for n in ("tokens", "labels")}
    batch.update(_context(jm.cfg, 2, 8))
    lj, gj = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, _params(arch)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(lj), [np.asarray(x) for x in jax.tree.leaves(gj)]


@pytest.mark.parametrize("remat", ["full", "none", "dots"])
@pytest.mark.parametrize("arch", CONTEXTS)
def test_context_loss_and_grads_match_reference(arch, remat, monkeypatch):
    """Model.loss and every gradient leaf against jax.value_and_grad of
    the reference's loss on two sequences of 32 tokens with a seeded
    context, under each remat policy; the cross weights' and (whisper)
    the encoder's gradients are non-zero."""
    _, mt = _models(arch, loss_chunk=LOSS_CHUNK)
    batch, lj, want = _reference_loss(arch)
    monkeypatch.setitem(TB.REMAT, "policy", remat)
    pt = params_from_numpy(_params(arch), "cpu")
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
        if "xattn" in name or "enc_blocks" in name:
            assert top > 0 and a.abs().max() > 0, name
            seen.add(name.split("/")[0])
    assert seen == ({"blocks", "enc_blocks"} if mt.cfg.family == "audio"
                    else {"blocks"})


def _trainer_config(cls, tmp, **kw):
    base = dict(steps=8, ckpt_every=4, ckpt_dir=str(tmp),
                policy=jpol.PARTLY_PERSISTENT if cls is JTrainerConfig
                else tpol.PARTLY_PERSISTENT, global_batch=4, seq_len=32,
                async_ckpt=False)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("arch", CONTEXTS)
def test_context_trainer_four_steps_match_reference(arch, tmp_path):
    """The reduced Trainer over four steps from the reference's initial
    state with every xgate 1 (each step's context or frames from the
    pipeline's seeded ``context_at`` / ``frames_at``): every step's loss
    and lr, then the parameters."""
    mj, mt = _models(arch)
    jt = JTrainer(mj, jadamw.AdamWConfig(),
                  _trainer_config(JTrainerConfig, tmp_path / "j",
                                  ckpt_every=0))
    jt.init()
    jt.state = jt.state._replace(params=jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(_open_gates(p, np.asarray(a))),
        jt.state.params))
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
