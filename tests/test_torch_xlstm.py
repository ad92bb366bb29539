"""The xLSTM mixers (``repro_torch.models.xlstm``) against the reference's
``repro.models.xlstm`` on the CPU, on inputs drawn from a seeded numpy
generator: ``mlstm_chunkwise`` at chunk 16 over 32 tokens (two chunks,
each recomputed in its backward) and over 20 (the chunk rule's fallback
to one chunk of 20) from a non-zero state, ``mlstm_step`` and a chunkwise
run then a step against the run one token longer; ``slstm_scan`` from the
zero and a non-zero state and ``slstm_step``; every gradient against
``jax.grad`` (through the reference's custom VJP for the sLSTM scan).
f32 outputs and states within 1e-5 of their largest |value|, gradients
within 1e-5 of each input's largest |gradient| (f32 precision: the
port's sLSTM backward rounds each step's recurrent cotangent to bf16 as
the reference's does, so its ``dr`` is the reference's, not plain
autograd's, which it leaves by more than 1e-6 and less than the
reference's own 5e-3).  A first sLSTM step from the zero state whose input
gate wins gives ``n_new`` exactly 1, a tie of ``max(n_new, 1)``: its
gradient takes half there, as JAX's does.  bf16 inputs against the
reference's bf16 run within 2e-2.  The layers and the model are
``test_torch_xlstm_model.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JX
from repro_torch.models import xlstm as TX

B, H, DK, DV, DH = 2, 3, 8, 16, 8
TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-5, 2e-2


def _rel(got, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _mlstm_inputs(s: int, seed: int = 0) -> list:
    """q, k, v, i_pre, f_pre (forget gates biased open, as a trained model
    keeps them) and a non-zero state c, n, m, f32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return [f(B, s, H, DK), f(B, s, H, DK), f(B, s, H, DV), f(B, s, H),
            f(B, s, H) + 2.0, 0.3 * f(B, H, DK, DV), 0.3 * f(B, H, DK),
            0.5 * f(B, H)]


def _slstm_inputs(s: int, zero_state: bool, seed: int = 1) -> list:
    """pre (B, S, 4, H, Dh), r (4, H, Dh, Dh) and a state c, n, h, m
    (zeros, or n > 0 as a run leaves it), f32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    st = [np.zeros((B, H, DH), np.float32)] * 4 if zero_state else [
        0.5 * f(B, H, DH), np.abs(f(B, H, DH)) + 0.5, 0.5 * f(B, H, DH),
        0.5 * f(B, H, DH)]
    return [0.5 * f(B, s, 4, H, DH), 0.3 * f(4, H, DH, DH)] + st


def _mlstm_loss(mod, ins, chunk=16):
    """A scalar of mlstm_chunkwise's output and every final-state leaf."""
    sum_ = jnp.sum if mod is JX else torch.sum
    sin = jnp.sin if mod is JX else torch.sin
    y, st = mod.mlstm_chunkwise(*ins[:5], mod.MLSTMState(*ins[5:]),
                                chunk=chunk)
    return sum_(sin(y)) + sum_(st.c * 0.3) + sum_(st.n) + sum_(st.m * 0.2)


def _slstm_loss(mod, ins):
    sum_ = jnp.sum if mod is JX else torch.sum
    sin = jnp.sin if mod is JX else torch.sin
    hs, st = mod.slstm_scan(ins[0], ins[1], mod.SLSTMState(*ins[2:]))
    return (sum_(sin(hs)) + sum_(st.c * 0.3) + sum_(st.n * 0.2)
            + sum_(st.h) + sum_(st.m * 0.1))


def _torch_leaves(ins) -> list:
    return [torch.from_numpy(np.array(a)).requires_grad_() for a in ins]


@pytest.mark.parametrize("s", [32, 20])
def test_mlstm_chunkwise_matches_reference(s):
    """Outputs and final state from a non-zero state: two chunks of 16
    (32), one chunk of 20 (20 % 16 != 0)."""
    ins = _mlstm_inputs(s)
    jy, jst = JX.mlstm_chunkwise(*map(jnp.asarray, ins[:5]),
                                 JX.MLSTMState(*map(jnp.asarray, ins[5:])),
                                 chunk=16)
    ty, tst = TX.mlstm_chunkwise(*map(torch.from_numpy, ins[:5]),
                                 TX.MLSTMState(*map(torch.from_numpy,
                                                    ins[5:])), chunk=16)
    assert ty.shape == (B, s, H, DV) and ty.dtype == torch.float32
    assert _rel(ty, jy) <= TOL
    for a, b in zip(tst, jst):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("s", [32, 20])
def test_mlstm_chunkwise_grads_match_reference(s):
    ins = _mlstm_inputs(s, seed=2)
    want = jax.grad(lambda *a: _mlstm_loss(JX, a), tuple(range(8)))(
        *map(jnp.asarray, ins))
    leaves = _torch_leaves(ins)
    _mlstm_loss(TX, leaves).backward()
    for t, g in zip(leaves, want):
        assert _rel(t.grad, g) <= GRAD_TOL


def test_mlstm_step_and_chunkwise_then_step():
    """One decode step against the reference's; a 32-token chunkwise run
    and a step at token 32 against the chunkwise run over 33 tokens (one
    chunk of 33: the fallback)."""
    ins = _mlstm_inputs(33, seed=3)
    st = TX.MLSTMState(*map(torch.from_numpy, ins[5:]))
    step = [torch.from_numpy(a[:, 0]) for a in ins[:5]]
    ty, tst = TX.mlstm_step(*step, st)
    jy, jst = JX.mlstm_step(*(jnp.asarray(a[:, 0]) for a in ins[:5]),
                            JX.MLSTMState(*map(jnp.asarray, ins[5:])))
    assert _rel(ty, jy) <= TOL
    for a, b in zip(tst, jst):
        assert _rel(a, b) <= TOL
    full, fst = TX.mlstm_chunkwise(*map(torch.from_numpy, ins[:5]), st,
                                   chunk=16)
    _, mid = TX.mlstm_chunkwise(*(torch.from_numpy(a[:, :32])
                                  for a in ins[:5]), st, chunk=16)
    y, last = TX.mlstm_step(*(torch.from_numpy(a[:, 32]) for a in ins[:5]),
                            mid)
    assert _rel(y, full[:, 32].numpy()) <= TOL
    for a, b in zip(last, fst):
        assert _rel(a, b.numpy()) <= TOL


@pytest.mark.parametrize("zero_state", [True, False])
def test_slstm_scan_and_step_match_reference(zero_state):
    """The scan's h sequence (f32) and final state, and one step from the
    same state."""
    ins = _slstm_inputs(10, zero_state)
    th, tst = TX.slstm_scan(torch.from_numpy(ins[0]),
                            torch.from_numpy(ins[1]),
                            TX.SLSTMState(*map(torch.from_numpy, ins[2:])))
    jh, jst = JX.slstm_scan(jnp.asarray(ins[0]), jnp.asarray(ins[1]),
                            JX.SLSTMState(*map(jnp.asarray, ins[2:])))
    assert th.shape == (B, 10, H, DH) and th.dtype == torch.float32
    assert _rel(th, jh) <= TOL
    for a, b in zip(tst, jst):
        assert _rel(a, b) <= TOL
    st = TX.SLSTMState(*map(torch.from_numpy, ins[2:]))
    h1, st1 = TX.slstm_step(torch.from_numpy(ins[0][:, 0]),
                            torch.from_numpy(ins[1]), st)
    jh1, jst1 = JX.slstm_step(jnp.asarray(ins[0][:, 0]), jnp.asarray(ins[1]),
                              JX.SLSTMState(*map(jnp.asarray, ins[2:])))
    assert _rel(h1, jh1) <= TOL
    for a, b in zip(st1, jst1):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("zero_state", [True, False])
def test_slstm_scan_grads_match_reference_custom_vjp(zero_state):
    """Every gradient (pre, r and the initial state) against jax.grad
    through the reference's custom VJP, at f32 precision."""
    ins = _slstm_inputs(10, zero_state, seed=4)
    want = jax.grad(lambda *a: _slstm_loss(JX, a), tuple(range(6)))(
        *map(jnp.asarray, ins))
    leaves = _torch_leaves(ins)
    _slstm_loss(TX, leaves).backward()
    for t, g in zip(leaves, want):
        assert _rel(t.grad, g) <= GRAD_TOL


def test_slstm_dr_keeps_the_bf16_rounding():
    """The recurrent weights' gradient contracts each step's cotangent
    rounded to bf16: the port's ``dr`` equals the reference's at f32
    precision and leaves plain autograd through a loop of
    ``_slstm_cell`` by more than 1e-6 and less than 5e-3 of its largest
    |value| (the reference's own bound, tests/test_models.py)."""
    ins = _slstm_inputs(10, True, seed=5)
    want = jax.grad(lambda *a: _slstm_loss(JX, a), (1,))(
        *map(jnp.asarray, ins))[0]
    leaves = _torch_leaves(ins)
    _slstm_loss(TX, leaves).backward()
    got = leaves[1].grad
    pre, r = (torch.from_numpy(a).requires_grad_() for a in ins[:2])
    st = TX.slstm_init_state(B, H, DH)
    hs = []
    for t in range(10):
        st = TX._slstm_cell(st, pre[:, t], r)
        hs.append(st.h)
    loss = (torch.sin(torch.stack(hs, 1)).sum() + (st.c * 0.3).sum()
            + (st.n * 0.2).sum() + st.h.sum() + (st.m * 0.1).sum())
    plain = torch.autograd.grad(loss, r)[0]
    assert _rel(got, want) <= GRAD_TOL
    off = _rel(got, plain.numpy())
    assert 1e-6 < off < 5e-3, off


def test_slstm_first_step_tie_takes_half_the_gradient():
    """From the zero state with every input gate at or above its forget
    gate, the first step's ``n_new = exp(ip - max(fp, ip))`` is exactly
    1.0, so ``max(n_new, 1)`` ties: JAX gives each side half the
    gradient.  The port's scan and its differentiable cell give JAX's
    gradient; a rule with the whole gradient (``clamp_min``) would not."""
    assert float(jax.grad(lambda x: jnp.maximum(x, 1.0))(1.0)) == 0.5
    ins = _slstm_inputs(1, True, seed=6)
    pre = ins[0]
    pre[:, :, 1] = np.abs(pre[:, :, 1]) + 0.1          # ip > 0
    pre[:, :, 2] = -np.abs(pre[:, :, 2])               # fp <= 0 < ip
    ins[1] = np.zeros_like(ins[1])                      # h0 = 0: rec = 0
    _, tst = TX.slstm_scan(torch.from_numpy(pre), torch.from_numpy(ins[1]),
                           TX.slstm_init_state(B, H, DH))
    assert bool((tst.n == 1.0).all())
    want = jax.grad(lambda *a: _slstm_loss(JX, a), (0,))(
        *map(jnp.asarray, ins))[0]
    leaves = _torch_leaves(ins)
    _slstm_loss(TX, leaves).backward()
    assert _rel(leaves[0].grad, want) <= GRAD_TOL
    # the differentiable cell (decode's path) follows the same rule
    p = torch.from_numpy(pre[:, 0]).requires_grad_()
    st = TX._slstm_cell(TX.slstm_init_state(B, H, DH), p,
                        torch.from_numpy(ins[1]))
    (torch.sin(st.h).sum() + (st.c * 0.3).sum() + (st.n * 0.2).sum()
     + st.h.sum() + (st.m * 0.1).sum()).backward()
    assert _rel(p.grad, np.asarray(want)[:, 0]) <= GRAD_TOL
    # the whole gradient at the tie differs: the f and i gates' share
    # of n's gradient through max(n_new, 1)
    nn = torch.ones(3, requires_grad=True)
    torch.maximum(nn, torch.ones(())).sum().backward()
    assert nn.grad.tolist() == [0.5] * 3
    nn2 = torch.ones(3, requires_grad=True)
    nn2.clamp_min(1.0).sum().backward()
    assert nn2.grad.tolist() == [1.0] * 3


def test_bf16_inputs_match_reference_bf16():
    """bf16 inputs: mLSTM's y comes back in bf16 (its state f32), the
    sLSTM's h in f32 and its pre gradient in bf16; each within 2e-2 of
    the reference's own bf16 run."""
    ins = _mlstm_inputs(32, seed=7)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in ins[:5]]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in ins[:5]]
    jy, jst = JX.mlstm_chunkwise(*jb, JX.MLSTMState(
        *map(jnp.asarray, ins[5:])), chunk=16)
    ty, tst = TX.mlstm_chunkwise(*tb, TX.MLSTMState(
        *map(torch.from_numpy, ins[5:])), chunk=16)
    assert ty.dtype == torch.bfloat16 and tst.c.dtype == torch.float32
    assert _rel(ty, jy) <= BF16_TOL
    for a, b in zip(tst, jst):
        assert _rel(a, b) <= BF16_TOL
    sins = _slstm_inputs(10, True, seed=8)
    pre16 = torch.from_numpy(sins[0]).to(torch.bfloat16).requires_grad_()
    r = torch.from_numpy(sins[1]).requires_grad_()
    th, _ = TX.slstm_scan(pre16, r, TX.slstm_init_state(B, H, DH))
    assert th.dtype == torch.float32
    torch.sin(th).sum().backward()
    assert pre16.grad.dtype == torch.bfloat16
    jpre = jnp.asarray(sins[0], jnp.bfloat16)

    def jloss(p, rr):
        return jnp.sum(jnp.sin(JX.slstm_scan(
            p, rr, JX.slstm_init_state(B, H, DH))[0]))
    jh, _ = JX.slstm_scan(jpre, jnp.asarray(sins[1]),
                          JX.slstm_init_state(B, H, DH))
    assert _rel(th, jh) <= BF16_TOL
    gp, gr = jax.grad(jloss, (0, 1))(jpre, jnp.asarray(sins[1]))
    assert _rel(pre16.grad, gp) <= BF16_TOL
    assert _rel(r.grad, gr) <= BF16_TOL

