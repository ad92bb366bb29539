"""The selective state-space mixer (``repro_torch.models.ssm``) against
the reference's ``repro.models.ssm`` on the CPU, f32, on inputs drawn
from a seeded numpy generator: the causal depthwise convolution with and
without a tail, the log-depth scan inside a chunk against
``lax.associative_scan``, a chunk and its reversed backward against
autograd through a sequential loop, the chunked ``ssm_scan`` (chunk 4
over 12 tokens, three chunks, and over 13, where the chunk rule falls
back to one chunk of 13) from a non-zero state, a scan then one
``ssm_step`` against the scan one token longer, and the scan's
gradients against ``jax.grad``.  Outputs and states within 1e-5 of their
largest |value|, gradients within 1e-4 of each input's largest
|gradient|.  The reduced hymba's sequences never reach the multi-chunk
path (its chunk, 128, is longer), so this file holds it at small sizes;
the hybrid layer and the model are ``test_torch_hybrid_model.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.models import ssm as JS
from repro_torch.models import ssm as TS

B, C, N = 2, 6, 4
TOL, GRAD_TOL = 1e-5, 1e-4


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _scan_inputs(s: int, seed: int = 0) -> dict:
    """x, dt (softplus of a normal, as the model's step sizes), a_log
    (the model's init, log 1..N, plus noise), bmat, cmat, d_skip and a
    non-zero state0, as f32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {"x_in": f(B, s, C),
            "dt": np.log1p(np.exp(f(B, s, C) - 1.0)).astype(np.float32),
            "a_log": (np.log(np.arange(1, N + 1, dtype=np.float32))[None]
                      + 0.1 * f(C, N)),
            "bmat": f(B, s, N), "cmat": f(B, s, N), "d_skip": f(C),
            "state0": f(B, C, N)}


def _both(inp: dict):
    return ({k: jnp.asarray(v) for k, v in inp.items()},
            {k: torch.from_numpy(v) for k, v in inp.items()})


@pytest.mark.parametrize("with_tail", [False, True])
def test_depthwise_conv_matches_reference(with_tail):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 9, C)).astype(np.float32)
    w = rng.standard_normal((C, 4)).astype(np.float32)
    tail = rng.standard_normal((B, 3, C)).astype(np.float32) \
        if with_tail else None
    jy, jt = JS.depthwise_conv(jnp.asarray(x), jnp.asarray(w),
                               None if tail is None else jnp.asarray(tail))
    ty, tt = TS.depthwise_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if tail is None else
                               torch.from_numpy(tail))
    assert ty.dtype == torch.float32 and tuple(tt.shape) == (B, 3, C)
    assert _rel(ty, jy) <= TOL
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("length", [1, 2, 3, 5, 8, 13, 16, 17])
def test_log_depth_scan_matches_associative_scan(length):
    """The Brent–Kung scan inside a chunk against the reference's
    ``lax.associative_scan`` of the same combine (its second component,
    the states), at lengths on and off a power of two."""
    rng = np.random.default_rng(length)
    a = rng.uniform(0.2, 1.0, (B, length, C, N)).astype(np.float32)
    b = rng.standard_normal((B, length, C, N)).astype(np.float32)
    _, jb = lax.associative_scan(JS._ssm_combine,
                                 (jnp.asarray(a), jnp.asarray(b)), axis=1)
    tb = TS._scan(torch.tensor(a), torch.tensor(b))
    assert _rel(tb, jb) <= TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1, 2, 7, 16, 33])
def test_chunk_backward_matches_sequential_autograd(length, dtype):
    """One chunk (one autograd node that recomputes its states in the
    backward, whose backward is the scan of the reversed sequence)
    against autograd through the reference's arithmetic in a sequential
    loop over the tokens, from a carried state: y and the last state
    within 1e-5, each input's gradient within 1e-5 of its largest
    |value|; x and dt in ``dtype`` (their gradients in it too)."""
    inp = _scan_inputs(length, seed=length)
    lo = getattr(torch, dtype)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    t["x_in"], t["dt"] = t["x_in"].to(lo), t["dt"].to(lo)
    a = -torch.exp(t["a_log"])
    leaves = [t["state0"], t["x_in"], t["dt"], t["bmat"], t["cmat"], a,
              t["d_skip"]]
    leaves = [x.clone().requires_grad_() for x in leaves]
    rng = np.random.default_rng(length + 1)
    r = torch.from_numpy(rng.standard_normal((B, length, C)).astype(
        np.float32))
    q = torch.from_numpy(rng.standard_normal((B, C, N)).astype(np.float32))
    last, y = TS._Chunk.apply(*leaves)
    got = torch.autograd.grad((y * r).sum() + (last * q).sum(), leaves)
    s0, x, dt, bm, cm, aa, d = leaves
    prev, ys = s0, []
    for i in range(length):
        dtf, xf = dt[:, i].float(), x[:, i].float()
        prev = torch.exp(dtf[..., None] * aa) * prev \
            + (dtf * xf)[..., None] * bm[:, i, None, :]
        ys.append(torch.einsum("bcn,bn->bc", prev, cm[:, i]) + xf * d)
    want_y = torch.stack(ys, 1)
    want = torch.autograd.grad((want_y * r).sum() + (prev * q).sum(),
                               leaves)
    assert _rel(y, want_y.detach().numpy()) <= TOL
    assert _rel(last, prev.detach().numpy()) <= TOL
    for g, w, x in zip(got, want, leaves):
        assert g.dtype == x.dtype
        assert _rel(g.float(), w.float().numpy()) <= TOL


@pytest.mark.parametrize("s", [12, 13])
def test_ssm_scan_matches_reference(s):
    """chunk 4: three chunks of 4 at s = 12; at s = 13 the rule's
    fallback, one chunk of 13.  y and the final state from a non-zero
    state0."""
    ji, ti = _both(_scan_inputs(s))
    jy, jst = JS.ssm_scan(**ji, chunk=4)
    ty, tst = TS.ssm_scan(**ti, chunk=4)
    assert ty.dtype == torch.float32 and tst.dtype == torch.float32
    assert tuple(ty.shape) == (B, s, C) and tuple(tst.shape) == (B, C, N)
    assert _rel(ty, jy) <= TOL and _rel(tst, jst) <= TOL


@pytest.mark.parametrize("s", [12, 13])
def test_scan_then_step_matches_longer_scan(s):
    """A scan of s tokens, then ``ssm_step`` on token s from its final
    state: the step's y and state against the reference's scan of s + 1
    tokens (its last y, its final state), and against the port's own."""
    inp = _scan_inputs(s + 1, seed=3)
    ji, ti = _both(inp)
    jy, jst = JS.ssm_scan(**ji, chunk=4)
    ty_long, tst_long = TS.ssm_scan(**ti, chunk=4)
    head = {k: (v[:, :s] if k in ("x_in", "dt", "bmat", "cmat") else v)
            for k, v in ti.items()}
    _, st = TS.ssm_scan(**head, chunk=4)
    y1, st1 = TS.ssm_step(ti["x_in"][:, s], ti["dt"][:, s], ti["a_log"],
                          ti["bmat"][:, s], ti["cmat"][:, s], ti["d_skip"],
                          st)
    # the reference's own step from the reference's state agrees too
    _, jst_s = JS.ssm_scan(**{k: (v[:, :s] if k in ("x_in", "dt", "bmat",
                                                    "cmat") else v)
                              for k, v in ji.items()}, chunk=4)
    jy1, jst1 = JS.ssm_step(ji["x_in"][:, s], ji["dt"][:, s], ji["a_log"],
                            ji["bmat"][:, s], ji["cmat"][:, s],
                            ji["d_skip"], jst_s)
    assert _rel(y1, jy[:, s]) <= TOL and _rel(st1, jst) <= TOL
    assert _rel(y1, jy1) <= TOL and _rel(st1, jst1) <= TOL
    assert _rel(y1, ty_long[:, s].numpy()) <= TOL
    assert _rel(st1, tst_long.numpy()) <= TOL


@pytest.mark.parametrize("s", [12, 13])
def test_ssm_scan_gradients_match_jax_grad(s):
    """The gradient of ``sum(y * r) + sum(state * q)`` with respect to
    every input, the chunks recomputed in the backward at s = 12, against
    ``jax.grad`` of the reference's scan."""
    inp = _scan_inputs(s, seed=5)
    rng = np.random.default_rng(6)
    r = rng.standard_normal((B, s, C)).astype(np.float32)
    q = rng.standard_normal((B, C, N)).astype(np.float32)
    names = list(inp)

    def jloss(*args):
        y, st = JS.ssm_scan(*args, chunk=4)
        return jnp.sum(y * r) + jnp.sum(st * q)
    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(inp[k]) for k in names))
    leaves = [torch.from_numpy(inp[k]).requires_grad_() for k in names]
    y, st = TS.ssm_scan(*leaves, chunk=4)
    loss = (y * torch.from_numpy(r)).sum() + (st * torch.from_numpy(q)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(names, got, want):
        assert _rel(g, w) <= GRAD_TOL, name


def test_ssm_scan_rounds_to_the_input_dtype():
    """A bf16 input gives a bf16 y and an f32 state; the state is the f32
    scan's of the same (bf16-rounded) values."""
    inp = _scan_inputs(12, seed=8)
    ti = {k: torch.from_numpy(v) for k, v in inp.items()}
    lo = dict(ti, x_in=ti["x_in"].bfloat16(), dt=ti["dt"].bfloat16())
    y, st = TS.ssm_scan(**lo, chunk=4)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    y32, st32 = TS.ssm_scan(**dict(ti, x_in=lo["x_in"].float(),
                                   dt=lo["dt"].float()), chunk=4)
    assert torch.equal(y, y32.bfloat16()) and torch.equal(st, st32)
