"""Selective state-space (Mamba-style) sequence mixer, the port of
``repro.models.ssm``: the mamba half of hymba's hybrid layers.

Prefill and train path: a chunked scan, as the reference's.  A
sequential pass runs over chunks of the sequence and a log-depth scan of
``_ssm_combine`` runs inside each chunk (``_scan``, the work-efficient
Brent–Kung order, in place), so the live (B, chunk, d_inner, N) decay
and state tensors stay bounded while a chunk costs 2 log2(chunk)
levels, not one launch per token.  A chunk is one autograd node
(``_Chunk``) that keeps only its inputs and recomputes its states in the
backward, as the reference remats ``per_chunk`` with
``jax.checkpoint``; its backward is the same scan over the reversed
sequence.  The superblock's own remat policy (``backbone.remat_wrap``)
wraps it like any other node.  (``torch.utils.checkpoint`` around the
chunk's ops recomputes the same, but records every op and packs every
saved tensor on the host, and the scan is host-bound on the card.)

Decode path: one step of the recurrence on the carried (B, d_inner, N)
f32 state; the caller keeps the (B, conv_w - 1, d_inner) convolution
tail.

The scan is plain PyTorch: the reference computes it in XLA, not in a
Pallas kernel, so there is no TPU kernel here to port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _ssm_combine(e1, e2):
    """The scan's operator on (decay, input) pairs, ``e1`` the earlier:
    applying e1 then e2 multiplies by a1 * a2 and adds a2 * b1 + b2."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``_ssm_combine`` over axis 1 of (a, b), earlier
    elements first, in place, outside autograd: the work-efficient
    (Brent–Kung) order.  log2(T) up-sweep levels combine each block's
    last element with its first half's, then log2(T) down-sweep levels
    carry each block's prefix into the element half a block past it, so
    a chunk costs about 2T combines in 2 log2(T) levels.  Returns b, the
    scan's second component; ``a`` is left holding block products (the
    down-sweep needs no prefix product of them)."""
    n = a.shape[1]
    d = 1
    while 2 * d <= n:
        _combine_into(a, b, slice(d - 1, n - d, 2 * d),
                      slice(2 * d - 1, n, 2 * d), True)
        d *= 2
    d //= 2
    while d >= 1:
        if 3 * d - 1 < n:
            _combine_into(a, b, slice(2 * d - 1, n - d, 2 * d),
                          slice(3 * d - 1, n, 2 * d), False)
        d //= 2
    return b


def _combine_into(a, b, early: slice, late: slice, with_a: bool) -> None:
    """(a, b)[late] = _ssm_combine((a, b)[early], (a, b)[late]), in place
    (one fused multiply-add, one multiply), the two slices of axis 1 as
    long as each other."""
    b[:, late].addcmul_(a[:, late], b[:, early])
    if with_a:
        a[:, late].mul_(a[:, early])


def depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                   tail: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv1d.

    x: (B, S, C); w: (C, K).  tail: (B, K-1, C) state from the previous
    segment (zeros for a fresh sequence).  Returns (y, new_tail): y in x's
    dtype from f32 sums, new_tail the last K-1 inputs."""
    b, s, c = x.shape
    k = w.shape[1]
    if tail is None:
        tail = x.new_zeros((b, k - 1, c))
    xp = torch.cat([tail, x], 1)                       # (B, S+K-1, C)
    y = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xp[:, i:i + s].float() * w[:, i].float()
    return y.to(x.dtype), xp[:, s:]


def _chunk_states(state, dtf, xf, bf, a):
    """A chunk's decay (B, ch, C, N) and its states h, h[t] = decay[t] *
    h[t-1] + dt[t] x[t] b[t] from h[-1] = state: the carried state
    combined into the first element, then ``_scan``."""
    decay = torch.exp(dtf[..., None] * a)
    h = (dtf * xf)[..., None] * bf[:, :, None, :]
    _, h[:, 0] = _ssm_combine((1.0, state), (decay[:, 0], h[:, 0]))
    _scan(decay.clone(), h)
    return decay, h


class _Chunk(torch.autograd.Function):
    """One chunk (B, ch, ...) from the carried f32 state: (its last state,
    y (B, ch, C) f32).  It keeps only its inputs and recomputes the
    chunk's (B, ch, C, N) tensors in the backward, as the reference's
    ``jax.checkpoint(per_chunk)`` does.  The backward is the reverse
    recurrence G[t] = gh[t] + decay[t+1] G[t+1] of the states' gradient
    gh (from y and the last state), the same scan over the reversed
    sequence, then each input's gradient in closed form."""

    @staticmethod
    def forward(ctx, state, xc, dtc, bc, cc, a, d_skip):
        xf, dtf = xc.float(), dtc.float()
        _, h = _chunk_states(state, dtf, xf, bc.float(), a)
        y = torch.einsum("btcn,btn->btc", h, cc.float()) + xf * d_skip.float()
        ctx.save_for_backward(state, xc, dtc, bc, cc, a, d_skip)
        return h[:, -1].clone(), y

    @staticmethod
    def backward(ctx, g_last, gy):
        state, xc, dtc, bc, cc, a, d_skip = ctx.saved_tensors
        xf, dtf, bf, cf = xc.float(), dtc.float(), bc.float(), cc.float()
        decay, h = _chunk_states(state, dtf, xf, bf, a)
        g = (gy[..., None] * cf[:, :, None, :]).flip(1)
        g[:, 0] += g_last
        # reversed coefficients: the element s of the reversed sequence
        # carries decay[T - s] back from its predecessor
        rc = torch.empty_like(decay)
        rc[:, 0] = 1.0
        rc[:, 1:] = decay[:, 1:].flip(1)
        _scan(rc, g)
        g = g.flip(1)                                  # G, the states' grad
        # through decay = exp(dt * a): G[t] * h[t-1] * decay[t]
        gd = torch.empty_like(g)
        gd[:, 1:] = g[:, 1:] * h[:, :-1]
        gd[:, 0] = g[:, 0] * state
        gd *= decay
        gb = torch.einsum("btcn,btn->btc", g, bf)       # sum_n G b
        g_x = gy * d_skip.float() + dtf * gb
        g_dt = xf * gb + torch.einsum("btcn,cn->btc", gd, a)
        g_b = torch.einsum("btcn,btc->btn", g, dtf * xf)
        g_c = torch.einsum("btcn,btc->btn", h, gy)
        g_a = torch.einsum("btcn,btc->cn", gd, dtf)
        g_d = (gy * xf).sum((0, 1))
        return (decay[:, 0] * g[:, 0], g_x.to(xc.dtype), g_dt.to(dtc.dtype),
                g_b.to(bc.dtype), g_c.to(cc.dtype), g_a.to(a.dtype),
                g_d.to(d_skip.dtype))


def ssm_scan(x_in: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, d_skip: torch.Tensor,
             state0: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan.

    x_in:  (B, S, C)   post-conv activations (C = d_inner)
    dt:    (B, S, C)   positive step sizes (softplus already applied)
    a_log: (C, N)      log of -A (A = -exp(a_log))
    bmat:  (B, S, N)   input->state projection coefficients
    cmat:  (B, S, N)   state->output coefficients
    d_skip:(C,)        skip connection
    state0:(B, C, N)   initial state
    Returns (y (B, S, C) f32 -> x_in's dtype, final state (B, C, N) f32).
    The chunk is ``min(chunk, S)``, the whole sequence when that does not
    divide S (the reference's rule)."""
    b, s, c = x_in.shape
    ch = min(chunk, s)
    if s % ch:
        ch = s
    a = -torch.exp(a_log.float())                      # (C, N), negative
    state = state0.float()
    ys = []
    for i in range(0, s, ch):
        sl = slice(i, i + ch)
        state, y = _Chunk.apply(state, x_in[:, sl], dt[:, sl], bmat[:, sl],
                                cmat[:, sl], a, d_skip)
        ys.append(y)
    return torch.cat(ys, 1).to(x_in.dtype), state


def ssm_step(x_t: torch.Tensor, dt_t: torch.Tensor, a_log: torch.Tensor,
             b_t: torch.Tensor, c_t: torch.Tensor, d_skip: torch.Tensor,
             state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x_t/dt_t: (B, C); b_t/c_t: (B, N); state: (B, C,
    N).  Returns (y (B, C) in x_t's dtype, the new f32 state)."""
    a = -torch.exp(a_log.float())
    dtf = dt_t.float()
    decay = torch.exp(dtf[..., None] * a)              # (B, C, N)
    inp = (dtf * x_t.float())[..., None] * b_t[:, None, :].float()
    _, new_state = _ssm_combine((1.0, state.float()), (decay, inp))
    y = torch.einsum("bcn,bn->bc", new_state, c_t.float())
    y = y + x_t.float() * d_skip.float()
    return y.to(x_t.dtype), new_state
