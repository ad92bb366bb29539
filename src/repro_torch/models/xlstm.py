"""xLSTM sequence mixers, mLSTM (matrix memory) and sLSTM (scalar
memory): the port of ``repro.models.xlstm``.

mLSTM, prefill and train: the chunkwise-parallel form.  Within a chunk,
triangular attention in stabilized log-decay space; across chunks, the
(B, H, Dk, Dv) matrix state, carried by a loop over the chunks as the
reference's ``lax.scan`` carries it.  The chunk body runs in a (B, H,
chunk, ...) layout, so its products are batched matrix products.  With
more than one chunk each chunk is one autograd node (``_ChunkRemat``)
that keeps only its inputs and recomputes its body in the backward, as
the reference remats ``per_chunk`` with ``jax.checkpoint``; a single
chunk is differentiated directly, as there.  The chunk is ``min(chunk,
S)``, the whole sequence when that does not divide S.

sLSTM is sequential over the sequence.  ``slstm_scan`` is one autograd
node (``_SLSTMScan``), the reference's custom VJP: the input projections
are hoisted out of the loop (the caller's ``pre``), and a step is one
batched product of the carried h with the recurrent weights over the H
head blocks, the four gates side by side (``baddbmm`` into that step's
pre-activations, in place), then the gate arithmetic.  A forward step
makes 13 launches; r is cast and laid out once, outside the loop.  The
backward walks the steps in reverse with 11 launches a step (everything
that depends only on the forward's values is computed for all steps at
once before the loop), stacks each step's recurrent cotangent rounded to
bf16 whatever the compute dtype, and contracts that stack with the saved
h sequence in ONE product after the loop for the recurrent weights'
gradient, as the reference does.  h_{t-1}'s share goes back through the
unrounded cotangent.

A maximum's gradient at a tie goes half to each side, as JAX's does
(``torch.maximum``, ``torch.amax``, and the sLSTM backward's weights):
from the zero state the first sLSTM step's ``n_new`` is exactly 1 whenever
its input gate wins, so ``max(n_new, 1)`` ties there.

Decode: ``mlstm_step`` and ``slstm_step`` advance the carried f32 state
by one token.

Both recurrences are plain PyTorch: the reference computes them in XLA,
not in a Pallas kernel, so there is no TPU kernel here to port.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, Dk, Dv) matrix memory (stabilized)
    n: torch.Tensor   # (B, H, Dk) normalizer
    m: torch.Tensor   # (B, H) running log stabilizer


def mlstm_init_state(b: int, h: int, dk: int, dv: int,
                     device=None) -> MLSTMState:
    return MLSTMState(
        c=torch.zeros((b, h, dk, dv), dtype=torch.float32, device=device),
        n=torch.zeros((b, h, dk), dtype=torch.float32, device=device),
        m=torch.zeros((b, h), dtype=torch.float32, device=device))


def _mlstm_chunk(c0, n0, m0, q, k, v, i_pre, f_pre, scale: float):
    """One chunk from the carried state, every input in the (B, H, ch,
    ...) layout: q, k (B, H, ch, Dk), v (B, H, ch, Dv), the gates (B, H,
    ch).  Returns (c, n, m at the chunk's end, y (B, H, ch, Dv) in v's
    dtype); f32 throughout."""
    ch = q.shape[2]
    q = q.float() * scale
    k = k.float()
    v32 = v.float()
    lf = F.logsigmoid(f_pre.float())                   # (B, H, ch)
    li = i_pre.float()
    cum = torch.cumsum(lf, dim=-1)                     # inclusive
    # d[i, j] = cum_i - cum_j + li_j for j <= i (log decay paths)
    d = cum[..., :, None] - cum[..., None, :] + li[..., None, :]
    tri = torch.ones((ch, ch), dtype=torch.bool, device=q.device).tril()
    d = torch.where(tri, d, NEG)                       # (B, H, ch, ch)
    m_intra = torch.amax(d, dim=-1)                    # (B, H, ch)
    m_inter = m0[..., None] + cum
    m_i = torch.maximum(m_intra, m_inter)
    # intra-chunk (triangular) attention in stabilized space
    w = torch.matmul(q, k.transpose(-1, -2)) * torch.exp(d - m_i[..., None])
    y_intra = torch.matmul(w, v32)
    # the carried state's contribution
    dec_q = torch.exp(m_inter - m_i)
    y_inter = torch.matmul(q, c0) * dec_q[..., None]
    n_prev_q = torch.matmul(q, n0[..., None])[..., 0] * dec_q
    # the normalizer: sum_j w_ij is q_i . n_intra
    den = w.sum(-1) + n_prev_q
    y = (y_intra + y_inter) / torch.maximum(den.abs(),
                                            torch.exp(-m_i))[..., None]
    # the state at the chunk's end
    tail = cum[..., -1:] - cum + li                    # (B, H, ch)
    m_end = torch.maximum(m0 + cum[..., -1], torch.amax(tail, dim=-1))
    dec_c = torch.exp(m0 + cum[..., -1] - m_end)       # (B, H)
    kd = k * torch.exp(tail - m_end[..., None])[..., None]
    c_new = c0 * dec_c[..., None, None] + torch.matmul(kd.transpose(-1, -2),
                                                       v32)
    n_new = n0 * dec_c[..., None] + kd.sum(-2)
    return c_new, n_new, m_end, y.to(v.dtype)


class _ChunkRemat(torch.autograd.Function):
    """``_mlstm_chunk`` as one autograd node that keeps only its inputs
    and recomputes the chunk's (B, H, ch, ch) tensors in the backward."""

    @staticmethod
    def forward(ctx, scale, *ins):
        ctx.scale = scale
        ctx.save_for_backward(*ins)
        return _mlstm_chunk(*ins, scale)

    @staticmethod
    def backward(ctx, *grads):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
        with torch.enable_grad():
            outs = _mlstm_chunk(*ins, ctx.scale)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wrt = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wrt, [g for _, g in pairs],
                                       allow_unused=True))
        return (None,) + tuple(next(got) if t.requires_grad else None
                               for t in ins)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor,
                    state: MLSTMState, *, chunk: int = 256
                    ) -> Tuple[torch.Tensor, MLSTMState]:
    """q, k: (B, S, H, Dk); v: (B, S, H, Dv); i_pre, f_pre: (B, S, H) gate
    pre-activations.  Returns (y (B, S, H, Dv) in v's dtype, the final
    f32 state)."""
    b, s, h, dk = q.shape
    ch = min(chunk, s)
    if s % ch:
        ch = s
    scale = dk ** -0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, .)
    it, ft = (t.transpose(1, 2) for t in (i_pre, f_pre))  # (B, H, S)
    c, n, m = state
    if ch == s:
        c, n, m, y = _mlstm_chunk(c, n, m, qt, kt, vt, it, ft, scale)
        return y.transpose(1, 2), MLSTMState(c, n, m)
    ys = []
    for i in range(0, s, ch):
        sl = slice(i, i + ch)
        c, n, m, y = _ChunkRemat.apply(scale, c, n, m, qt[:, :, sl],
                                       kt[:, :, sl], vt[:, :, sl],
                                       it[..., sl], ft[..., sl])
        ys.append(y)
    return torch.cat(ys, 2).transpose(1, 2), MLSTMState(c, n, m)


def mlstm_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor,
               state: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """One decode step.  q, k: (B, H, Dk); v: (B, H, Dv); gates (B, H).
    Returns (y (B, H, Dv) in v's dtype, the new f32 state)."""
    dk = q.shape[-1]
    qf = q.float() * dk ** -0.5
    kf, vf = k.float(), v.float()
    lf = F.logsigmoid(f_pre.float())
    li = i_pre.float()
    m_new = torch.maximum(lf + state.m, li)
    fg = torch.exp(lf + state.m - m_new)
    ig = torch.exp(li - m_new)
    c_new = state.c * fg[..., None, None] + ig[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n_new = state.n * fg[..., None] + ig[..., None] * kf
    num = torch.matmul(qf[..., None, :], c_new)[..., 0, :]
    den = (qf * n_new).sum(-1)
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return y.to(v.dtype), MLSTMState(c_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, Dh)
    n: torch.Tensor   # (B, H, Dh)
    h: torch.Tensor   # (B, H, Dh)
    m: torch.Tensor   # (B, H, Dh)


def slstm_init_state(b: int, h: int, dh: int, device=None) -> SLSTMState:
    z = torch.zeros((b, h, dh), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, z)


def _slstm_gates(state: SLSTMState, gates, rec) -> SLSTMState:
    """The gate arithmetic with the recurrent contribution precomputed:
    gates, a 4-tuple of (B, H, Dh) f32 pre-activations (z, i, f, o); rec
    (4, B, H, Dh)."""
    zp = gates[0] + rec[0]
    ip = gates[1] + rec[1]
    fp = gates[2] + rec[2]
    op = gates[3] + rec[3]
    z = torch.tanh(zp)
    m_new = torch.maximum(fp + state.m, ip)
    ig = torch.exp(ip - m_new)
    fg = torch.exp(fp + state.m - m_new)
    c_new = fg * state.c + ig * z
    n_new = fg * state.n + ig
    h_new = torch.sigmoid(op) * c_new / torch.maximum(
        n_new, torch.ones((), dtype=n_new.dtype, device=n_new.device))
    return SLSTMState(c_new, n_new, h_new, m_new)


def _split_gates(pre):
    """(B, 4, H, Dh) any dtype -> 4-tuple of (B, H, Dh) f32."""
    return tuple(pre[:, i].float() for i in range(4))


def _slstm_cell(state: SLSTMState, pre, r) -> SLSTMState:
    """pre: (B, 4, H, Dh) this step's gate pre-activations (z, i, f, o);
    r: (4, H, Dh, Dh) block-diagonal recurrent weights."""
    rec = torch.einsum("bhd,ghde->gbhe", state.h, r.float())
    return _slstm_gates(state, _split_gates(pre), rec)


def _half_at_tie(x: torch.Tensor) -> torch.Tensor:
    """1 where x > 0, 0.5 where x == 0, 0 where x < 0: the share of a
    maximum's gradient its first operand takes, x the difference of the
    two."""
    return torch.sign(x).add_(1.0).mul_(0.5)


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence over S steps in an (H, B, ...) layout, the
    four gates of a step side by side: (S, H, B, 4, Dh) pre-activations,
    (S + 1, H, B, Dh) states with the initial one first.  Every per-step
    view the loops read or write is made before the loop, one ``unbind``
    a buffer, so a step makes its launches and no other tensor call."""

    @staticmethod
    def forward(ctx, pre, r, c0, n0, h0, m0):
        b, s, _, nh, dh = pre.shape
        dev = pre.device
        # the step's pre-activations; each step adds its recurrent product
        # in place, so after the loop g holds every step's gates
        g = pre.permute(1, 3, 0, 2, 4).float().contiguous().view(
            s, nh, b, 4, dh)
        rr = r.float().permute(1, 2, 0, 3).reshape(nh, dh, 4 * dh)
        st = [torch.empty((s + 1, nh, b, dh), dtype=torch.float32,
                          device=dev) for _ in range(4)]
        for buf, x0 in zip(st, (c0, n0, h0, m0)):
            buf[0] = x0.transpose(0, 1)
        e = torch.empty((s, nh, b, 2, dh), dtype=torch.float32, device=dev)
        gflat = g.view(s, nh, b, 4 * dh).unbind(0)
        gz, gi, gf, go = (g[:, :, :, i].unbind(0) for i in range(4))
        gif = g[:, :, :, 1:3].unbind(0)
        ig, fg = e[:, :, :, 0].unbind(0), e[:, :, :, 1].unbind(0)
        es = e.unbind(0)
        c, n, hh, m = (x.unbind(0) for x in st)
        mu = st[3].unsqueeze(3).unbind(0)
        for t in range(s):
            u = t + 1
            gflat[t].baddbmm_(hh[t], rr)
            gf[t].add_(m[t])                             # fp + m
            torch.maximum(gf[t], gi[t], out=m[u])
            torch.sub(gif[t], mu[u], out=es[t]).exp_()   # ig, fg
            z = torch.tanh(gz[t])
            o = torch.sigmoid(go[t])
            torch.mul(fg[t], c[t], out=c[u]).addcmul_(ig[t], z)
            torch.addcmul(ig[t], fg[t], n[t], out=n[u])
            torch.mul(o, c[u], out=hh[u]).div_(n[u].clamp_min(1.0))
        ctx.save_for_backward(g, rr, *st)
        ctx.pre_dtype, ctx.r_dtype = pre.dtype, r.dtype
        hs = st[2][1:].permute(2, 0, 1, 3)               # (B, S, H, Dh)
        return (hs,) + tuple(x[s].transpose(0, 1) for x in st)

    @staticmethod
    def backward(ctx, dhs, dc_f, dn_f, dh_f, dm_f):
        g, rr, c, n, hh, m = ctx.saved_tensors
        s, nh, b, _, dh = g.shape
        dev = g.device
        # everything that depends on the forward's values alone, for all
        # steps at once (g's f slot holds fp + m)
        z = torch.tanh(g[:, :, :, 0])
        o = torch.sigmoid(g[:, :, :, 3])
        e = torch.exp(g[:, :, :, 1:3] - m[1:].unsqueeze(3))
        ig, fg = e[:, :, :, 0], e[:, :, :, 1]
        w_n = _half_at_tie(n[1:] - 1.0)                  # max(n_new, 1)
        inv_nd = n[1:].clamp_min(1.0).reciprocal_()
        oh = torch.stack([o, -(hh[1:] * w_n)], 3)        # dc, dn per unit q
        k_z = ig * (1.0 - z * z)
        k_o = c[1:] * o * (1.0 - o)
        p_c = torch.stack([z * ig, c[:-1] * fg], 3)      # (dig, dfg) per dc
        p_n = torch.stack([ig, n[:-1] * fg], 3)          # per dn
        w_a = _half_at_tie(g[:, :, :, 2] - g[:, :, :, 1])
        w = torch.stack([1.0 - w_a, w_a], 3)             # max(fp + m, ip)
        fgu = fg.unsqueeze(3)
        del z, o, e, w_n, w_a
        rr_t = rr.transpose(1, 2).contiguous()
        dhs = dhs.permute(1, 2, 0, 3).float()            # (S, H, B, Dh)

        def buf(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)
        drec = buf(s, nh, b, 4, dh)
        q = buf(s, nh, b, 1, dh)                         # dh / max(n, 1)
        tot = buf(s, nh, b, 2, dh)                       # dc, dn at a step
        dm = buf(s, nh, b, 1, dh)                        # m's, at a step
        dcn = buf(s + 1, nh, b, 2, dh)                   # dc, dn carried
        dcn[s] = torch.stack([dc_f, dn_f], 2).transpose(0, 1)
        # per-step views, made once
        inv_nd, oh, k_z, k_o, p_c, p_n, w, fgu, dhs_t = (
            x.unbind(0) for x in (inv_nd, oh, k_z, k_o, p_c, p_n, w, fgu,
                                  dhs))
        dflat = drec.view(s, nh, b, 4 * dh).unbind(0)
        d0, d3, d2 = (drec[:, :, :, i].unbind(0) for i in (0, 3, 2))
        d12 = drec[:, :, :, 1:3].unbind(0)
        qs, q1 = q.unbind(0), q[:, :, :, 0].unbind(0)
        tots, tc, tc1, tn1 = (tot.unbind(0), tot[:, :, :, 0].unbind(0),
                              tot[:, :, :, 0:1].unbind(0),
                              tot[:, :, :, 1:2].unbind(0))
        dms, dm1 = dm.unbind(0), dm[:, :, :, 0].unbind(0)
        dcns = dcn.unbind(0)
        dmv = dm_f.transpose(0, 1).float()
        dhv = dh_f.transpose(0, 1).float() + dhs_t[s - 1]
        for t in range(s - 1, -1, -1):
            torch.mul(dhv, inv_nd[t], out=q1[t])
            torch.addcmul(dcns[t + 1], qs[t], oh[t], out=tots[t])
            torch.mul(tc[t], k_z[t], out=d0[t])
            torch.mul(q1[t], k_o[t], out=d3[t])
            gm = (tc1[t] * p_c[t]).addcmul_(tn1[t], p_n[t])
            torch.sub(dmv, gm.sum(2), out=dm1[t])
            torch.addcmul(gm, dms[t], w[t], out=d12[t])
            dmv = d2[t]
            torch.mul(tots[t], fgu[t], out=dcns[t])
            dhv = (torch.baddbmm(dhs_t[t - 1], dflat[t], rr_t) if t
                   else torch.bmm(dflat[t], rr_t))
        # the recurrent weights' gradient: the steps' cotangents rounded
        # to bf16, then ONE product with the h each step read
        drec16 = drec.to(torch.bfloat16)
        hp = hh[:-1].permute(1, 3, 0, 2).reshape(nh, dh, s * b)
        dr = torch.bmm(hp, drec16.float().transpose(0, 1).reshape(
            nh, s * b, 4 * dh))                          # (H, Dh, 4 Dh)
        dr = dr.view(nh, dh, 4, dh).permute(2, 0, 1, 3)
        dpre = drec16 if ctx.pre_dtype == torch.bfloat16 else drec
        dpre = dpre.permute(2, 0, 3, 1, 4).to(ctx.pre_dtype)
        return (dpre, dr.to(ctx.r_dtype), dcn[0, :, :, 0].transpose(0, 1),
                dcn[0, :, :, 1].transpose(0, 1), dhv.transpose(0, 1),
                dmv.transpose(0, 1))


def slstm_scan(pre: torch.Tensor, r: torch.Tensor, state: SLSTMState
               ) -> Tuple[torch.Tensor, SLSTMState]:
    """pre: (B, S, 4, H, Dh) gate pre-activations (z, i, f, o); r: (4, H,
    Dh, Dh).  Sequential over S.  Returns (h (B, S, H, Dh) f32, the final
    f32 state)."""
    hs, *st = _SLSTMScan.apply(pre, r, *(x.float() for x in state))
    return hs, SLSTMState(*st)


def slstm_step(pre_t: torch.Tensor, r: torch.Tensor, state: SLSTMState
               ) -> Tuple[torch.Tensor, SLSTMState]:
    """One decode step: pre_t (B, 4, H, Dh).  Returns (h (B, H, Dh) f32,
    the new state)."""
    st2 = _slstm_cell(state, pre_t, r)
    return st2.h, st2
