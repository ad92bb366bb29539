"""The design of csrc/flash_attention_bwd.cu, checked on the CPU.

The kernels cannot run here (no card, no nvcc), so these tests hold
models of what they compute.  A tile-by-tile torch model of the bf16
kernels keeps bf16 Q, K, V and dO, takes f32 products and rounds P^T, dS^T
(the dK/dV kernel) and dS (the dQ kernel) to bf16 where the kernels do,
after the softcap's factor, walking the tiles in the kernels' order with
their blocks (128 keys or rows, 64 at head width 256), their causal and
window skips and their edge masks; every tile it skips must hold no
visible pair, and every tile it leaves unmasked no hidden one.  It is
held within 2e-2 of the largest |grad| (bf16: the rounding of P and dS
before the products they feed, and of each output) against ``jax.vjp`` of
the reference's ``blockwise_attention`` in f32 on the same bf16-rounded
inputs, and against ``flash_attention_bwd_plain``.  The plain backward
with a window and a softcap is held against ``jax.vjp`` in f32 within
1e-4 of the largest |grad|.  A model of the Di pass's summation order is
held against the plain formula on ragged rows.  ``chip_smoke.py`` holds
the kernels themselves against the plain version on the card.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA

TOL = 2e-2          # of the largest |grad|: bf16 P, dS and outputs
F32_TOL = 1e-4      # of the largest |grad|: f32 sums in another order
BT = 64             # the bf16 kernels' streamed tile rows


def _blocks(d):
    """(keys of a dK/dV block, rows of a dQ block) of the bf16 kernels:
    two warpgroups of 64 each, or at D = 256 both on the same 64, each
    owning a 128-column half of the output."""
    return (64, 64) if d > 128 else (128, 128)


def _bf16_inputs(h, g, sq, skv, d, seed):
    """q, k, v, dO drawn with numpy, rounded to bf16."""
    rng = np.random.default_rng(seed)
    shapes = ((h, sq, d), (h // g, skv, d), (h // g, skv, d), (h, sq, d))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16() for s in shapes]


def _jax_grads(q, k, v, do, g, causal, window=0, softcap=0.0):
    """jax.vjp of the reference layer in f32, the kernel's (H, S, D) heads
    as the layer's (B=1, S, K=H/G, G, D)."""
    h, sq, d = q.shape

    def layer(q, k, v):
        q5 = q.reshape(h // g, g, sq, d).transpose(2, 0, 1, 3)[None]
        out = jlayers.blockwise_attention(q5, k.transpose(1, 0, 2)[None],
                                          v.transpose(1, 0, 2)[None],
                                          causal=causal, window=window,
                                          softcap=softcap)
        return out[0].transpose(1, 2, 0, 3).reshape(h, sq, d)

    @jax.jit
    def vjp(q, k, v, do):
        return jax.vjp(layer, q, k, v)[1](do)

    args = [t.float().numpy() if isinstance(t, torch.Tensor) else t
            for t in (q, k, v, do)]
    return [np.asarray(x) for x in vjp(*args)]


def _visible(qpos, kpos, causal, window):
    keep = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                      dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= qpos - kpos < window
    return keep


def _probs(raw, lse, scale, softcap):
    """P = exp(capped score - lse) of raw products q.k and the cap's
    factor 1 - tanh^2 (1 without a cap), as the kernels compute them."""
    if softcap:
        t = torch.tanh(raw * scale / softcap)
        return torch.exp(softcap * t - lse), 1.0 - t * t
    return torch.exp(raw * scale - lse), 1.0


def _bf16_kernel_model(q, k, v, o, do, lse, causal, window=0, softcap=0.0):
    """(dq, dk, dv) in bf16 as the bf16 kernels compute them: Di once from
    the bf16 o and dO; dK/dV blocks of ``_blocks(d)[0]`` keys, a
    warpgroup's 64 keys walking the group's heads and their BT-query tiles
    from the block's first visible tile (causal) to the tile of its last
    key + window - 1, skipping tiles wholly above or past its keys; dQ
    blocks of ``_blocks(d)[1]`` rows, a warpgroup's 64 rows walking BT-key
    tiles from the block's first row's first key in the window to its
    diagonal, skipping tiles wholly above or below its rows.  Products in
    f32 of bf16 values; P^T, dS^T and dS rounded to bf16 before the
    products they feed, dS after the cap's factor; dK and dQ scaled in f32
    at the end.  Each skipped tile must hold no visible pair and each
    unmasked one no hidden pair."""
    h, sq, d = q.shape
    hk, skv = k.shape[:2]
    g = h // hk
    bn, qr = _blocks(d)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    di = (do.float() * o.float()).sum(-1)
    n_mt = -(-sq // BT)
    dk = torch.zeros(hk, skv, d)
    dv = torch.zeros(hk, skv, d)
    for kh in range(hk):
        for n0 in range(0, skv, bn):
            m_first = n0 // BT if causal else 0
            m_end = min(n_mt, (min(n0 + bn, skv) - 1 + window - 1) // BT
                        + 1) if window else n_mt
            for kb in range(n0, n0 + bn, 64):
                if kb >= skv:
                    continue
                keys = torch.arange(kb, min(kb + 64, skv))[:, None]
                kt = kf[kh, kb:kb + 64]
                vt = vf[kh, kb:kb + 64]
                for hh in range(kh * g, kh * g + g):
                    for mt in range(n_mt):
                        m0 = mt * BT
                        qpos = torch.arange(m0, min(m0 + BT, sq))[None, :]
                        vis = _visible(qpos, keys, causal, window)
                        if not m_first <= mt < m_end or \
                                (causal and kb > m0 + BT - 1) or \
                                (window and m0 - (kb + 63) >= window):
                            assert not vis.any()
                            continue
                        qt, dot = qf[hh, m0:m0 + BT], dof[hh, m0:m0 + BT]
                        pt, fac = _probs(kt @ qt.T, lse[hh, m0:m0 + BT]
                                         [None, :], scale, softcap)
                        if (causal and kb + 63 > m0) or \
                                (window and m0 + BT - 1 - kb >= window):
                            pt = torch.where(vis, pt, 0.0)
                        else:
                            assert vis.all()
                        dst = pt * (vt @ dot.T - di[hh, m0:m0 + BT][None, :])
                        dst = dst * fac
                        dv[kh, kb:kb + 64] += pt.bfloat16().float() @ dot
                        dk[kh, kb:kb + 64] += dst.bfloat16().float() @ qt
    dq = torch.zeros(h, sq, d)
    for hh in range(h):
        kh = hh // g
        for q0 in range(0, sq, qr):
            kv_end = min(skv, q0 + qr) if causal else skv
            t_first = max(0, q0 - window + 1) // BT if window else 0
            for first in range(q0, q0 + qr, 64):
                if first >= sq:
                    continue
                qt, dot = qf[hh, first:first + 64], dof[hh, first:first + 64]
                rows = torch.arange(first, first + len(qt))[:, None]
                for k0 in range(0, skv, BT):
                    kpos = torch.arange(k0, min(k0 + BT, skv))[None, :]
                    vis = _visible(rows, kpos, causal, window)
                    if not t_first * BT <= k0 < kv_end or \
                            (causal and k0 > first + 63) or \
                            (window and first - (k0 + BT - 1) >= window):
                        assert not vis.any()
                        continue
                    kt, vt = kf[kh, k0:k0 + BT], vf[kh, k0:k0 + BT]
                    p, fac = _probs(qt @ kt.T, lse[hh, first:first + 64]
                                    [:, None], scale, softcap)
                    if k0 + BT > skv or (causal and k0 + BT - 1 > first) \
                            or (window and first + 63 - k0 >= window):
                        p = torch.where(vis, p, 0.0)
                    else:
                        assert vis.all()
                    ds = p * (dot @ vt.T - di[hh, first:first + 64][:, None])
                    ds = ds * fac
                    dq[hh, first:first + 64] += ds.bfloat16().float() @ kt
    return ((dq * scale).bfloat16(), (dk * scale).bfloat16(),
            dv.bfloat16())


def _rel_err(got, want):
    top = max(float(np.abs(np.asarray(w, np.float32)).max()) for w in want)
    return max(float(np.abs(a.float().numpy() - np.asarray(b, np.float32))
                     .max()) for a, b in zip(got, want)) / top


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("sq,skv", [(1000, 1000), (77, 333)])
def test_bf16_kernel_model_within_bf16_tolerance(sq, skv, g, d, causal):
    """The bf16 kernels' roundings and tile order, against jax.vjp of the
    reference layer in f32 and against flash_attention_bwd_plain, on the
    same bf16 inputs and the forward's bf16 o and f32 lse."""
    q, k, v, do = _bf16_inputs(3, g, sq, skv, d, seed=sq + skv + d + g)
    o, lse = FA.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    got = _bf16_kernel_model(q, k, v, o, do, lse, causal)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    assert _rel_err(got, _jax_grads(q, k, v, do, g, causal)) <= TOL
    plain = FA.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    assert _rel_err(got, [t.float().numpy() for t in plain]) <= TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window,softcap", [(1, 0.0), (100, 2.0),
                                            (129, 50.0), (2000, 50.0)])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("sq,skv", [(300, 300), (77, 333)])
def test_bf16_kernel_model_window_softcap(sq, skv, d, window, softcap,
                                          causal):
    """The bf16 kernels' window skips, edge masks, cap factor and D = 256
    blocks, against jax.vjp of the reference layer in f32 and against
    flash_attention_bwd_plain, on the same bf16 inputs and the forward's
    bf16 o and f32 lse; 4 query heads over 2 KV heads."""
    q, k, v, do = _bf16_inputs(4, 2, sq, skv, d, seed=sq + d + window)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = _bf16_kernel_model(q, k, v, o, do, lse, **kw)
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    assert _rel_err(got, _jax_grads(q, k, v, do, 2, **kw)) <= TOL
    plain = FA.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    assert _rel_err(got, [t.float().numpy() for t in plain]) <= TOL


# (d, group, Sq, Skv, causal): ragged edges, GQA 1 and 2, gemma2's head
# width causal and not
PLAIN_SHAPES = [(16, 1, 37, 37, True), (64, 2, 20, 45, False),
                (256, 2, 45, 20, True), (256, 1, 33, 33, False)]


@pytest.mark.parametrize("softcap", [0.0, 2.0, 50.0])
@pytest.mark.parametrize("window", [1, 5, 64, "S+1"])
@pytest.mark.parametrize("d,g,sq,skv,causal", PLAIN_SHAPES)
def test_plain_backward_window_softcap_matches_reference(d, g, sq, skv,
                                                         causal, window,
                                                         softcap):
    """flash_attention_bwd_plain with a window and a softcap, from the
    plain forward's o and lse, against jax.vjp of the reference's
    blockwise_attention(window=, softcap=) in f32, within F32_TOL of the
    largest |grad|; 4 query heads, inputs scaled by 2 so that a cap of 2
    bends most scores."""
    w = max(sq, skv) + 1 if window == "S+1" else window
    rng = np.random.default_rng(d * 1000 + sq * 10 + skv + g)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) * c for s, c in
                   (((4, sq, d), 2), ((4 // g, skv, d), 2),
                    ((4 // g, skv, d), 1), ((4, sq, d), 1)))
    kw = dict(causal=causal, window=w, softcap=softcap)
    want = _jax_grads(q, k, v, do, g, **kw)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = FA.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = FA.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, **kw)
    assert _rel_err(got, want) <= F32_TOL
    # the wrapper on CPU tensors is the plain version
    same = FA.flash_attention_bwd(tq, tk, tv, o, tdo, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(same, got))


def _delta_model(o, do):
    """The Di pass's order: each 16-byte chunk of a row summed in order
    (bf16: 8 products, f32: 4) over min(chunks, 32) lanes, a lane adding
    its chunks (two, 32 apart, for f32 at D = 256) in order, then the
    lanes' sums in a butterfly."""
    vec = 16 // o.element_size()
    prod = (do.float() * o.float()).reshape(*o.shape[:2], -1, vec)
    chunk = prod[..., 0]
    for i in range(1, vec):
        chunk = chunk + prod[..., i]
    lanes = min(chunk.shape[-1], 32)
    part = chunk[..., :lanes]
    for i in range(1, chunk.shape[-1] // lanes):
        part = part + chunk[..., i * lanes:(i + 1) * lanes]
    while part.shape[-1] > 1:
        half = part.shape[-1] // 2
        part = part[..., :half] + part[..., half:]
    return part[..., 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 128, 256])
def test_delta_pass_on_ragged_rows(dtype, d):
    """Di of the plain formula is (dO * o).sum(-1) in f32, and the Di
    pass's chunked order stays within f32 rounding of it, at 77 rows a
    head (no multiple of a block's rows)."""
    rng = np.random.default_rng(d)
    o, do = (torch.from_numpy(rng.standard_normal((3, 77, d))
                              .astype(np.float32)).to(dtype)
             for _ in range(2))
    want = (do.float() * o.float()).sum(-1)
    got = FA.flash_attention_bwd_delta_plain(o, do)
    assert got.dtype == torch.float32 and got.shape == (3, 77)
    assert torch.equal(got, want)
    np.testing.assert_allclose(_delta_model(o, do).numpy(), want.numpy(),
                               rtol=0, atol=1e-5 * float(want.abs().max()))


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A changed header a source includes changes the library's path, so
    an edited header is never served by a stale library."""
    (tmp_path / "a.cu").write_text('#include "inc.cuh"\nint a;\n')
    (tmp_path / "inc.cuh").write_text('#include "deep.cuh"\n')
    (tmp_path / "deep.cuh").write_text("int x;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("a")] == ["a.cu", "inc.cuh",
                                                     "deep.cuh"]
    before = _build.library_path("a")
    (tmp_path / "deep.cuh").write_text("int y;\n")
    after = _build.library_path("a")
    assert before != after and before.parent == after.parent
    (tmp_path / "deep.cuh").write_text("int x;\n")
    assert _build.library_path("a") == before
