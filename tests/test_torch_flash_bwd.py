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


def _pad_rows(t, n):
    """t (H, S, ...) with rows S..n-1 added as zeros."""
    return torch.cat([t, t.new_zeros((t.shape[0], n - t.shape[1])
                                     + tuple(t.shape[2:]))], 1)


def _tile_checks(vis, real, skip, masked):
    """Every tile the kernel skips holds no visible pair, every tile it
    leaves unmasked no hidden one.  vis, real: (n_rows_tiles * 64,
    n_key_tiles * 64) over the padded grid; skip, masked: (row tile, key
    tile) bool, the kernel's decisions."""
    nr, nk = skip.shape
    v = vis.reshape(nr, 64, nk, 64)
    any_vis = v.any(3).any(1)
    all_vis = (v | ~real.reshape(nr, 64, nk, 64)).all(3).all(1)
    assert not any_vis[skip].any()
    assert all_vis[~skip & ~masked].all()


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
    unmasked one no hidden pair.

    The walk runs for every KV head and 64-key sub-tile at once (dK/dV:
    a step per group head and query tile, in the kernels' order) and for
    every head and 64-row sub-tile at once (dQ: a step per key tile).  A
    tile a sub-tile skips or masks takes P = 0 where no pair is visible,
    so it adds exact zeros: each sub-tile's sums are those of its own
    walk, in its order."""
    h, sq, d = q.shape
    hk, skv = k.shape[:2]
    g = h // hk
    bn, qr = _blocks(d)
    scale = 1.0 / math.sqrt(d)
    n_mt, n_kt = -(-sq // BT), -(-skv // 64)
    sq_p, skv_p = n_mt * BT, n_kt * 64
    qf, dof = (_pad_rows(t.float(), sq_p) for t in (q, do))
    kf, vf = (_pad_rows(t.float(), skv_p) for t in (k, v))
    lse_p = _pad_rows(lse, sq_p)
    di = _pad_rows((do.float() * o.float()).sum(-1), sq_p)
    qpos, kpos = torch.arange(sq_p)[:, None], torch.arange(skv_p)[None, :]
    real = (qpos < sq) & (kpos < skv)
    vis = _visible(qpos, kpos, causal, window) & real       # (sq_p, skv_p)
    mt, j = torch.arange(n_mt)[:, None], torch.arange(n_kt)[None, :]
    m0, kb = mt * BT, j * 64
    # dK/dV: the decisions of key sub-tile j (its block's range) at query
    # tile mt
    n0 = kb // bn * bn
    m_first = n0 // BT if causal else torch.zeros_like(n0)
    m_end = torch.clamp((torch.clamp(n0 + bn, max=skv) - 1 + window - 1)
                        // BT + 1, max=n_mt) if window else \
        torch.full_like(n0, n_mt)
    skip = ~((m_first <= mt) & (mt < m_end))
    masked = torch.zeros_like(skip)
    if causal:
        skip |= kb > m0 + BT - 1
        masked |= kb + 63 > m0
    if window:
        skip |= m0 - (kb + 63) >= window
        masked |= m0 + BT - 1 - kb >= window
    _tile_checks(vis, real, skip, masked)
    dk = torch.zeros(hk, skv_p, d)
    dv = torch.zeros(hk, skv_p, d)
    qg, dog = (t.reshape(hk, g, sq_p, d) for t in (qf, dof))
    lg, dig = (t.reshape(hk, g, sq_p) for t in (lse_p, di))
    for gi in range(g):
        for t in range(n_mt):
            rows = slice(t * BT, (t + 1) * BT)
            qt, dot = qg[:, gi, rows], dog[:, gi, rows]
            pt, fac = _probs(kf @ qt.transpose(1, 2),
                             lg[:, gi, None, rows], scale, softcap)
            pt = torch.where(vis[rows].T, pt, 0.0)
            dst = pt * (vf @ dot.transpose(1, 2) - dig[:, gi, None, rows])
            dst = dst * fac
            dv += pt.bfloat16().float() @ dot
            dk += dst.bfloat16().float() @ qt
    # dQ: the decisions of row sub-tile mt (its block's range) at key tile
    # j (BT = 64, so the tiles are the same grid)
    first, k0 = m0, kb
    q0 = first // qr * qr
    kv_end = torch.clamp(q0 + qr, max=skv) if causal else \
        torch.full_like(q0, skv)
    t_first = torch.clamp(q0 - window + 1, min=0) // BT if window else \
        torch.zeros_like(q0)
    skip = ~((t_first * BT <= k0) & (k0 < kv_end))
    masked = (k0 + BT > skv).expand(n_mt, n_kt).clone()
    if causal:
        skip |= k0 > first + 63
        masked |= k0 + BT - 1 > first
    if window:
        skip |= first - (k0 + BT - 1) >= window
        masked |= first + 63 - k0 >= window
    _tile_checks(vis, real, skip, masked)
    kh, vh = (t.repeat_interleave(g, 0) for t in (kf, vf))
    dq = torch.zeros(h, sq_p, d)
    for t in range(n_kt):
        keys = slice(t * BT, (t + 1) * BT)
        kt, vt = kh[:, keys], vh[:, keys]
        p, fac = _probs(qf @ kt.transpose(1, 2), lse_p[:, :, None], scale,
                        softcap)
        p = torch.where(vis[:, keys], p, 0.0)
        ds = p * (dof @ vt.transpose(1, 2) - di[:, :, None])
        ds = ds * fac
        dq += ds.bfloat16().float() @ kt
    return ((dq[:, :sq] * scale).bfloat16(), (dk[:, :skv] * scale).bfloat16(),
            dv[:, :skv].bfloat16())


def _rel_err(got, want):
    top = max(float(np.abs(np.asarray(w, np.float32)).max()) for w in want)
    return max(float(np.abs(a.float().numpy() - np.asarray(b, np.float32))
                     .max()) for a, b in zip(got, want)) / top


def check_kernel_model(sq, skv, g, d, causal):
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


# the (1000, 1000) cases are in test_torch_flash_bwd_long.py, so that
# ``--dist loadfile`` runs them beside this file
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("sq,skv", [(77, 333)])
def test_bf16_kernel_model_within_bf16_tolerance(sq, skv, g, d, causal):
    check_kernel_model(sq, skv, g, d, causal)


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
