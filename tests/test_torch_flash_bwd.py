"""The design of csrc/flash_attention_bwd.cu, checked on the CPU.

The kernels cannot run here (no card, no nvcc), so these tests hold
models of what they compute.  A tile-by-tile torch model of the bf16
kernels keeps bf16 Q, K, V and dO, takes f32 products and rounds P^T, dS^T
(the dK/dV kernel) and dS (the dQ kernel) to bf16 where the kernels do,
walking the tiles in the kernels' order with their causal skips and ragged
masks.  It is held within 2e-2 of the largest |grad| (bf16: the rounding
of P and dS before the products they feed, and of each output) against
``jax.vjp`` of the reference's ``blockwise_attention`` in f32 on the same
bf16-rounded inputs, and against ``flash_attention_bwd_plain``.  A model
of the Di pass's summation order is held against the plain formula on
ragged rows.  ``chip_smoke.py`` holds the kernels themselves against the
plain version on the card.
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
BN, QR, BT = 128, 128, 64   # the bf16 kernels' block and tile rows


def _bf16_inputs(h, g, sq, skv, d, seed):
    """q, k, v, dO drawn with numpy, rounded to bf16."""
    rng = np.random.default_rng(seed)
    shapes = ((h, sq, d), (h // g, skv, d), (h // g, skv, d), (h, sq, d))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16() for s in shapes]


def _jax_grads(q, k, v, do, g, causal):
    """jax.vjp of the reference layer in f32, the kernel's (H, S, D) heads
    as the layer's (B=1, S, K=H/G, G, D)."""
    h, sq, d = q.shape

    def layer(q, k, v):
        q5 = q.reshape(h // g, g, sq, d).transpose(2, 0, 1, 3)[None]
        out = jlayers.blockwise_attention(q5, k.transpose(1, 0, 2)[None],
                                          v.transpose(1, 0, 2)[None],
                                          causal=causal)
        return out[0].transpose(1, 2, 0, 3).reshape(h, sq, d)

    @jax.jit
    def vjp(q, k, v, do):
        return jax.vjp(layer, q, k, v)[1](do)

    args = [t.float().numpy() for t in (q, k, v, do)]
    return [np.asarray(x) for x in vjp(*args)]


def _bf16_kernel_model(q, k, v, o, do, lse, causal):
    """(dq, dk, dv) in bf16 as the bf16 kernels compute them: Di once from
    the bf16 o and dO; dK/dV blocks of BN keys, a warpgroup's 64 keys
    walking the group's heads and their BT-query tiles from the block's
    first visible tile, skipping tiles wholly above its keys; dQ blocks of
    QR rows, a warpgroup's 64 rows walking BT-key tiles to the block's
    diagonal, skipping tiles wholly above its rows.  Products in f32 of
    bf16 values; P^T, dS^T and dS rounded to bf16 before the products they
    feed; dK and dQ scaled in f32 at the end."""
    h, sq, d = q.shape
    hk, skv = k.shape[:2]
    g = h // hk
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    di = (do.float() * o.float()).sum(-1)
    n_mt = -(-sq // BT)
    dk = torch.zeros(hk, skv, d)
    dv = torch.zeros(hk, skv, d)
    for kh in range(hk):
        for n0 in range(0, skv, BN):
            m_first = n0 // BT if causal else 0
            for kb in (n0, n0 + 64):
                keys = torch.arange(kb, kb + 64)[:, None]
                kt = kf[kh, kb:kb + 64]
                vt = vf[kh, kb:kb + 64]
                for hh in range(kh * g, kh * g + g):
                    for mt in range(m_first, n_mt):
                        m0 = mt * BT
                        if kb >= skv or (causal and kb > m0 + BT - 1):
                            continue
                        qt, dot = qf[hh, m0:m0 + BT], dof[hh, m0:m0 + BT]
                        qpos = torch.arange(m0, m0 + qt.shape[0])[None, :]
                        pt = torch.exp(kt @ qt.T * scale
                                       - lse[hh, m0:m0 + BT][None, :])
                        if causal and kb + 63 > m0:
                            pt = torch.where(keys[:len(kt)] > qpos, 0.0, pt)
                        dst = pt * (vt @ dot.T - di[hh, m0:m0 + BT][None, :])
                        dv[kh, kb:kb + 64] += pt.bfloat16().float() @ dot
                        dk[kh, kb:kb + 64] += dst.bfloat16().float() @ qt
    dq = torch.zeros(h, sq, d)
    for hh in range(h):
        kh = hh // g
        for q0 in range(0, sq, QR):
            kv_end = min(skv, q0 + QR) if causal else skv
            for first in (q0, q0 + 64):
                if first >= sq:
                    continue
                qt, dot = qf[hh, first:first + 64], dof[hh, first:first + 64]
                rows = torch.arange(first, first + len(qt))[:, None]
                for k0 in range(0, kv_end, BT):
                    if causal and k0 > first + 63:
                        continue
                    kt, vt = kf[kh, k0:k0 + BT], vf[kh, k0:k0 + BT]
                    kpos = torch.arange(k0, k0 + len(kt))[None, :]
                    p = torch.exp(qt @ kt.T * scale
                                  - lse[hh, first:first + 64][:, None])
                    if k0 + BT > skv or (causal and k0 + BT - 1 > first):
                        p = torch.where(causal & (kpos > rows), 0.0, p)
                    ds = p * (dot @ vt.T - di[hh, first:first + 64][:, None])
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


def _delta_model(o, do):
    """The Di pass's order: each 16-byte chunk of a row summed in order
    (bf16: 8 products, f32: 4), then the chunks' sums in a butterfly."""
    vec = 16 // o.element_size()
    prod = (do.float() * o.float()).reshape(*o.shape[:2], -1, vec)
    part = prod[..., 0]
    for i in range(1, vec):
        part = part + prod[..., i]
    while part.shape[-1] > 1:
        half = part.shape[-1] // 2
        part = part[..., :half] + part[..., half:]
    return part[..., 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 128])
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
