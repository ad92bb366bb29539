"""repro_torch's cross-attention layers against the JAX reference, on the
CPU in f32: ``_cross_attention_seq``, the ``vlm`` image layer (gated
cross attention in place of self-attention) and the ``audio`` decoder
layer (causal self-attention, then cross attention to the encoder's
output), in train, prefill and decode mode, and their gradients against
``jax.grad``.

Inputs are drawn with numpy from a seed and handed to both packages, at
the reduced configs of llama-3.2-vision-90b (4 query heads over 2 KV
heads) and whisper-large-v3 (4 heads over 4), always with a context
longer or shorter than the token sequence (Sq != Skv).  ``xgate`` starts
at zero in the reference's init, where ``tanh(0) = 0`` makes the image
layer an identity and every cross weight's gradient exactly zero, so the
tests draw it non-zero.  Tolerances: outputs and caches within 1e-5
of the larger of 1 and their largest |value| (tests/test_torch_gemma.py's
f32 tolerance), each gradient leaf within
1e-4 of its own largest |grad| (tests/test_torch_gemma_train.py's).  On
the CPU the flash wrappers take their plain versions; ``chip_smoke.py``
holds the kernels to them at these layers' published shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import backbone as JB
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import backbone as TB

ARCHS = {"vlm": "llama-3.2-vision-90b", "audio": "whisper-large-v3"}
TAG = "dense:cross"


def _cfgs(family):
    arch = ARCHS[family]
    return jbase.reduced(jreg.get(arch)), tbase.reduced(treg.get(arch))


def _layer_params(cfg, rng, tag=TAG):
    """numpy leaves of one layer: weights N(0, 1) / sqrt(shape[0]) (the
    reference init's fan-in), norms and the gate N(0, 1) * 0.5 (non-zero:
    see the module's docstring)."""
    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        scale = tree[0] ** -0.5 if len(tree) >= 2 else 0.5
        return np.asarray(scale * rng.standard_normal(tree), np.float32)
    return draw(JB.layer_shapes(cfg, tag))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _err(got, want) -> float:
    """The largest difference over the larger of 1 and the largest
    |value| of ``want``."""
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()) / max(
        1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("s, c", [(7, 16), (24, 5)])
@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_cross_attention_seq_matches_reference(family, s, c):
    """q from x, keys and values from the context, no RoPE, no mask: the
    attended values and the context's keys and values."""
    jc, tc = _cfgs(family)
    rng = np.random.default_rng(s * 10 + c)
    p = _layer_params(jc, rng)["xattn"]
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    ctx = rng.standard_normal((2, c, jc.d_model)).astype(np.float32)
    ja, jk, jv = JB._cross_attention_seq(jc, _jax(p), jnp.asarray(x),
                                         jnp.asarray(ctx))
    ta, tk, tv = TB._cross_attention_seq(tc, _torch(p), torch.from_numpy(x),
                                         torch.from_numpy(ctx))
    assert tuple(ta.shape) == tuple(ja.shape)
    assert tuple(tk.shape) == (2, c, jc.n_kv_heads, jc.resolved_head_dim)
    for got, want in ((ta, ja), (tk, jk), (tv, jv)):
        assert _err(got, want) < 1e-5


@pytest.mark.parametrize("s, c", [(9, 16), (20, 3)])
@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_cross_layer_train_prefill_decode_match_reference(family, s, c):
    """One cross layer: train and prefill outputs, the prefill caches
    (the self ring of an audio layer, the context's xk and xv as
    computed, C long), then three decode steps reading them: outputs and
    caches, the cross caches passed on as the same tensors."""
    jc, tc = _cfgs(family)
    rng = np.random.default_rng(100 + s + c)
    p = _layer_params(jc, rng)
    jp, tp = _jax(p), _torch(p)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    ctx = rng.standard_normal((2, c, jc.d_model)).astype(np.float32)
    s_max = s + 4
    for mode in ("train", "prefill"):
        jy, jcache = JB.apply_layer(jc, TAG, jp, jnp.asarray(x), mode=mode,
                                    ctx=jnp.asarray(ctx), s_max=s_max)
        ty, tcache = TB.apply_layer(tc, TAG, tp, torch.from_numpy(x),
                                    mode=mode, ctx=torch.from_numpy(ctx),
                                    s_max=s_max)
        assert _err(ty, jy) < 1e-5
        if mode == "train":
            assert jcache is None and tcache is None
    want_keys = {"xk", "xv"} | ({"k", "v"} if family == "audio" else set())
    assert set(tcache) == set(jcache) == want_keys
    assert tuple(tcache["xk"].shape)[1] == c
    for name in tcache:
        assert _err(tcache[name], jcache[name]) < 1e-5
    for pos in range(s, s + 3):
        xt = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
        jy, jcache = JB.apply_layer(jc, TAG, jp, jnp.asarray(xt),
                                    mode="decode", cache=jcache,
                                    pos=jnp.asarray(pos, jnp.int32))
        ty, tnew = TB.apply_layer(tc, TAG, tp, torch.from_numpy(xt),
                                  mode="decode", cache=tcache, pos=pos)
        assert _err(ty, jy) < 1e-5
        assert tnew["xk"] is tcache["xk"] and tnew["xv"] is tcache["xv"]
        for name in tnew:
            assert _err(tnew[name], jcache[name]) < 1e-5
        tcache = tnew


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_cross_layer_grads_match_jax_grad(family):
    """Train mode's gradients with respect to every parameter leaf
    (``xgate`` included), the tokens' activations and the context,
    against ``jax.grad`` of the reference layer under a fixed random
    projection of its output."""
    jc, tc = _cfgs(family)
    rng = np.random.default_rng(7)
    p = _layer_params(jc, rng)
    x = rng.standard_normal((2, 11, jc.d_model)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 11, jc.d_model)).astype(np.float32)

    def jloss(params, xx, cc):
        y, _ = JB.apply_layer(jc, TAG, params, xx, mode="train", ctx=cc)
        return jnp.sum(y * w)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(_jax(p), jnp.asarray(x),
                                            jnp.asarray(ctx))
    flat, treedef = jax.tree.flatten(p)
    leaves = [torch.from_numpy(a).requires_grad_() for a in flat]
    tp = jax.tree.unflatten(treedef, leaves)
    tx = torch.from_numpy(x).requires_grad_()
    tcx = torch.from_numpy(ctx).requires_grad_()
    y, _ = TB.apply_layer(tc, TAG, tp, tx, mode="train", ctx=tcx)
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)),
                              leaves + [tx, tcx])
    want = jax.tree.leaves(jg[0]) + [jg[1], jg[2]]
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(p)[0]] + ["x", "ctx"]
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        top = float(np.abs(np.asarray(b)).max())
        assert top > 0, name                     # the gate opens every path
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err <= 1e-4 * top, name
    if family == "vlm":
        assert "['xgate']" in names


def test_zero_gate_blocks_the_image_layer():
    """The reference's init (``xgate`` 0): the image layer adds nothing
    but its FFN, and the cross weights' gradients are exactly zero, in
    both packages."""
    jc, tc = _cfgs("vlm")
    rng = np.random.default_rng(3)
    p = _layer_params(jc, rng)
    p["xgate"] = np.zeros((), np.float32)
    x = rng.standard_normal((1, 5, jc.d_model)).astype(np.float32)
    ctx = rng.standard_normal((1, 4, jc.d_model)).astype(np.float32)
    flat, treedef = jax.tree.flatten(p)
    leaves = [torch.from_numpy(a).requires_grad_() for a in flat]
    tp = jax.tree.unflatten(treedef, leaves)
    y, _ = TB.apply_layer(tc, TAG, tp, torch.from_numpy(x), mode="train",
                          ctx=torch.from_numpy(ctx))
    ffn_only = TB._ffn(tc, "dense", _torch(p), torch.from_numpy(x))
    assert torch.equal(y.detach(), ffn_only)
    jy, _ = JB.apply_layer(jc, TAG, _jax(p), jnp.asarray(x), mode="train",
                           ctx=jnp.asarray(ctx))
    assert _err(y, jy) < 1e-5
    grads = dict(zip([jax.tree_util.keystr(k) for k, _ in
                      jax.tree_util.tree_flatten_with_path(p)[0]],
                     torch.autograd.grad(y.sum(), leaves,
                                         allow_unused=True)))
    for name, g in grads.items():
        if "xattn" in name:
            assert g is None or not g.any(), name


@pytest.mark.parametrize("tag", ["attn:cross", "moe:cross"])
def test_cross_variant_accepted_on_every_reference_base(tag):
    """``cross`` on the ``attn`` and ``moe`` bases (the reference accepts
    all three) runs the same mixer with the base's FFN branch: an audio
    layer's prefill output and caches against the reference's."""
    import dataclasses
    arch = ("dbrx-132b" if tag.startswith("moe") else ARCHS["audio"])
    jc = jbase.reduced(jreg.get(arch))
    jc = dataclasses.replace(jc, family="audio", encoder_layers=2,
                             encoder_seq=6)
    tc = tbase.reduced(treg.get(arch))
    tc = dataclasses.replace(tc, family="audio", encoder_layers=2,
                             encoder_seq=6)
    rng = np.random.default_rng(11)
    p = _layer_params(jc, rng, tag)
    x = rng.standard_normal((1, 8, jc.d_model)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, jc.d_model)).astype(np.float32)
    jy, jcache = JB.apply_layer(jc, tag, _jax(p), jnp.asarray(x),
                                mode="prefill", ctx=jnp.asarray(ctx))
    ty, tcache = TB.apply_layer(tc, tag, _torch(p), torch.from_numpy(x),
                                mode="prefill", ctx=torch.from_numpy(ctx))
    assert _err(ty, jy) < 1e-5
    assert set(tcache) == set(jcache) == {"k", "v", "xk", "xv"}
    for name in tcache:
        assert _err(tcache[name], jcache[name]) < 1e-5
