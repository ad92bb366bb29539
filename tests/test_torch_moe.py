"""repro_torch.models.moe against the JAX reference, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.  The
dispatch table (slot_token, slot_weight, valid) must equal the reference's
exactly on random routings, on a router that overloads one expert (tokens
drop past capacity, as tests/test_models.py's overflow case) and on tied
logits made by duplicated router columns (top-k picks the lower expert
first, as ``lax.top_k``).  ``moe_group``/``moe_ffn`` in f32 within 1e-5
over one group, two groups, a length that groups do not divide, one token,
with and without the shared expert, top-1 and top-2; the gradients of
``moe_ffn`` within 1e-4 of each leaf's largest |grad| against ``jax.grad``
of the reference; a record of the ops forward and backward run shows no
scatter-add of any kind.  In bf16 routing is compared first: expert ids
must be equal wherever the reference's margin between the k-th and
(k+1)-th logit exceeds the bf16 error of the logits, then outputs within
2e-2 of the largest |output|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as JM
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.models import moe as TM

D, F = 16, 24


def _cfgs(**kw):
    base = dict(n_experts=4, top_k=2, capacity_factor=1.25, router_group=64,
                expert_d_ff=F, shared_expert=False)
    base.update(kw)
    return JMoEConfig(**base), TMoEConfig(**base)


def _params(rng, cfg, scale=0.3, router=None):
    e = cfg.n_experts
    shapes = [(D, e), (e, D, F), (e, D, F), (e, F, D)]
    if cfg.shared_expert:
        shapes += [(D, F), (D, F), (F, D)]
    arrays = [(rng.standard_normal(s) * scale).astype(np.float32)
              for s in shapes]
    if router is not None:
        arrays[0] = router
    return arrays


def _both(arrays, dtype=np.float32):
    return (JM.MoEParams(*[jnp.asarray(a, dtype) for a in arrays]),
            TM.MoEParams(*[torch.from_numpy(a).to(
                torch.bfloat16 if dtype != np.float32 else torch.float32)
                for a in arrays]))


# ------------------------------------------------------------ dispatch

def _table_case(kind: str, seed: int):
    """(eids (T, k) int32, weights (T, k) f32, n_experts, cap)."""
    rng = np.random.default_rng(seed)
    t, k, e = [(16, 2, 4), (64, 1, 8), (10, 4, 16), (33, 2, 5)][seed]
    cap = JM.capacity(t, JMoEConfig(n_experts=e, top_k=k))
    logits = rng.standard_normal((t, e)).astype(np.float32)
    if kind == "overflow":
        logits[:, 0] += 10.0               # every token's first choice
        cap = max(1, cap // 2)
    elif kind == "tied":
        logits[:, e // 2:] = logits[:, :e - e // 2]     # duplicated columns
    w, ids = jax.lax.top_k(jnp.asarray(logits), k)
    return np.array(ids), np.array(jax.nn.softmax(w, -1)), e, cap, logits


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["random", "overflow", "tied"])
def test_dispatch_indices_exact(kind, seed):
    eids, w, e, cap, logits = _table_case(kind, seed)
    want = JM._dispatch_indices(jnp.asarray(eids), jnp.asarray(w), e, cap)
    got = TM._dispatch_indices(torch.from_numpy(eids), torch.from_numpy(w),
                               e, cap)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if kind == "overflow":
        assert not bool(got[2].all()) and int(got[2].sum()) < eids.size
    # the port's own routing of the same logits (an identity router turns
    # its input into the logits) picks the same experts and weights, the
    # lower id first among ties
    tw, te = TM._route(torch.from_numpy(logits)[None], torch.eye(e),
                       eids.shape[1])
    assert np.array_equal(te[0].numpy(), eids)
    np.testing.assert_allclose(tw[0].numpy(), w, rtol=1e-6, atol=1e-7)


def test_capacity_rule():
    for g, k, e, f in [(1, 4, 16, 1.25), (4096, 4, 16, 1.25),
                       (4096, 1, 128, 1.25), (64, 2, 4, 1.25), (7, 1, 2, .5)]:
        jc, tc = _cfgs(n_experts=e, top_k=k, capacity_factor=f)
        assert TM.capacity(g, tc) == JM.capacity(g, jc)
    assert TM.capacity(4096, _cfgs(n_experts=16, top_k=4)[1]) == 1280
    assert TM.capacity(4096, _cfgs(n_experts=128, top_k=1)[1]) == 40


# ------------------------------------------------------------- forward

FFN_CASES = {
    "one_group": dict(s=64, k=2, shared=False),
    "two_groups": dict(s=128, k=2, shared=False),
    "s100_one_group": dict(s=100, k=1, shared=True),
    "s1": dict(s=1, k=2, shared=True),
    "two_groups_shared_top1": dict(s=128, k=1, shared=True),
    "short_top1": dict(s=32, k=1, shared=False),
}


def _ffn_inputs(case: str, seed: int = 0):
    spec = FFN_CASES[case]
    jc, tc = _cfgs(top_k=spec["k"], shared_expert=spec["shared"])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, spec["s"], D)).astype(np.float32)
    return jc, tc, x, _params(rng, jc)


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_reference(case):
    jc, tc, x, arrays = _ffn_inputs(case)
    jp, tp = _both(arrays)
    want = np.asarray(JM.moe_ffn(jnp.asarray(x), jp, jc, "silu"))
    got = TM.moe_ffn(torch.from_numpy(x), tp, tc, "silu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if x.shape[1] <= tc.router_group:      # one group: moe_group itself
        got = TM.moe_group(torch.from_numpy(x), tp, tc, "gelu").numpy()
        want = np.asarray(JM.moe_group(jnp.asarray(x), jp, jc, "gelu"))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_overloaded_router_drops_like_reference():
    """tests/test_models.py's overflow case: a router sending every token
    to expert 0 past its capacity of 2; the same two tokens contribute,
    and the port counts the six dropped assignments."""
    jc, tc = _cfgs(n_experts=2, top_k=1, capacity_factor=0.5,
                   router_group=8)
    d = 4
    arrays = [np.stack([np.ones(d), -np.ones(d)], 1).astype(np.float32),
              np.ones((2, d, 8), np.float32), np.ones((2, d, 8), np.float32),
              np.ones((2, 8, d), np.float32)]
    x = (np.abs(np.random.default_rng(3).standard_normal((1, 8, d)))
         + 0.1).astype(np.float32)
    want = np.asarray(JM.moe_ffn(jnp.asarray(x), JM.MoEParams(
        *map(jnp.asarray, arrays)), jc, "silu"))
    with TM.collect_drops() as drops:
        got = TM.moe_ffn(torch.from_numpy(x), TM.MoEParams(
            *map(torch.from_numpy, arrays)), tc, "silu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (np.abs(got[0]) > 1e-9).any(1).sum() == 2
    assert [int(t) for t in drops] == [6]


# ------------------------------------------------------------ gradients

class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if "index_put" in name and (kwargs.get("accumulate")
                                    or (len(args) > 3 and args[3])):
            name += "(accumulate)"
        self.ops.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("case", ["two_groups", "s100_one_group",
                                  "two_groups_shared_top1"])
def test_moe_ffn_grads_match_reference_without_scatter_add(case):
    jc, tc, x, arrays = _ffn_inputs(case, seed=1)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(xx, *leaves):
        return jnp.sum(JM.moe_ffn(xx, JM.MoEParams(*leaves), jc, "silu") * r)
    want = jax.grad(jloss, argnums=tuple(range(len(arrays) + 1)))(
        jnp.asarray(x), *map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in [x] + arrays]
    with _OpLog() as log:
        y = TM.moe_ffn(leaves[0], TM.MoEParams(*leaves[1:]), tc, "silu")
        got = torch.autograd.grad((y * torch.from_numpy(r)).sum(), leaves)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        # (top-1: the softmax over one logit is 1, so the router's
        # gradient is exactly 0 in both packages)
        top = float(np.abs(b).max())
        assert float(np.abs(a.numpy() - b).max()) <= 1e-4 * top
    bad = [o for o in log.ops if "scatter_add" in o or "index_add" in o
           or "scatter_reduce" in o or "(accumulate)" in o]
    assert not bad, bad


# ----------------------------------------------------------------- bf16

def test_bf16_routing_then_outputs():
    """bf16 inputs and weights: the port's expert ids equal the
    reference's wherever the reference's k-th/(k+1)-th margin exceeds
    the bf16 error of its logits (their distance from the logits of the
    unrounded input); then, over the groups whose ids all agree, outputs
    within 2e-2 of the largest |output|."""
    jc, tc = _cfgs(top_k=2, shared_expert=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 128, D)).astype(np.float32)
    arrays = _params(rng, jc)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    x16 = xb.float().numpy()
    jp, tp = _both(arrays, jnp.bfloat16)
    router = np.asarray(jp.router, np.float32)
    logits = x16 @ router
    err = float(np.abs(x @ router - logits).max())
    srt = np.sort(logits, -1)[..., ::-1]
    margin = srt[..., jc.top_k - 1] - srt[..., jc.top_k]
    _, want_e = jax.lax.top_k(jnp.asarray(x16) @ jnp.asarray(router),
                              jc.top_k)
    _, got_e = TM._route(xb, tp.router, tc.top_k)
    clear = margin > err
    assert clear.mean() > 0.5
    assert np.array_equal(got_e.numpy()[clear], np.asarray(want_e)[clear])
    want = np.asarray(JM.moe_ffn(jnp.asarray(x16, jnp.bfloat16), jp, jc,
                                 "silu")).astype(np.float32)
    got = TM.moe_ffn(xb, tp, tc, "silu").float().numpy()
    same = (got_e.numpy() == np.asarray(want_e)).all(-1)     # (B, S)
    groups = same.reshape(2, -1, tc.router_group).all(-1)
    assert groups.any()
    g = tc.router_group
    for b, j in zip(*np.nonzero(groups)):
        sl = slice(j * g, (j + 1) * g)
        assert np.abs(got[b, sl] - want[b, sl]).max() <= \
            2e-2 * np.abs(want).max()
