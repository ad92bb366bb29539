"""Token-choice top-k Mixture of Experts with capacity-bounded dispatch, the
port of ``repro.models.moe``.

Tokens are routed in groups along the sequence axis; within a group every
batch row dispatches on its own (the reference vmaps its dispatch over
rows and scans the groups), so the groups fold into the batch axis here
and one call routes them all.  Dispatch is sort-based, as in the
reference: a stable argsort groups the (token, choice) assignments by
expert, each takes the next slot of its expert's ``capacity`` slots, and
the assignments past capacity drop (they land on a scratch slot that is
sliced away).  Top-k takes the first k of a stable descending sort of the
f32 router logits, so tied logits pick the lower expert first, as
``lax.top_k`` does.

Dispatch, combine and the slot weights move rows through ``_GatherSum``:
a gather over an index table whose backward is the same gather over the
transposed table, summed in a fixed order.  Nothing adds with atomics
(the reference's combine is a scatter-add, whose CUDA forms, and the
backward of a plain gather, add floats in whatever order the threads
come), so a forward and backward repeat their bits, as bitwise training
twins need.  A token's k contributions are summed in increasing slot
order, the order of the reference's scatter-add on the CPU.

The expert products are batched matrix products over the expert axis;
their gate and up results are f32 (``layers.gate_up``), as the
reference's ``preferred_element_type`` makes them.

``SHARDING``/``set_sharding``/``_constrain`` are the reference's mesh
hooks: identities while no sharding is set; setting one raises until the
mesh is ported (ROADMAP Queue 1).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.arena import not_ported
from repro_torch.models import layers as L

SHARDING: dict = {"dispatch": None, "out": None}


def set_sharding(dispatch=None, out=None) -> None:
    SHARDING["dispatch"] = dispatch
    SHARDING["out"] = out


def _constrain(x: torch.Tensor, key: str) -> torch.Tensor:
    if SHARDING.get(key) is not None:
        raise not_ported("MoE sharding constraints (a device mesh)")
    return x


class MoEParams(NamedTuple):
    router: torch.Tensor        # (d, E) f32
    w_gate: torch.Tensor        # (E, d, f)
    w_up: torch.Tensor          # (E, d, f)
    w_down: torch.Tensor        # (E, f, d)
    # optional shared expert (llama4)
    s_gate: Optional[torch.Tensor] = None  # (d, f)
    s_up: Optional[torch.Tensor] = None
    s_down: Optional[torch.Tensor] = None


def capacity(group: int, cfg: MoEConfig) -> int:
    c = int(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts + 0.999)
    return max(c, 1)


# dropped (token, expert) assignments of each routed group, as device
# scalars, while a caller collects them (``collect_drops``)
_DROPS: Optional[list] = None


@contextlib.contextmanager
def collect_drops():
    """Collect, as 0-d device tensors, the assignments each dispatch
    inside the block drops past capacity (no synchronize until read)."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def _slot_table(eids: torch.Tensor, n_experts: int, cap: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """eids (R, T, k) -> (slot_token (R, E*C) int64: the flat assignment
    index t*k + j seated in each slot, T*k where the slot is empty;
    slot_of (R, T*k): each assignment's slot, E*C where it dropped)."""
    r, t, k = eids.shape
    n = t * k
    flat_e = eids.reshape(r, n).long()
    order = torch.argsort(flat_e, dim=1, stable=True)      # group by expert
    sorted_e = flat_e.gather(1, order)
    rows = torch.arange(r, device=eids.device)[:, None]
    # rank within expert = position - start offset of that expert
    counts = torch.bincount((sorted_e + rows * n_experts).reshape(-1),
                            minlength=r * n_experts).reshape(r, n_experts)
    starts = torch.cumsum(counts, 1) - counts               # exclusive prefix
    rank = torch.arange(n, device=eids.device) - starts.gather(1, sorted_e)
    ok = rank < cap                                         # capacity drop
    if _DROPS is not None:
        _DROPS.append((~ok).sum())
    slot = torch.where(ok, sorted_e * cap + rank, n_experts * cap)
    width = n_experts * cap + 1                             # + scratch slot
    slot_token = torch.full((r, width), n, dtype=torch.int64,
                            device=eids.device)
    # duplicates land only on the scratch slot, which is sliced away
    slot_token.view(-1).index_put_(((slot + rows * width).reshape(-1),),
                                   order.reshape(-1))
    slot_of = torch.empty_like(slot)
    slot_of.scatter_(1, order, slot)                        # a permutation
    return slot_token[:, :-1], slot_of


def _dispatch(eids: torch.Tensor, weights: torch.Tensor, n_experts: int,
              cap: int) -> Tuple[torch.Tensor, ...]:
    """eids, weights (R, T, k) -> (slot_token, slot_weight, valid, each
    (R, E*C); slot_of (R, T*k), each assignment's slot)."""
    r, t, k = eids.shape
    slot_token, slot_of = _slot_table(eids, n_experts, cap)
    slot_weight = _GatherSum.apply(weights.reshape(r, t * k),
                                   slot_token[..., None], slot_of[..., None])
    return slot_token, slot_weight, slot_token < t * k, slot_of


def _dispatch_indices(eids: torch.Tensor, weights: torch.Tensor,
                      n_experts: int, cap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build the (E*C) slot table for one token group, the reference's
    function: eids (T, k) expert ids, weights (T, k) router weights ->
    (slot_token (E*C,) index into the T*k flat assignments, T*k for an
    empty slot; slot_weight (E*C,); slot_valid (E*C,) bool)."""
    out = _dispatch(eids[None], weights[None], n_experts, cap)
    return tuple(t[0] for t in out[:3])


def _gather_sum(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, m] = sum over j, in j order, of src[r, idx[r, m, j]]; an index
    equal to src's row count (dim 1) reads a zero row.  src (R, N, ...),
    idx (R, M, J) -> (R, M, ...)."""
    r, n = src.shape[:2]
    flat = src.reshape(r, n, -1)
    flat = torch.cat([flat, flat.new_zeros(r, 1, flat.shape[2])], 1)
    e = flat.shape[2]
    out = None
    for j in range(idx.shape[2]):
        part = flat.gather(1, idx[:, :, j, None].expand(-1, -1, e))
        out = part if out is None else out + part
    return out.reshape(r, idx.shape[1], *src.shape[2:])


class _GatherSum(torch.autograd.Function):
    """``_gather_sum(src, idx)`` whose gradient is ``_gather_sum`` of the
    incoming gradient over ``inv``, the transpose of ``idx`` (inv[r, n]
    lists the m with n in idx[r, m], padded with M): every gradient row
    is read, never added into, so no atomics."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _gather_sum(src, idx)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return _gather_sum(g, inv), None, None


def _expert_ffn(xd: torch.Tensor, p: MoEParams, act: str) -> torch.Tensor:
    """xd: (B, E, C, d) -> (B, E, C, d), one batched product per weight
    over the expert axis."""
    b, n_e, c, d = xd.shape
    dt = xd.dtype
    xe = xd.transpose(0, 1).reshape(n_e, b * c, d)
    h = L.gate_up(xe, p.w_gate, p.w_up, act)              # (E, B*C, f)
    y = torch.matmul(h, p.w_down.to(dt))                  # (E, B*C, d)
    return y.reshape(n_e, b, c, d).transpose(0, 1)


def _route(x: torch.Tensor, router: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 router logits of x (B, g, d), their top k as (weights, expert
    ids), each (B, g, k): the weights a softmax over the chosen k, the ids
    in descending logit order, the lower id first among ties (as
    ``lax.top_k``)."""
    logits = torch.matmul(x.float(), router.float())       # (B, g, E)
    top_w, top_e = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(top_w[..., :k], dim=-1), top_e[..., :k]


def moe_group(x: torch.Tensor, p: MoEParams, cfg: MoEConfig,
              act: str) -> torch.Tensor:
    """Route one token group in every row.  x: (B, g, d) -> (B, g, d)."""
    b, g, d = x.shape
    n_e, k = cfg.n_experts, cfg.top_k
    cap = capacity(g, cfg)
    top_w, top_e = _route(x, p.router, k)
    slot_token, slot_w, valid, slot_of = _dispatch(top_e, top_w, n_e, cap)
    # each slot's token (g: empty), each token's k slots in increasing
    # order (E*C: dropped)
    tok_of = torch.where(valid, slot_token // k, g)[..., None]
    slots_of = torch.sort(slot_of.reshape(b, g, k), dim=-1).values
    xd = _GatherSum.apply(x, tok_of, slots_of)             # (B, E*C, d)
    xd = _constrain(xd.reshape(b, n_e, cap, d), "dispatch")
    yd = _constrain(_expert_ffn(xd, p, act), "dispatch")
    contrib = yd.reshape(b, n_e * cap, d) * slot_w[..., None].to(yd.dtype)
    y = _constrain(_GatherSum.apply(contrib, slots_of, tok_of), "out")
    if p.s_gate is not None:
        sh = L.gate_up(x, p.s_gate, p.s_up, act)
        y = y + torch.matmul(sh, p.s_down.to(x.dtype))
    return y.to(x.dtype)


def moe_ffn(x: torch.Tensor, p: MoEParams, cfg: MoEConfig,
            act: str) -> torch.Tensor:
    """x: (B, S, d), routed in groups of ``min(cfg.router_group, S)``
    tokens (the whole sequence when that does not divide S); the groups
    fold into the batch axis, which routes each on its own as the
    reference's scan does."""
    b, s, d = x.shape
    g = min(cfg.router_group, s)
    if s % g:
        g = s
    y = moe_group(x.reshape(b * (s // g), g, d), p, cfg, act)
    return y.reshape(b, s, d)
