"""Chain primitives of recovery: rebuild order from persisted NEXT pointers.

The read side of the paper's bargain (§V-F): structures persist only NEXT
pointers and a committed count, and recovery ranks the chain back into
order.  ``chain_order`` / ``chain_lengths`` / ``chain_walk`` keep the
reference's contracts exactly (``repro.core.recovery``): the same orders,
the same ``ValueError("count exceeds chain length")`` and
``RuntimeError("cycle in chain")``, the same treatment of a pointer outside
[0, n) as a terminator.  Two strategies sit behind ``method=`` (DESIGN.md
§8): pointer DOUBLING over binary-lifting tables, and contraction LIST
RANKING (sample every k-th id as a spine node, local-walk each spine
segment, rank the ~n/k contracted chain with the same tables, expand).
``method="auto"`` flips at the reference's threshold.

Every round runs where the chain lives: on a CUDA tensor the rounds are
the Hopper kernels of ``kernels/chain_order.py`` (``jump_double``,
``walk_segments``, ``expand_segments``) with torch ops between them; on a
CPU tensor the same driver runs the kernels' plain versions.

``RecoveryManager`` and its reports, and order snapshots, are not ported
yet (ROADMAP, Queue 1).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import chain_order as K

NULL = -1

__all__ = [
    "NULL", "chain_order", "chain_lengths", "chain_walk", "jump_tables",
    "chain_method", "ChainSnapshot", "CONTRACT_K", "CONTRACT_MIN_N",
    "CONTRACT_MIN_COUNT",
]

# Method selection, the reference's constants (repro.core.recovery).
CONTRACT_K = 32              # spine sampling stride (id % k == 0)
CONTRACT_MIN_N = 1 << 17     # auto: contract at/above this table size
CONTRACT_MIN_COUNT = 32      # auto: explicit counts below stay doubling
_CONTRACT_WALK_HEADS = 64    # chain_walk: contract only for few heads
_WALK_ESCALATE_ROUNDS = 128  # chain_walk auto: level-sync rounds before
                             # escalating to contraction


def chain_method(n: int, count: Optional[int] = None,
                 method: str = "auto") -> str:
    """Resolve a ``method=`` argument to "double" or "contract"."""
    if method != "auto":
        if method not in ("double", "contract"):
            raise ValueError(f"unknown chain method {method!r}")
        return method
    if n >= CONTRACT_MIN_N and (count is None or count >= CONTRACT_MIN_COUNT):
        return "contract"
    return "double"


class ChainSnapshot:
    """A candidate order from a committed order snapshot (DESIGN.md §10).
    Kept so signatures match the reference; order snapshots are not ported
    yet, and ``chain_order`` refuses one."""

    def __init__(self, candidate, replayed: int = 0):
        self.candidate = torch.as_tensor(candidate, dtype=torch.int64)
        self.replayed = int(replayed)
        self.outcome: Optional[str] = None


def _bits(x: int) -> int:
    """Table levels for a position walk of x positions (reference:
    ceil(log2(max(x, 2))))."""
    return max(1, int(max(x, 2) - 1).bit_length())


def jump_tables(nxt: torch.Tensor, bits: int) -> torch.Tensor:
    """(bits, n) int32 binary-lifting tables: ``jump[b][i]`` = node 2**b
    hops after i along ``nxt`` (NULL-absorbing; a pointer outside [0, n)
    terminates)."""
    tables, _ = K.chain_tables(K.sanitize32(nxt), bits)
    return torch.stack(tables)


def _absorb(jump: torch.Tensor, cnt: torch.Tensor,
            heads: torch.Tensor) -> torch.Tensor:
    """Pointer-doubling absorb: after n.bit_length() rounds ``cnt[i]`` is
    the weight summed over the whole chain from i.  Raises on a cycle
    reachable from ``heads`` (it never absorbs)."""
    n = jump.shape[0]
    for _ in range(max(1, int(n).bit_length())):
        jump, cnt = K.jump_double(jump, cnt)
    if bool((jump[heads] >= 0).any()):
        raise RuntimeError("cycle in chain")
    return cnt[heads]


def _contract(nxt32: torch.Tensor, heads: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Sample + local-walk steps of the list ranking.  Spine nodes are
    every id with ``id % k == 0`` plus every head (``heads`` in range);
    returns ``(spine, head_pos, cnext, w)``: spine ids, the spine index of
    each head, the contracted next pointer and the segment weights."""
    n = nxt32.shape[0]
    dev = nxt32.device
    n_mult = (n + k - 1) // k
    spine = torch.arange(0, n, k, dtype=torch.int64, device=dev)
    extra = torch.unique(heads[heads % k != 0])
    if extra.numel():
        spine = torch.cat([spine, extra])
    S = spine.shape[0]
    spine_pos = None
    if extra.numel() > 1:
        # several promoted heads: membership by table, not arithmetic
        spine_pos = torch.full((n,), NULL, dtype=torch.int32, device=dev)
        spine_pos[spine] = torch.arange(S, dtype=torch.int32, device=dev)
    head = int(extra[0]) if extra.numel() == 1 else NULL
    cnext, w = K.contract_walk(nxt32, spine, k=k, head=head, n_mult=n_mult,
                               promoted=extra.numel() == 1,
                               spine_pos=spine_pos)
    head_pos = torch.where(heads % k == 0, heads // k,
                           n_mult + torch.searchsorted(extra, heads))
    return spine, head_pos, cnext, w


def _contract_tables(cnext: torch.Tensor, cap: int) -> List[torch.Tensor]:
    """Tables over the contracted chain, deep enough for ``cap``
    contracted positions."""
    tables, _ = K.chain_tables(cnext, _bits(cap))
    return tables


def _rank_expand(nxt32: torch.Tensor, spine: torch.Tensor,
                 cjump: List[torch.Tensor], w: torch.Tensor, hpos: int,
                 count: int) -> torch.Tensor:
    """Rank + expand: ``expand_segments`` writes the segments
    ``_expand_plan`` places inside [0, count)."""
    return K.expand_segments(nxt32, *_expand_plan(spine, cjump, w, hpos,
                                                  count), count)


def _expand_plan(spine: torch.Tensor, cjump: List[torch.Tensor],
                 w: torch.Tensor, hpos: int, count: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank step: the contracted position walk gives the spine node at
    each contracted position; the exclusive cumsum of segment weights
    turns those into global start positions.  Returns int32 (first node,
    start position, run length) of every segment that starts inside
    [0, count)."""
    S = cjump[0].shape[0]
    cap = min(count, S)
    curq, dead = K.walk_positions(cjump, hpos, cap)
    safe = torch.where(dead, 0, curq).long()
    wq = torch.where(dead, 0, w[safe])
    g = torch.cumsum(wq, 0) - wq                 # global start of each q
    use = ~dead & (g < count)
    starts = g[use]
    take = torch.minimum(wq[use], count - starts)
    if int(take.sum()) != count:
        # the contracted chain ran out before covering count positions
        raise ValueError("count exceeds chain length")
    return (spine[safe[use]].to(torch.int32), starts.to(torch.int32),
            take.to(torch.int32))


def _order_contract(nxt: torch.Tensor, head: int, count: Optional[int],
                    k: int) -> torch.Tensor:
    """chain_order via contraction (head already validated in range)."""
    n = nxt.shape[0]
    nxt32 = K.sanitize32(nxt)
    heads = torch.tensor([head], dtype=torch.int64, device=nxt.device)
    spine, hpos, cnext, w = _contract(nxt32, heads, k)
    if count is None:
        count = int(_absorb(cnext, w, hpos)[0])
        if count > n:
            raise RuntimeError("cycle in chain")
    cjump = _contract_tables(cnext, min(count, spine.shape[0]))
    return _rank_expand(nxt32, spine, cjump, w, int(hpos[0]), count)


def chain_order(nxt: torch.Tensor, head: int, count: Optional[int] = None,
                *, method: str = "auto", k: Optional[int] = None,
                snapshot: Optional[ChainSnapshot] = None) -> torch.Tensor:
    """Node at each position 0..count-1 of the chain from ``head``, int64
    on ``nxt``'s device.

    ``count=None`` derives the length (cycle-detected); an explicit count
    (the DLL's committed count) bounds the walk to the committed prefix,
    and a count past the chain end raises ``ValueError``.  A head outside
    [0, n) is a terminated chain: empty order."""
    if snapshot is not None:
        raise NotImplementedError(
            "order snapshots are not ported yet (ROADMAP Queue 1: order "
            "snapshots)")
    n = nxt.shape[0]
    dev = nxt.device
    if head < 0 or head >= n or count == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    if chain_method(n, count, method) == "contract":
        return _order_contract(nxt, head, count, k or CONTRACT_K)
    jump0 = K.sanitize32(nxt)
    if count is None:
        bits = max(1, int(n).bit_length())           # 2**bits > n
        tables, cnt = K.chain_tables(
            jump0, bits, torch.ones(n, dtype=torch.int64, device=dev))
        # counts after `bits` rounds: min(2**bits, chain length)
        count = int(cnt[head])
        if count > n:
            raise RuntimeError("cycle in chain")
    else:
        tables, _ = K.chain_tables(jump0, _bits(count))
    cur, dead = K.walk_positions(tables, head, count)
    if bool(dead.any()):
        raise ValueError("count exceeds chain length")
    return cur.long()


def chain_lengths(nxt: torch.Tensor, heads, *, method: str = "auto",
                  k: Optional[int] = None) -> torch.Tensor:
    """Length of the NULL-terminated chain starting at each head (0 for a
    head outside [0, n)); raises on a cycle."""
    dev = nxt.device
    heads = torch.as_tensor(heads, dtype=torch.int64, device=dev)
    n = nxt.shape[0]
    out = torch.zeros(heads.shape, dtype=torch.int64, device=dev)
    if n == 0 or heads.numel() == 0:
        return out
    ok = (heads >= 0) & (heads < n)
    if chain_method(n, None, method) == "contract":
        nxt32 = K.sanitize32(nxt)
        _, hpos, cnext, w = _contract(nxt32, heads[ok], k or CONTRACT_K)
        lens = _absorb(cnext, w, hpos)
        if bool((lens > n).any()):
            # a poisoned (spine-free-cycle) segment on some head's chain
            raise RuntimeError("cycle in chain")
        out[ok] = lens
        return out
    out[ok] = _absorb(K.sanitize32(nxt),
                      torch.ones(n, dtype=torch.int64, device=dev), heads[ok])
    return out


def _walk_contract(nxt: torch.Tensor, heads: torch.Tensor,
                   k: int) -> torch.Tensor:
    """chain_walk via ONE shared contraction: every head is a spine node,
    so each chain's rank + expand reads the same contracted tables."""
    n = nxt.shape[0]
    dev = nxt.device
    nxt32 = K.sanitize32(nxt)
    ok = (heads >= 0) & (heads < n)
    spine, hpos, cnext, w = _contract(nxt32, heads[ok], k)
    lens = torch.zeros(heads.shape, dtype=torch.int64, device=dev)
    pos = torch.zeros(heads.shape, dtype=torch.int64, device=dev)
    lens[ok] = _absorb(cnext, w, hpos)
    pos[ok] = hpos
    if bool((lens > n).any()):
        raise RuntimeError("cycle in chain")
    lmax = int(lens.max()) if lens.numel() else 0
    out = torch.full((heads.shape[0], lmax), NULL, dtype=torch.int64,
                     device=dev)
    if lmax:
        cjump = _contract_tables(cnext, min(lmax, spine.shape[0]))
        for h, (ln, hp) in enumerate(zip(lens.tolist(), pos.tolist())):
            if ln:
                out[h, :ln] = _rank_expand(nxt32, spine, cjump, w, hp, ln)
    return out


def chain_walk(nxt: torch.Tensor, heads, *, method: str = "auto",
               k: Optional[int] = None) -> torch.Tensor:
    """(H, Lmax) member matrix: row h = the chain from heads[h] in order,
    NULL-padded.  Level-synchronous by default (one round per chain
    position, all chains together); "auto" escalates to the shared
    contraction only once a few chains over a big table have proven
    longer than _WALK_ESCALATE_ROUNDS."""
    dev = nxt.device
    heads = torch.as_tensor(heads, dtype=torch.int64, device=dev)
    n = nxt.shape[0]
    if method != "auto":
        method = chain_method(n, None, method)   # validates the string
    if method == "contract":
        return _walk_contract(nxt, heads, k or CONTRACT_K)
    escalate = (method == "auto" and n >= CONTRACT_MIN_N
                and 0 < heads.numel() <= _CONTRACT_WALK_HEADS)
    cols: List[torch.Tensor] = []
    cur = torch.where((heads >= 0) & (heads < n), heads, NULL)
    while bool((cur != NULL).any()):
        if escalate and len(cols) >= _WALK_ESCALATE_ROUNDS:
            return _walk_contract(nxt, heads, k or CONTRACT_K)
        cols.append(cur)
        live = cur != NULL
        cur = torch.where(live, nxt[torch.where(live, cur, 0)], NULL)
        cur = torch.where((cur >= 0) & (cur < n), cur, NULL)
        if len(cols) > n:
            raise RuntimeError("cycle in chain")
    if not cols:
        return torch.empty((heads.shape[0], 0), dtype=torch.int64,
                           device=dev)
    return torch.stack(cols, dim=1)
