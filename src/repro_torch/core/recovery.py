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
``walk_segments``, ``expand_segments``, ``gather_next``) with torch ops
between them; on a CPU tensor the same code runs the kernels' plain
versions.  A table build or an absorb is one ``jump_double`` launch of
all its rounds; a level-synchronous ``chain_walk`` is one hop-blocked
``gather_next`` launch per doubling hop budget; a contraction's local
walk is one ``walk_segments`` launch, and its expand one
``expand_segments`` launch of runs split at the walk's checkpoints.

``chain_order(snapshot=)`` adopts an order-snapshot candidate after one
verify pass (DESIGN.md §10), with the reference HOST primitive's
semantics.

``RecoveryManager`` (the port of the reference's) reopens the arenas once,
checks validity once, and runs the registered pure reconstructors in
dependency order, serially or by dependency counters in a thread pool,
timing each stage into a ``RecoveryReport``.  The stages' threads share
the current CUDA stream: results are right, but stages do not overlap on
the card.  ``recover(salvage=True)`` (DESIGN.md §13) quarantines a stage
that trips on an ``IntegrityError`` instead of raising, skips its
transitive dependents as degraded, and lets reconstructors drop the rows
that fail their checksums (``salvage_prefix`` walks what is left of a
chain with the same kernels).  On a sharded arena the declared regions of
64 KiB or more load in stages of their own (``load:<region>``, biggest
first), each pooled across the shards, and the reopen excludes them.  On
paged arenas (DESIGN.md §12) every stage's detail carries
``block_faults``, the cache faults it caused: a paged region's load is a
lazy reset, and the faults land on the reconstructor that touches the
blocks (under concurrent stages the attribution is approximate, the total
exact).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import reconstruct
from repro_torch.core.arena import IntegrityError
from repro_torch.kernels import chain_order as K

NULL = -1

__all__ = [
    "NULL", "chain_order", "chain_lengths", "chain_walk", "jump_tables",
    "salvage_prefix",
    "chain_method", "ChainSnapshot", "CONTRACT_K", "CONTRACT_MIN_N",
    "CONTRACT_MIN_COUNT",
    "StageReport", "RecoveryReport", "Recoverable", "RecoveryManager",
]

# Method selection, the reference's constants (repro.core.recovery).
CONTRACT_K = 32              # spine sampling stride (id % k == 0)
CONTRACT_MIN_N = 1 << 17     # auto: contract at/above this table size
CONTRACT_MIN_COUNT = 32      # auto: explicit counts below stay doubling
_CONTRACT_WALK_HEADS = 64    # chain_walk: contract only for few heads
_WALK_ESCALATE_ROUNDS = 128  # chain_walk auto: level-sync rounds before
                             # escalating to contraction
_WALK_FIRST_HOPS = 8         # chain_walk: hops of its first gather_next
                             # launch; each further launch doubles them


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
    """A candidate node order seeded from a committed order snapshot
    (DESIGN.md §10), handed to ``chain_order(snapshot=...)``: int64 ids on
    the chain's device.  Never trusted: ``chain_order`` adopts it only
    after verifying it IS the committed chain.  ``outcome`` is filled by
    ``chain_order`` ("snapshot" on adoption, else the fallback method);
    ``replayed`` is the suffix length the structure walked to build it,
    reset to the full count on fallback."""

    def __init__(self, candidate, replayed: int = 0):
        self.candidate = torch.as_tensor(candidate, dtype=torch.int64)
        self.replayed = int(replayed)
        self.outcome: Optional[str] = None


def _snapshot_verify(nxt: torch.Tensor, head: int, count: Optional[int],
                     cand: torch.Tensor, **packed) -> bool:
    """True iff ``cand`` IS chain_order(nxt, head, count).

    Two verify semantics exist in the reference; this is the HOST one
    (``repro.core.recovery._snapshot_verify``): ``cand.size == count``,
    ``cand[0] == head``, every id in range, ``nxt[cand[:-1]] ==
    cand[1:]``, and nothing about the tail.  The device variant
    (``_snapshot_verify_device``) has no count and requires
    ``nxt[cand[-1]] == NULL``; after a torn epoch the last committed
    node's NEXT may point at a row the torn epoch appended, so it would
    fall back where the host adopts, and the stage detail would differ.
    The link check is one ``gather_next`` launch on a CUDA chain; all the
    checks resolve in one device sync."""
    if count is None or cand.numel() != count:
        return False
    n = nxt.shape[0]
    ok = (cand[0] == head) & K.addressable(cand, n, **packed).all()
    if count > 1:
        # sanitize first: an out-of-range stored NEXT becomes NULL, which
        # differs from the in-range cand[i+1] exactly as the raw value does
        succ = K.gather_next(K.sanitize32(nxt), cand[:-1], **packed)
        ok = ok & (succ.long() == cand[1:]).all()
    return bool(ok)


def _bits(x: int) -> int:
    """Table levels for a position walk of x positions (reference:
    ceil(log2(max(x, 2))))."""
    return max(1, int(max(x, 2) - 1).bit_length())


def jump_tables(nxt: torch.Tensor, bits: int) -> torch.Tensor:
    """(bits, n) int32 binary-lifting tables: ``jump[b][i]`` = node 2**b
    hops after i along ``nxt`` (NULL-absorbing; a pointer outside [0, n)
    terminates)."""
    return K.chain_tables(K.sanitize32(nxt), bits)[0]


def _absorb(jump: torch.Tensor, cnt: torch.Tensor,
            heads: torch.Tensor) -> torch.Tensor:
    """Pointer-doubling absorb: after n.bit_length() rounds (one
    ``jump_double`` launch) ``cnt[i]`` is the weight summed over the whole
    chain from i.  Raises on a cycle reachable from ``heads`` (it never
    absorbs)."""
    n = jump.shape[0]
    jump, cnt = K.jump_double(jump, cnt, rounds=max(1, int(n).bit_length()))
    if bool((jump[heads] >= 0).any()):
        raise RuntimeError("cycle in chain")
    return cnt[heads]


def _contract(nxt32: torch.Tensor, heads: torch.Tensor, k: int, **packed
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, K.SegmentMarks]:
    """Sample + local-walk steps of the list ranking.  Spine nodes are
    every id with ``id % k == 0`` plus every head (``heads`` in range);
    returns ``(spine, head_pos, cnext, w, marks)``: spine ids, the spine
    index of each head, the contracted next pointer, the segment weights
    and the walk's checkpoints (``K.contract_walk``, one launch).  Spine
    membership is on global ids, so a packed ``nxt32`` (``packed``: its
    ``segments``/``seg_rows``) contracts to the same spine space."""
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
    cnext, w, marks = K.contract_walk(nxt32, spine, k=k, head=head,
                                      n_mult=n_mult,
                                      promoted=extra.numel() == 1,
                                      spine_pos=spine_pos, **packed)
    head_pos = torch.where(heads % k == 0, heads // k,
                           n_mult + torch.searchsorted(extra, heads))
    return spine, head_pos, cnext, w, marks


def _contract_tables(cnext: torch.Tensor, cap: int) -> torch.Tensor:
    """Tables over the contracted chain, deep enough for ``cap``
    contracted positions."""
    return K.chain_tables(cnext, _bits(cap))[0]


def _rank_expand(nxt32: torch.Tensor, spine: torch.Tensor,
                 cjump: torch.Tensor, w: torch.Tensor, hpos: int,
                 count: int, marks: Optional[K.SegmentMarks] = None,
                 **packed) -> torch.Tensor:
    """Rank + expand: ``expand_segments`` writes the runs ``_expand_plan``
    places inside [0, count)."""
    return K.expand_segments(nxt32, *_expand_plan(spine, cjump, w, hpos,
                                                  count, marks), count,
                             **packed)


def _expand_plan(spine: torch.Tensor, cjump: torch.Tensor,
                 w: torch.Tensor, hpos: int, count: int,
                 marks: Optional[K.SegmentMarks] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank step: the contracted position walk gives the spine node at
    each contracted position; the exclusive cumsum of segment weights
    turns those into global start positions.  Returns int32 (first node,
    start position, run length) of the runs that tile [0, count): every
    segment that starts inside it, the last one cut at count.  With the
    walk's checkpoints (``marks``) each segment is split at them, so no
    run is longer than ``K.MARK_STRIDE`` nodes: a segment starting at g
    with ``take`` nodes becomes the runs (node at hop j * stride,
    g + j * stride, min(stride, take - j * stride)); runs of length 0
    (checkpoints of unused segments) write nothing.  One host sync."""
    S = cjump[0].shape[0]
    cap = min(count, S)
    curq, dead = K.walk_positions(cjump, hpos, cap)
    safe = torch.where(dead, 0, curq).long()
    wq = torch.where(dead, 0, w[safe])
    g = torch.cumsum(wq, 0) - wq                 # global start of each q
    # a prefix of the positions: dead ones follow the chain's end, g grows
    use = ~dead & (g < count)
    take = torch.where(use, torch.minimum(wq, count - g), 0)
    scalars = [use.sum(), take.sum()]
    if marks is not None:
        # start and length of each segment by spine index; a segment used
        # twice (a cycle, with an explicit count) shows as a lost write
        slot = torch.where(use, safe, S)
        g_of = torch.full((S + 1,), NULL, dtype=torch.int64, device=g.device)
        g_of[slot] = g
        take_of = torch.zeros(S + 1, dtype=torch.int64, device=g.device)
        take_of[slot] = take
        scalars += [marks.total[0], (use & (g_of[safe] != g)).sum()]
    got = torch.stack(scalars).tolist()
    m, covered = got[:2]
    if covered != count:
        # the contracted chain ran out before covering count positions
        raise ValueError("count exceeds chain length")
    first, g, take = spine[safe[:m]].to(torch.int32), g[:m], take[:m]
    if marks is None:
        return first, g.to(torch.int32), take.to(torch.int32)
    total, twice = got[2:]
    rec = marks.rec
    if total > rec.shape[1] or twice:
        # checkpoints lost to a full buffer (torn pointers merged
        # segments) or shared by two uses of one segment: walk the used
        # segments again, one lane per use, into a buffer of their size
        w_used = w[safe[:m]]
        hops = torch.where(w_used > marks.walk["nxt"].shape[0],
                           marks.walk["budget"], w_used)   # POISON: budget
        total = int(((hops - 1) // K.MARK_STRIDE).sum())
        rec = K.walk_segments(starts=first, marks=total, **marks.walk)[3][0]
        g_of, take_of = g, take
    lane, hop, node = rec[:, :total].long()
    t = take_of[lane]
    stride = K.MARK_STRIDE
    return (torch.cat([first.long(), node]).to(torch.int32),
            torch.cat([g, g_of[lane] + hop]).to(torch.int32),
            torch.cat([torch.clamp(take, max=stride),
                       torch.where(hop < t, torch.clamp(t - hop, max=stride),
                                   0)]).to(torch.int32))


def _order_contract(nxt: torch.Tensor, head: int, count: Optional[int],
                    k: int, **packed) -> torch.Tensor:
    """chain_order via contraction (head already validated in range); the
    rank runs in spine-index space, which no layout touches."""
    n = nxt.shape[0]
    nxt32 = K.sanitize32(nxt)
    heads = torch.tensor([head], dtype=torch.int64, device=nxt.device)
    spine, hpos, cnext, w, marks = _contract(nxt32, heads, k, **packed)
    if count is None:
        count = int(_absorb(cnext, w, hpos)[0])
        if count > n:
            raise RuntimeError("cycle in chain")
    cjump = _contract_tables(cnext, min(count, spine.shape[0]))
    # the head's spine index, known here without reading hpos back
    hp = head // k if head % k == 0 else (n + k - 1) // k
    return _rank_expand(nxt32, spine, cjump, w, hp, count, marks, **packed)


def chain_order(nxt: torch.Tensor, head: int, count: Optional[int] = None,
                *, method: str = "auto", k: Optional[int] = None,
                snapshot: Optional[ChainSnapshot] = None,
                segments=None, seg_rows: int = 0) -> torch.Tensor:
    """Node at each position 0..count-1 of the chain from ``head``, int64
    on ``nxt``'s device.

    ``count=None`` derives the length (cycle-detected); an explicit count
    (the DLL's committed count) bounds the walk to the committed prefix,
    and a count past the chain end raises ``ValueError``.  A head outside
    [0, n) is a terminated chain: empty order.  ``snapshot`` is adopted
    when it verifies (``snapshot.outcome = "snapshot"``); otherwise the
    full rank runs and ``outcome`` names its method.

    ``segments``/``seg_rows`` take a shard-major packed NEXT column (a
    sharded region's per-shard persistent views, concatenated, no host
    re-gather; ``segments`` the (n_shards + 1,) row offsets, ``seg_rows``
    the block-cyclic router's segment): ``head`` and the returned order
    are global ids either way, by both methods and through the snapshot
    verify, as the reference's ``chain_order_device``."""
    n = nxt.shape[0]
    dev = nxt.device
    packed = {}
    if segments is not None:
        segments = [int(x) for x in (segments.tolist()
                                     if hasattr(segments, "tolist")
                                     else segments)]
        packed = {"segments": segments, "seg_rows": seg_rows}
    if count == 0 or not K.addressable(np.array([head]), n, **packed)[0]:
        # a head outside the rows (or past its shard's span) ends at once
        return torch.empty(0, dtype=torch.int64, device=dev)
    if snapshot is not None:
        cand = snapshot.candidate.to(dev).contiguous()
        if _snapshot_verify(nxt, head, count, cand, **packed):
            snapshot.outcome = "snapshot"
            return cand.clone()
        # the snapshot lied about the committed chain: full rank
        snapshot.outcome = chain_method(n, count, method)
        snapshot.replayed = int(count or 0)
    if chain_method(n, count, method) == "contract":
        return _order_contract(nxt, head, count, k or CONTRACT_K, **packed)
    jump0 = K.sanitize32(nxt)
    if count is None:
        bits = max(1, int(n).bit_length())           # 2**bits > n
        tables, cnt = K.chain_tables(
            jump0, bits, torch.ones(n, dtype=torch.int64, device=dev),
            **packed)
        # counts after `bits` rounds: min(2**bits, chain length), at the
        # head's position
        at = head if segments is None else int(
            K.packed_positions(np.array([head]), seg_rows, segments)[0])
        count = int(cnt[at])
        if count > n:
            raise RuntimeError("cycle in chain")
    else:
        tables, _ = K.chain_tables(jump0, _bits(count), **packed)
    cur, dead = K.walk_positions(tables, head, count, **packed)
    if bool(dead.any()):
        raise ValueError("count exceeds chain length")
    return cur.long()


def salvage_prefix(nxt: torch.Tensor, head: int, count: Optional[int],
                   bad: torch.Tensor, *, method: str = "auto"
                   ) -> torch.Tensor:
    """The reference's salvage walk (``repro.pstruct.dll``), on the chain
    kernels: the longest prefix of the chain from ``head`` that holds no
    row of ``bad``, no repeated row and at most ``count`` rows (None: no
    bound), stopping at a pointer outside [0, n).  The reference walks it
    one ``int(nxt[cur])`` at a time; here the bad rows' NEXT becomes NULL,
    so the chain ends ON the first bad row it reaches, ``chain_order``
    ranks it and that row is dropped.  A cycle among verified rows makes
    ``chain_order`` raise; the walk is then ranked to ``min(count, n)``
    positions by pointer doubling (a contraction cannot rank past a cycle
    shorter than the count), which must repeat a row if the cycle comes
    first, and cut at the first repeat, where the reference stops."""
    n = nxt.shape[0]
    dev = nxt.device
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    if not 0 <= head < n or count == 0:
        return empty
    is_bad = torch.zeros(n, dtype=torch.bool, device=dev)
    bad = bad.to(dev, torch.int64)
    is_bad[bad[(bad >= 0) & (bad < n)]] = True
    cut = torch.where(is_bad, NULL, nxt.to(torch.int64))
    try:
        order = chain_order(cut, head, None, method=method)
        # the first bad row reached ends the chain; it is not kept
        keep = order.shape[0] - int(is_bad[order[-1]])
    except RuntimeError:                  # a cycle among verified rows
        span = n if count is None else min(count, n)
        order = chain_order(cut, head, span, method="double")
        srt, perm = torch.sort(order, stable=True)
        later = torch.zeros_like(srt, dtype=torch.bool)
        later[1:] = srt[1:] == srt[:-1]   # a repeat's later occurrences
        keep = int(torch.where(later, perm, span).min()) if span else 0
    if count is not None:
        keep = min(keep, count)
    return order[:keep]


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
        _, hpos, cnext, w, _ = _contract(nxt32, heads[ok],
                                         k or CONTRACT_K)
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
    spine, hpos, cnext, w, marks = _contract(nxt32, heads[ok], k)
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
                out[h, :ln] = _rank_expand(nxt32, spine, cjump, w, hp, ln,
                                           marks)
    return out


def chain_walk(nxt: torch.Tensor, heads, *, method: str = "auto",
               k: Optional[int] = None) -> torch.Tensor:
    """(H, Lmax) member matrix: row h = the chain from heads[h] in order,
    NULL-padded.  Level-synchronous by default: all chains advance
    together, column c holding the node c hops after each head.  The
    columns come from hop-blocked ``gather_next`` launches, each reporting
    the walk's length in its one device sync: the first walks 8 hops from
    the heads, each further one twice as many from the last column.  The
    hop budgets are capped so that the decisions fall where the reference
    takes them, one column at a time: "auto" escalates to the shared
    contraction only once a few chains over a big table have proven
    longer than _WALK_ESCALATE_ROUNDS (column 128 live), and a live
    column n is a cycle."""
    dev = nxt.device
    heads = torch.as_tensor(heads, dtype=torch.int64, device=dev)
    n = nxt.shape[0]
    if method != "auto":
        method = chain_method(n, None, method)   # validates the string
    if method == "contract":
        return _walk_contract(nxt, heads, k or CONTRACT_K)
    escalate = (method == "auto" and n >= CONTRACT_MIN_N
                and 0 < heads.numel() <= _CONTRACT_WALK_HEADS)
    if n == 0 or heads.numel() == 0:
        return torch.empty((heads.shape[0], 0), dtype=torch.int64,
                           device=dev)
    nxt32 = K.sanitize32(nxt)            # gathered values: in range or NULL
    col0 = torch.where((heads >= 0) & (heads < n), heads, NULL)
    # columns to decide on: 0..128 when escalating, else 0..n
    cap = _WALK_ESCALATE_ROUNDS + 1 if escalate else n + 1
    parts = [col0.to(torch.int32)[None]]
    cols, hops, start = 1, _WALK_FIRST_HOPS, col0
    while True:
        # two hops at least (gather_next's walk form); a walk past `cap`
        # changes no decision
        h = max(2, min(hops, cap - cols))
        walk, length = K.gather_next(nxt32, start, hops=h)
        live = cols - 1 + length        # columns known live: 0..live-1
        if live >= cap:
            if escalate:
                return _walk_contract(nxt, heads, k or CONTRACT_K)
            raise RuntimeError("cycle in chain")
        if length <= h:                 # the walk ended inside this launch
            parts.append(walk[:max(0, live - cols)])
            break
        parts.append(walk)
        cols, hops, start = cols + h, 2 * hops, walk[-1]
    return torch.cat(parts)[:live].t().to(
        torch.int64, memory_format=torch.contiguous_format)


# ======================================================================
# Recovery reports
# ======================================================================

@dataclass
class StageReport:
    """One timed rebuild stage.  ``t_start`` / ``t_end`` are offsets
    (seconds) from the start of the recovery pass; ``ready_at`` is the
    offset at which the stage's dependencies were all satisfied, so
    ``t_start - ready_at`` is queue wait.  ``quarantined`` (the stage
    tripped on corruption, or its reconstructor kept nothing) and
    ``degraded`` (it dropped rows, or was skipped behind a quarantined
    dependency) are the salvage outcomes."""
    name: str
    seconds: float
    detail: Dict[str, Any] = field(default_factory=dict)
    t_start: float = 0.0
    t_end: float = 0.0
    ready_at: float = 0.0
    quarantined: bool = False
    degraded: bool = False

    @property
    def queue_wait(self) -> float:
        return max(0.0, self.t_start - self.ready_at)

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "seconds": self.seconds,
                "t_start": self.t_start, "t_end": self.t_end,
                "ready_at": self.ready_at, "queue_wait": self.queue_wait,
                "quarantined": self.quarantined, "degraded": self.degraded,
                **self.detail}


@dataclass
class RecoveryReport:
    """Per-stage timing + validity of one recovery pass.  ``total_ms`` is
    the summed stage time, ``critical_path_ms`` the longest dependency
    chain, ``wall_ms`` what the pass took (``total_seconds``)."""
    valid: bool = True
    generation: int = 0
    total_seconds: float = 0.0
    concurrency: int = 1
    critical_path_seconds: float = 0.0
    stages: List[StageReport] = field(default_factory=list)
    quarantined: List[str] = field(default_factory=list)
    degraded: List[str] = field(default_factory=list)

    @property
    def wall_ms(self) -> float:
        return self.total_seconds * 1e3

    @property
    def total_ms(self) -> float:
        return sum(s.seconds for s in self.stages) * 1e3

    @property
    def critical_path_ms(self) -> float:
        return self.critical_path_seconds * 1e3

    def add(self, name: str, seconds: float, **detail: Any) -> StageReport:
        st = StageReport(name, seconds, dict(detail))
        self.stages.append(st)
        return st

    def stage(self, name: str) -> Optional[StageReport]:
        for st in self.stages:
            if st.name == name:
                return st
        return None

    def seconds(self, name: str) -> float:
        st = self.stage(name)
        return st.seconds if st is not None else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"valid": self.valid, "generation": self.generation,
                "total_seconds": self.total_seconds,
                "concurrency": self.concurrency,
                "wall_ms": self.wall_ms, "total_ms": self.total_ms,
                "critical_path_ms": self.critical_path_ms,
                "quarantined": list(self.quarantined),
                "degraded": list(self.degraded),
                "stages": [s.as_dict() for s in self.stages]}


# ======================================================================
# RecoveryManager
# ======================================================================

@dataclass(frozen=True)
class Recoverable:
    name: str
    reconstructor: str          # name in the core.reconstruct registry
    target: Any                 # object handed to the reconstructor
    depends: Tuple[str, ...] = ()
    # regions the reconstructor reads: on a SHARDED arena the big ones
    # become per-region load stages; on one arena they change nothing
    regions: Optional[Tuple[str, ...]] = None


class RecoveryManager:
    """Dependency-ordered, timed crash recovery::

        mgr = RecoveryManager(arena)
        mgr.add("lru", "pstruct.dll", dll)
        mgr.add("table", "pstruct.hashmap", hm, depends=("lru",))
        report = mgr.recover()

    ``recover()`` reopens every arena once (the validity and generation
    check happens here, not in each structure), then runs the registered
    reconstructors in topological order, timing each; the report's stage
    list is in deterministic order whatever the completion order was."""

    def __init__(self, *arenas: Any):
        # dedupe by identity: several structures often share one arena
        seen: set = set()
        self.arenas = []
        for a in arenas:
            if a is not None and id(a) not in seen:
                seen.add(id(a))
                self.arenas.append(a)
        self._items: Dict[str, Recoverable] = {}
        self._listeners: List[Callable[[StageReport], None]] = []

    # ------------------------------------------------------------- setup
    def add(self, name: str, reconstructor: str, target: Any,
            depends: Sequence[str] = (),
            regions: Optional[Sequence[str]] = None) -> "RecoveryManager":
        if name in self._items:
            raise ValueError(f"recoverable {name!r} already registered")
        if reconstructor not in reconstruct.names():
            raise KeyError(f"unknown reconstructor {reconstructor!r}")
        self._items[name] = Recoverable(
            name, reconstructor, target, tuple(depends),
            tuple(regions) if regions is not None else None)
        return self

    def add_listener(self, fn: Callable[[StageReport], None]
                     ) -> "RecoveryManager":
        """Register a stage-completion callback, invoked the moment each
        stage (including "reopen") lands, serialized by the manager's
        lock."""
        self._listeners.append(fn)
        return self

    def levels(self) -> List[List[str]]:
        """Topological levels over declared dependencies, stable in
        registration order within a level."""
        items = self._items
        for it in items.values():
            for dep in it.depends:
                if dep not in items:
                    raise KeyError(
                        f"recoverable {it.name!r} depends on unregistered "
                        f"{dep!r}")
        done: set = set()
        out: List[List[str]] = []
        pending = list(items)
        while pending:
            ready = [n for n in pending
                     if all(d in done for d in items[n].depends)]
            if not ready:
                raise ValueError(f"dependency cycle among {pending}")
            out.append(ready)
            done.update(ready)
            pending = [n for n in pending if n not in done]
        return out

    def order(self) -> List[str]:
        """Topological order (levels, flattened)."""
        return [n for level in self.levels() for n in level]

    # ----------------------------------------------------------- recover
    def recover(self, reopen: bool = True, concurrency: int = 1,
                on_stage: Optional[Callable[[StageReport], None]] = None,
                salvage: bool = False) -> RecoveryReport:
        """``salvage=True`` turns media corruption from a recovery abort
        into degraded-mode recovery: a stage that trips on an
        ``IntegrityError`` is QUARANTINED (reported, not raised), its
        transitive dependents are skipped as DEGRADED, and every structure
        off the corrupt dependency chain still rebuilds.  Reconstructors
        see ``arena._salvage == True`` for the duration and report what
        they dropped through ``degraded`` / ``quarantined`` in their
        detail dict.  A garbage header magic (``ManifestError``) is fatal
        either way: with no trustworthy generation there is no committed
        prefix to salvage toward."""
        t_all = time.perf_counter()
        report = RecoveryReport(concurrency=max(1, int(concurrency)))
        lock = threading.Lock()
        listeners = list(self._listeners)
        if on_stage is not None:
            listeners.append(on_stage)

        def emit(st: StageReport) -> None:
            with lock:
                for fn in listeners:
                    fn(st)

        order = self.order()            # validates deps / detects cycles
        items = self._items

        # Sharded arenas: the declared regions of >= 64 KiB become
        # per-region load stages, so a stage's rebuild starts when its own
        # regions land, not after the whole reopen (DESIGN.md §7).  Two
        # arenas may hold same-named regions: the stage loads them all, and
        # each arena's reopen excludes the names it contributed.  Smaller
        # regions (headers) load in the reopen.
        split: Dict[str, List[Any]] = {}
        if reopen and any(it.regions for it in items.values()):
            declared = {r for it in items.values() for r in it.regions or ()}
            for a in self.arenas:
                if getattr(a, "n_shards", 1) > 1:
                    for rname, r in a.regions.items():
                        if rname in declared and r.nbytes >= 1 << 16:
                            split.setdefault(rname, []).append(r)
        # biggest loads first: a large region usually feeds the longest
        # rebuild
        load_names = [f"load:{r}" for r in sorted(
            split, key=lambda r: (-max(x.nbytes for x in split[r]), r))]

        reopen_secs = 0.0
        if reopen and self.arenas:
            t0 = time.perf_counter()
            valids = []
            for a in self.arenas:
                if getattr(a, "n_shards", 1) > 1:
                    a.reopen(concurrency=report.concurrency, exclude=tuple(
                        n for n, rs in split.items()
                        if any(r.arena is a for r in rs)))
                else:
                    a.reopen()
                if a.device.type == "cuda":
                    torch.cuda.synchronize(a.device)
                # garbage header magic is media corruption no power loss
                # can produce: fail typed before trusting the generation
                # it claims, salvage or not
                a.verify_header()
                valids.append(bool(a.header_valid()))
            reopen_secs = time.perf_counter() - t0
            st = report.add("reopen", reopen_secs,
                            arenas=len(self.arenas), valid=valids,
                            shards=[getattr(a, "n_shards", 1)
                                    for a in self.arenas],
                            modes=[a.commit_mode for a in self.arenas])
            st.t_start, st.t_end = 0.0, reopen_secs
            report.valid = all(valids)
            # the committed (persisted) generation: survives a fresh
            # process, unlike the in-memory commit counter
            report.generation = max(a.header_generation()
                                    for a in self.arenas)
            emit(st)

        results: Dict[str, StageReport] = {}
        # when each stage's dependencies landed; stages without any are
        # ready when the reopen is done
        ready_at: Dict[str, float] = {n: reopen_secs for n in load_names}
        # a stage's load prerequisites: its declared regions' load stages;
        # an undeclared (regions=None) stage waits for every load
        load_deps = {
            n: (load_names if items[n].regions is None
                else [f"load:{r}" for r in items[n].regions if r in split])
            for n in order}
        for n in order:
            if not items[n].depends and not load_deps[n]:
                ready_at[n] = reopen_secs

        # salvage bookkeeping: stages whose output is untrusted (they
        # tripped on corruption, or ran downstream of one that did),
        # updated inside run_stage before its future resolves, so both
        # schedulers see a dependency's taint before any dependent runs
        tainted: set = set()
        if salvage:
            for a in self.arenas:
                a._salvage = True
        caches = [a.cache for a in self.arenas
                  if getattr(a, "cache", None) is not None]

        def cache_faults() -> int:
            return sum(c.faults for c in caches)

        def run_stage(name: str) -> StageReport:
            t0 = time.perf_counter()
            faults0 = cache_faults()
            bad_deps = sorted(d for d in depends_of[name] if d in tainted)
            if salvage and bad_deps:
                # skipped, not failed: running it would serve garbage
                tainted.add(name)
                st = StageReport(name, 0.0,
                                 {"skipped": "quarantined dependency",
                                  "tainted_deps": bad_deps},
                                 t_start=t0 - t_all,
                                 t_end=time.perf_counter() - t_all,
                                 ready_at=ready_at.get(name, reopen_secs),
                                 degraded=True)
                emit(st)
                return st
            try:
                if name.startswith("load:"):
                    regions = split[name[5:]]
                    for region in regions:
                        region.load(concurrency=report.concurrency)
                        if region.arena.device.type == "cuda":
                            torch.cuda.synchronize(region.arena.device)
                    secs = time.perf_counter() - t0
                    out = {"rows": sum(int(r.shape[0]) for r in regions),
                           "shards": int(regions[0].arena.n_shards)}
                else:
                    it = items[name]
                    out, secs = reconstruct.run(it.reconstructor, it.target)
                    out = dict(out) if isinstance(out, dict) else {}
                    out.setdefault("reconstructor", it.reconstructor)
            except IntegrityError as e:
                if not salvage:
                    raise
                tainted.add(name)
                t1 = time.perf_counter()
                st = StageReport(name, t1 - t0,
                                 {"error": type(e).__name__,
                                  "message": str(e)},
                                 t_start=t0 - t_all, t_end=t1 - t_all,
                                 ready_at=ready_at.get(name, reopen_secs),
                                 quarantined=True)
                emit(st)
                return st
            detail = out
            # a reconstructor may salvage on its own: it drops corrupt
            # rows, keeps the rest and says so in its detail
            quarantined = bool(detail.pop("quarantined", False))
            degraded = bool(detail.pop("degraded", False))
            if quarantined:
                tainted.add(name)
            if caches:
                detail["block_faults"] = cache_faults() - faults0
            t1 = time.perf_counter()
            st = StageReport(name, secs, detail,
                             t_start=t0 - t_all, t_end=t1 - t_all,
                             ready_at=ready_at.get(name, reopen_secs),
                             quarantined=quarantined, degraded=degraded)
            emit(st)
            return st

        full_order = load_names + order
        depends_of = {n: [] for n in load_names}
        depends_of.update({n: list(items[n].depends) + load_deps[n]
                           for n in order})
        try:
            if report.concurrency == 1:
                # serial: topological order; a stage is "ready" the moment
                # its last dependency finished
                for name in full_order:
                    st = run_stage(name)
                    results[name] = st
                    for m in full_order:
                        if name in depends_of[m]:
                            ready_at[m] = max(ready_at.get(m, 0.0),
                                              st.t_end)
            else:
                self._run_counters(full_order, depends_of, run_stage,
                                   results, ready_at, report.concurrency,
                                   t_all)
        finally:
            if salvage:
                for a in self.arenas:
                    a._salvage = False
        # loads first, then the stages level by level, whatever the
        # completion order was
        report.stages.extend(results[n] for n in full_order if n in results)
        report.quarantined = [s.name for s in report.stages
                              if s.quarantined]
        report.degraded = [s.name for s in report.stages if s.degraded]
        report.total_seconds = time.perf_counter() - t_all
        report.critical_path_seconds = reopen_secs + self._critical_path(
            full_order, depends_of,
            {s.name: s.seconds for s in report.stages})
        return report

    def _run_counters(self, order: List[str],
                      depends_of: Dict[str, List[str]], run_stage, results,
                      ready_at, concurrency: int, t_all: float) -> None:
        """Dependency-counter scheduler: one pool for the whole DAG; a
        stage is submitted the instant its own dependency counter hits
        zero.  Dependents of a failed stage are never scheduled; the
        earliest failure (in topological order) re-raises once in-flight
        stages drain."""
        remaining = {n: len(depends_of[n]) for n in order}
        dependents: Dict[str, List[str]] = {n: [] for n in order}
        for n in order:
            for d in depends_of[n]:
                dependents[d].append(n)
        errors: Dict[str, BaseException] = {}
        # RLock: a future that finishes before its done-callback attaches
        # runs the callback INLINE in the submitting thread, which may
        # already hold the scheduler lock
        done_cv = threading.Condition(threading.RLock())
        outstanding = [0]
        # an inline callback can also fire mid-submission-loop and submit
        # a LATER loop stage before the loop reaches it; the loop would
        # then submit it again and double-decrement its dependents.
        # `submitted` makes submission idempotent.
        submitted: set = set()

        with ThreadPoolExecutor(max_workers=concurrency) as ex:
            def submit(name: str) -> None:
                if name in submitted:
                    return
                submitted.add(name)
                outstanding[0] += 1
                fut = ex.submit(run_stage, name)
                fut.add_done_callback(lambda f, n=name: finished(n, f))

            def finished(name: str, fut) -> None:
                with done_cv:
                    try:
                        results[name] = fut.result()
                    except BaseException as e:   # noqa: BLE001
                        errors[name] = e
                    now = time.perf_counter() - t_all
                    if name not in errors:
                        for m in dependents[name]:
                            remaining[m] -= 1
                            ready_at[m] = max(ready_at.get(m, 0.0), now)
                            if remaining[m] == 0:
                                submit(m)
                    outstanding[0] -= 1
                    done_cv.notify_all()

            with done_cv:
                for n in order:
                    if remaining[n] == 0:
                        submit(n)
                while outstanding[0] > 0:
                    done_cv.wait()
        if errors:
            raise errors[min(errors, key=order.index)]

    @staticmethod
    def _critical_path(order: List[str], depends_of: Dict[str, List[str]],
                       secs: Dict[str, float]) -> float:
        """Longest dependency-chain sum of stage times (the reopen
        prologue excluded; the caller adds it)."""
        memo: Dict[str, float] = {}
        for name in order:               # deps resolve before dependents
            memo[name] = secs.get(name, 0.0) + max(
                (memo[d] for d in depends_of[name]), default=0.0)
        return max(memo.values(), default=0.0)
