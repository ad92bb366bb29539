"""chain_order: the list-ranking kernels of recovery, and the driver
pieces that run between them.

Four kernels, each a wrapper that dispatches by where its tensors live
(CPU tensors take the ``*_plain`` version; CUDA tensors launch the kernel
or raise) and counts its launches:

* ``jump_double`` — pointer-doubling rounds (``jump' = jump[jump]``,
  ``cnt' = cnt + cnt[jump]``, NULL absorbing), all the rounds of a call in
  one cooperative launch.  It builds the binary-lifting tables
  (``rounds=bits - 1``, ``keep=True``) and ranks the contracted chain
  (``rounds=n.bit_length()``).
* ``walk_segments`` — the contraction local walk: every lane hops toward
  its next spine node, up to ``budget`` hops.  A contraction walks in one
  launch (``contract_walk``), which also records every MARK_STRIDE-th
  node of each segment.
* ``expand_segments`` — the contraction expand: every run of the plan (a
  used segment split at those checkpoints, so at most MARK_STRIDE nodes)
  writes its node ids into the final order.
* ``gather_next`` — chain hops per lane (``nxt[ids[i]]``): ``hops=h``
  walks h hops in one launch and reports the walk's length, so a whole
  level-synchronous ``chain_walk`` takes one launch and one sync per
  doubling hop budget; one hop is the link check that verifies an
  order-snapshot candidate.

Sharded arenas (DESIGN.md §7): every kernel also takes the shard-major
packed layout, ``segments=`` (the (n_shards + 1,) row offsets of each
shard's span) and ``seg_rows=`` (the block-cyclic router's segment): a
sharded region's NEXT column arrives as the shards' persistent views
concatenated, while pointer values stay global ids.  Every array indexed
by a node id is indexed through ``packed_positions``' closed form; ids,
loaded values and outputs stay global.  A shard's span may end in padding
rows (offsets with gaps, as the reference accepts); an id whose position
falls past its shard's span addresses no row and reads as NULL, as an id
outside [0, n) does (``addressable``).  The router's exact partition of
the rows keeps its closed-form launches; other offsets ride in the
launch's parameters.  Without ``segments`` the layout is global and the
launches are the ones they were.

``csrc/chain_order.cu`` holds the Hopper kernels and their design notes.
``jump_double`` and ``gather_next`` also keep ``steps``, a histogram of
the rounds or hops of their launches by launch size.  The driver pieces
below (``sanitize32``, ``chain_tables``, ``contract_walk``,
``walk_positions``) are torch ops on whatever device the chain lives on;
``core/recovery.py`` composes them into the chain primitives with the
host reference's exact semantics.
"""
from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

NULL = -1

__all__ = ["jump_double", "jump_double_plain", "walk_segments",
           "walk_segments_plain", "expand_segments", "expand_segments_plain",
           "gather_next", "gather_next_plain", "sanitize32", "chain_tables",
           "contract_walk", "walk_positions", "packed_positions",
           "router_segments", "addressable", "MARK_STRIDE",
           "MAX_GAPPED_SHARDS", "SegmentMarks"]


# ----------------------------------------------------------------- checks

def _vec(name: str, t: torch.Tensor, dtype: torch.dtype,
         device: torch.device) -> None:
    if t.dim() != 1 or t.dtype != dtype:
        raise TypeError(f"{name} must be 1-D {dtype}, got {t.dtype} shape "
                        f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda(t: torch.Tensor, fn: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{fn}: no kernel for device {t.device}")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{fn}: {t.numel()} nodes exceed int32 node ids")
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return t.data_ptr() if t is not None else None


def _raise_on(rc: int, fn: str) -> None:
    if rc:
        raise RuntimeError(f"{fn}: kernel launch failed (CUDA error {rc})")


# ---------------------------------------------------------- packed layout

def packed_positions(ids, seg_rows: int, segments):
    """Position of each global row id in a shard-major packed array (the
    reference's closed form): ``segments[(id // B) % N] + (id // (B * N))
    * B + id % B`` with B = ``seg_rows`` and N = ``len(segments) - 1``;
    exact when the last block is partial, as a shard's earlier blocks are
    full.  A negative id (NULL) maps to NULL.  ``ids`` a numpy array or a
    torch tensor; the result is of its kind (int64)."""
    n_shards = len(segments) - 1
    if isinstance(ids, torch.Tensor):
        ids = ids.long()
        segs = segments.to(ids.device, torch.int64) \
            if isinstance(segments, torch.Tensor) else torch.as_tensor(
                np.asarray(segments, np.int64), device=ids.device)
        base = segs[torch.clamp(ids // seg_rows % n_shards, min=0)]
        local = ids // (seg_rows * n_shards) * seg_rows + ids % seg_rows
        return torch.where(ids >= 0, base + local, NULL)
    ids = np.asarray(ids, np.int64)
    base = np.asarray(segments, np.int64)[
        np.maximum(ids // seg_rows % n_shards, 0)]
    local = ids // (seg_rows * n_shards) * seg_rows + ids % seg_rows
    return np.where(ids >= 0, base + local, NULL)


def router_segments(n: int, seg_rows: int, n_shards: int) -> List[int]:
    """The offsets of a shard-major packing of n rows under the
    ("seg", seg_rows) router: shard s holds s * R * B + min(s * B, T) rows
    before it, with R = n // (B * N) full rounds and T the rows of the
    partial one (a shard's earlier blocks are full)."""
    full = n // (seg_rows * n_shards)
    tail = n - full * seg_rows * n_shards
    return [s * full * seg_rows + min(s * seg_rows, tail)
            for s in range(n_shards + 1)]


# shards a gapped packing may have: its offsets ride in the launch's
# parameters (csrc/chain_order.cu kMaxGappedShards)
MAX_GAPPED_SHARDS = 64


class _Packing(NamedTuple):
    """A launch's packed layout: the offsets, the segment size, whether
    the offsets are the router's partition of the rows (the closed form
    every id addresses), and the offsets as a host int64 array for the
    C arguments of a gapped packing."""
    segments: Tuple[int, ...]
    seg_rows: int
    partition: bool
    host: np.ndarray

    def at(self, ids: torch.Tensor) -> torch.Tensor:
        """Array positions of in-range global ids (the plain versions)."""
        return packed_positions(ids, self.seg_rows, self.segments)


def _packing(segments, seg_rows: int, n: int, device: torch.device
             ) -> Optional[_Packing]:
    """Check and resolve ``segments=``/``seg_rows=`` for an n-row array;
    None for the global layout.  The offsets are the reference's: N + 1
    non-decreasing row offsets from 0, the last at most n; a shard's span
    may hold padding rows after its own.  The router's partition of the n
    rows (``router_segments``) is told apart here, once per call: the
    kernels compute its offsets in closed form."""
    if segments is None:
        if seg_rows:
            raise ValueError("seg_rows without segments")
        return None
    segs = tuple(int(x) for x in (segments.tolist()
                                  if hasattr(segments, "tolist")
                                  else segments))
    if seg_rows < 1 or seg_rows * (len(segs) - 1) >= 2 ** 31:
        raise ValueError(f"seg_rows must be >= 1 with segments, and a round "
                         f"of segments below 2**31 rows, got {seg_rows}")
    if len(segs) < 2 or segs[0] != 0 or segs[-1] > n or any(
            b < a for a, b in zip(segs, segs[1:])):
        raise ValueError(f"segments must be n_shards + 1 non-decreasing row "
                         f"offsets from 0 to at most the {n} rows, got "
                         f"{list(segs)}")
    partition = list(segs) == router_segments(n, seg_rows, len(segs) - 1)
    if not partition and len(segs) - 1 > MAX_GAPPED_SHARDS:
        raise ValueError(f"a packing other than the router's partition "
                         f"holds at most {MAX_GAPPED_SHARDS} shards, got "
                         f"{len(segs) - 1}")
    return _Packing(segs, int(seg_rows), partition,
                    np.asarray(segs, np.int64))


def _pack_args(pk: Optional[_Packing]):
    """The C arguments of a packing: n_shards (0: global), seg_rows and
    the host offsets (null for the router's partition)."""
    if pk is None:
        return 0, 0, None
    return (len(pk.segments) - 1, pk.seg_rows,
            None if pk.partition else pk.host.ctypes.data)


def _addressed(pk: Optional[_Packing], ids: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ok, pos): whether each global id addresses a row of the n-row
    array, and its array position (0 where it does not).  An id
    addresses a row when it lies in [0, n) and, on a gapped packing, its
    position lies inside its shard's span; any other id reads as NULL."""
    ok = (ids >= 0) & (ids < n)
    safe = torch.where(ok, ids, 0).long()
    if pk is None:
        return ok, safe
    pos = pk.at(safe)
    if not pk.partition:
        ends = torch.as_tensor(pk.host[1:], device=ids.device)
        ok = ok & (pos < ends[safe // pk.seg_rows % (len(pk.segments) - 1)])
        pos = torch.where(ok, pos, 0)
    return ok, pos


def addressable(ids, n: int, segments=None, seg_rows: int = 0):
    """Whether each global id (a numpy array or a tensor) addresses a
    row of an n-row array in the given layout: in [0, n) and, on a
    gapped packing, inside its shard's span.  The chain kernels read any
    other id as NULL."""
    if isinstance(ids, torch.Tensor):
        pk = _packing(segments, seg_rows, n, ids.device)
        return _addressed(pk, ids, n)[0]
    return addressable(torch.from_numpy(np.asarray(ids, np.int64)), n,
                       segments, seg_rows).numpy()


# ------------------------------------------------------------ jump_double

def _double_plain(jump: torch.Tensor, cnt: Optional[torch.Tensor],
                  pk: Optional[_Packing] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    n = jump.shape[0]
    live, safe = _addressed(pk, jump, n)
    nj = jump[safe]
    nj = torch.where(live & _addressed(pk, nj, n)[0], nj,
                     NULL).to(torch.int32)
    if cnt is None:
        return nj, None
    return nj, cnt + torch.where(live, cnt[safe], 0)


def jump_double_plain(jump: torch.Tensor, cnt: Optional[torch.Tensor] = None,
                      *, rounds: int = 1, keep: bool = False,
                      segments=None, seg_rows: int = 0
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version: ``rounds`` doubling rounds, one after another.
    ``jump`` int32 (n,), ``cnt`` int64 (n,) or None.  Values outside
    [0, n) are NULL on input and output.  Returns (jump, cnt) after the
    last round, or with ``keep`` (levels, cnt): the (rounds + 1, n) table
    of every level, level 0 the input."""
    pk = _packing(segments, seg_rows, jump.shape[0], jump.device)
    levels = [jump]
    for _ in range(rounds):
        jump, cnt = _double_plain(jump, cnt, pk)
        levels.append(jump)
    return (torch.stack(levels) if keep else jump), cnt


def jump_double(jump: torch.Tensor, cnt: Optional[torch.Tensor] = None, *,
                rounds: int = 1, keep: bool = False, segments=None,
                seg_rows: int = 0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``rounds`` pointer-doubling rounds in one launch.  A round is
    ``jump'[i] = jump[jump[i]]`` and, when ``cnt`` is given,
    ``cnt'[i] = cnt[i] + cnt[jump[i]]`` for live lanes; NULL absorbs and
    a pointer outside [0, n) terminates like NULL.  Returns (jump, cnt)
    after the last round; with ``keep``, (levels, cnt) where levels is
    the int32 (rounds + 1, n) table, level s after s rounds (level 0 the
    input).  On the card the rounds run in one cooperative launch; a
    launch the card refuses raises.  With ``segments``/``seg_rows`` the
    arrays are shard-major packed: ``jump[jump[i]]`` reads the packed
    position of the global id ``jump[i]``, and the levels hold global ids
    at packed positions."""
    _vec("jump", jump, torch.int32, jump.device)
    if cnt is not None:
        _vec("cnt", cnt, torch.int64, jump.device)
        if cnt.shape != jump.shape:
            raise ValueError("jump_double: jump and cnt differ in shape")
    if rounds < 1:
        raise ValueError(f"jump_double: rounds must be >= 1, got {rounds}")
    pk = _packing(segments, seg_rows, jump.shape[0], jump.device)
    if not _cuda(jump, "jump_double"):
        return jump_double_plain(jump, cnt, rounds=rounds, keep=keep,
                                 segments=segments, seg_rows=seg_rows)
    n = jump.shape[0]
    if keep:
        jout = torch.empty((rounds + 1, n), dtype=torch.int32,
                           device=jump.device)
        jtmp = None
    else:
        jout = torch.empty_like(jump)
        jtmp = torch.empty_like(jump) if rounds > 1 else None
    cout = ctmp = None
    if cnt is not None:
        cout = torch.empty_like(cnt)
        ctmp = torch.empty_like(cnt) if rounds > 1 else None
    if n == 0:
        return jout, cout
    lib = _build.load("chain_order")
    with torch.cuda.device(jump.device):
        rc = lib.jump_double_launch(
            jump.data_ptr(), _ptr(cnt), jout.data_ptr(), _ptr(jtmp),
            _ptr(cout), _ptr(ctmp), n, rounds, int(keep), *_pack_args(pk),
            _stream(jump))
    _raise_on(rc, "jump_double")
    _build.note_launch(jump_double, n, steps=rounds)
    return jout, cout


jump_double.launches = 0
jump_double.sizes = {}
jump_double.steps = {}


# ---------------------------------------------------------- walk_segments

# Hops between the checkpoints a contraction walk records in each segment,
# and so the most nodes of an expand run (chosen on the card, PERF.md §6).
MARK_STRIDE = 16


class SegmentMarks(NamedTuple):
    """The checkpoints of one contraction walk.  ``rec`` is int32
    (3, capacity): the walk lane, the hop t and the node at hop t of every
    record stored (t a multiple of MARK_STRIDE, 0 < t < the lane's hops);
    ``total`` is int64 (1,), the records the walk made, on the walk's
    device: past the capacity only the first capacity are stored, in no
    set order.  ``walk`` holds the walk's keyword arguments (``nxt``
    among them), so that chosen segments can be walked again."""
    rec: torch.Tensor
    total: torch.Tensor
    walk: dict


def _spine_index(cur: torch.Tensor, k: int, head: int, n_mult: int,
                 promoted: bool, spine_pos: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Spine index of each id (NULL off the spine); ids must be >= 0."""
    if spine_pos is not None:
        return spine_pos[cur.long()]
    sp = torch.where(cur % k == 0, cur // k, NULL)
    if promoted:
        sp = torch.where(cur == head, n_mult, sp)
    return sp.to(torch.int32)


def walk_segments_plain(nxt: torch.Tensor, starts: torch.Tensor, *, k: int,
                        head: int, n_mult: int, promoted: bool,
                        budget: int,
                        spine_pos: Optional[torch.Tensor] = None,
                        marks: Optional[int] = None, segments=None,
                        seg_rows: int = 0):
    """Plain version of the fused local walk: every lane advances one hop
    per step, freezing when it reaches a spine node or the chain end; the
    checkpoints are recorded hop by hop, lane by lane."""
    n = nxt.shape[0]
    pk = _packing(segments, seg_rows, n, nxt.device)
    cur = starts.clone()
    w = torch.zeros_like(starts)
    sp = torch.full_like(starts, NULL)
    done = cur < 0
    recs = []
    for t in range(1, budget + 1):
        live = ~done
        if not bool(live.any()):
            break
        inr, at = _addressed(pk, cur, n)
        nv = torch.where(inr, nxt[at], NULL)
        nv = torch.where(_addressed(pk, nv, n)[0], nv, NULL)
        cur = torch.where(live, nv, cur)
        w = torch.where(live, w + 1, w)
        spv = _spine_index(torch.where(cur >= 0, cur, 0), k, head, n_mult,
                           promoted, spine_pos)
        arrived = live & (cur >= 0) & (spv >= 0)
        sp = torch.where(arrived, spv, sp)
        done = done | (live & ((cur < 0) | arrived))
        if marks is not None and t % MARK_STRIDE == 0 and t < budget:
            lane = torch.nonzero(live & ~done)[:, 0]
            hop = torch.full_like(lane, t, dtype=torch.int32)
            recs.append(torch.stack([lane.to(torch.int32), hop, cur[lane]]))
    if marks is None:
        return cur, sp, w
    made = torch.cat(recs, 1) if recs else torch.empty(
        (3, 0), dtype=torch.int32, device=nxt.device)
    rec = torch.full((3, marks), NULL, dtype=torch.int32, device=nxt.device)
    kept = min(marks, made.shape[1])
    rec[:, :kept] = made[:, :kept]
    total = torch.tensor([made.shape[1]], dtype=torch.int64,
                         device=nxt.device)
    return cur, sp, w, (rec, total)


def walk_segments(nxt: torch.Tensor, starts: torch.Tensor, *, k: int,
                  head: int, n_mult: int, promoted: bool, budget: int,
                  spine_pos: Optional[torch.Tensor] = None,
                  marks: Optional[int] = None, segments=None,
                  seg_rows: int = 0):
    """Walk every lane's segment toward its next spine node, up to
    ``budget`` hops.  Spine nodes are ``id % k == 0`` (spine index
    ``id // k``) plus, when ``promoted``, ``head`` (index ``n_mult``) — or,
    when ``spine_pos`` (int32 (n,), NULL off the spine) is given, the ids
    it maps.  Returns int32 ``(cur, sp, w)`` per lane: the final id (NULL
    once the chain ended), the spine index arrived at (NULL if still
    walking or ended) and the hops taken.

    ``marks`` (a capacity) also records checkpoints and returns
    ``(cur, sp, w, (rec, total))``: for every hop t that is a multiple of
    MARK_STRIDE and after which the lane walks on (t < its w), the record
    (lane, t, node at hop t), as int32 (3, marks) ``rec`` and the int64
    (1,) ``total`` of records made (see ``SegmentMarks``).  With
    ``segments``/``seg_rows``, ``nxt`` is shard-major packed; ``starts``,
    the ids walked, spine tests and records stay global."""
    dev = nxt.device
    _vec("nxt", nxt, torch.int32, dev)
    _vec("starts", starts, torch.int32, dev)
    if spine_pos is not None:
        _vec("spine_pos", spine_pos, torch.int32, dev)
    if marks is not None and marks < 0:
        raise ValueError(f"walk_segments: marks must be >= 0, got {marks}")
    pk = _packing(segments, seg_rows, nxt.shape[0], dev)
    if not _cuda(nxt, "walk_segments"):
        return walk_segments_plain(nxt, starts, k=k, head=head,
                                   n_mult=n_mult, promoted=promoted,
                                   budget=budget, spine_pos=spine_pos,
                                   marks=marks, segments=segments,
                                   seg_rows=seg_rows)
    lanes = starts.shape[0]
    cur, sp, w = torch.empty((3, lanes), dtype=torch.int32, device=dev)
    rec = total = None
    if marks is not None:
        rec = torch.empty((3, marks), dtype=torch.int32, device=dev)
        # the launch zeroes the counter itself
        total = (torch.empty if lanes else torch.zeros)(
            1, dtype=torch.int64, device=dev)
    if lanes:
        lib = _build.load("chain_order")
        with torch.cuda.device(dev):
            rc = lib.walk_segments_launch(
                nxt.data_ptr(), starts.data_ptr(), _ptr(spine_pos),
                cur.data_ptr(), sp.data_ptr(), w.data_ptr(), _ptr(rec),
                _ptr(total), nxt.shape[0], lanes, marks or 0, int(k),
                int(head), int(n_mult), int(promoted), int(budget),
                MARK_STRIDE, *_pack_args(pk), _stream(nxt))
        _raise_on(rc, "walk_segments")
        _build.note_launch(walk_segments, lanes)
    if marks is None:
        return cur, sp, w
    return cur, sp, w, (rec, total)


walk_segments.launches = 0
walk_segments.sizes = {}


# -------------------------------------------------------- expand_segments

def expand_segments_plain(nxt: torch.Tensor, starts: torch.Tensor,
                          posn: torch.Tensor, rem: torch.Tensor,
                          count: int, *, segments=None,
                          seg_rows: int = 0) -> torch.Tensor:
    """Plain version of the expand: all lanes advance together, each
    retiring when its run is written."""
    n = nxt.shape[0]
    pk = _packing(segments, seg_rows, n, nxt.device)
    out = torch.empty(count, dtype=torch.int64, device=nxt.device)
    keep = rem > 0
    cur, p, r = starts[keep].long(), posn[keep].long(), rem[keep].long()
    while cur.numel():
        out[p] = cur
        r = r - 1
        kp = r > 0
        cur = cur[kp]
        inr, at = _addressed(pk, cur, n)
        cur = torch.where(inr, nxt[at].long(), NULL)
        cur = torch.where(_addressed(pk, cur, n)[0], cur, NULL)
        p, r = p[kp] + 1, r[kp]
    return out


def expand_segments(nxt: torch.Tensor, starts: torch.Tensor,
                    posn: torch.Tensor, rem: torch.Tensor,
                    count: int, *, segments=None,
                    seg_rows: int = 0) -> torch.Tensor:
    """Lane i walks ``rem[i]`` hops from ``starts[i]`` and writes each
    visited id at ``out[posn[i] + t]``; returns the int64 (count,) order.
    A lane with ``rem[i] <= 0`` writes nothing.  The runs must tile
    [0, count) (the driver guarantees it); the driver's runs are at most
    MARK_STRIDE long, though any length is computed.  With
    ``segments``/``seg_rows``, ``nxt`` is shard-major packed; the ids
    walked and written stay global."""
    dev = nxt.device
    for name, t in (("nxt", nxt), ("starts", starts), ("posn", posn),
                    ("rem", rem)):
        _vec(name, t, torch.int32, dev)
    if not (starts.shape == posn.shape == rem.shape):
        raise ValueError("expand_segments: starts, posn and rem differ")
    pk = _packing(segments, seg_rows, nxt.shape[0], dev)
    if not _cuda(nxt, "expand_segments"):
        return expand_segments_plain(nxt, starts, posn, rem, count,
                                     segments=segments, seg_rows=seg_rows)
    out = torch.empty(count, dtype=torch.int64, device=dev)
    lanes = starts.shape[0]
    if lanes == 0 or count == 0:
        return out
    lib = _build.load("chain_order")
    with torch.cuda.device(dev):
        rc = lib.expand_segments_launch(
            nxt.data_ptr(), starts.data_ptr(), posn.data_ptr(),
            rem.data_ptr(), out.data_ptr(), nxt.shape[0], lanes,
            MARK_STRIDE, *_pack_args(pk), _stream(nxt))
    _raise_on(rc, "expand_segments")
    _build.note_launch(expand_segments, lanes)
    return out


expand_segments.launches = 0
expand_segments.sizes = {}


# ------------------------------------------------------------ gather_next

def _check_ids(ids: torch.Tensor, device: torch.device) -> None:
    if ids.dim() != 1 or ids.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"ids must be 1-D int64 or int32, got {ids.dtype} "
                        f"shape {tuple(ids.shape)}")
    if ids.device != device:
        raise ValueError(f"ids on {ids.device}, expected {device}")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")


def _hop_plain(nxt: torch.Tensor, ids: torch.Tensor,
               pk: Optional[_Packing] = None) -> torch.Tensor:
    n = nxt.shape[0]
    if n == 0:
        return torch.full(ids.shape, NULL, dtype=torch.int32,
                          device=ids.device)
    ok, at = _addressed(pk, ids, n)
    return torch.where(ok, nxt[at], NULL).to(torch.int32)


def gather_next_plain(nxt: torch.Tensor, ids: torch.Tensor, *,
                      hops: int = 1, segments=None, seg_rows: int = 0):
    """Plain version: ``hops`` applications of one chain hop per lane
    (``nxt[ids[i]]`` for ids in [0, n), else NULL).  One hop returns int32
    (L,); more return (walk, length) as ``gather_next`` does."""
    pk = _packing(segments, seg_rows, nxt.shape[0], nxt.device)
    if hops == 1:
        return _hop_plain(nxt, ids, pk)
    cols = [ids]
    for _ in range(hops):
        cols.append(_hop_plain(nxt, cols[-1], pk))
    walk = torch.stack(cols[1:])
    return walk, _walk_length(cols, nxt.shape[0], pk)


def _walk_length(cols, n: int, pk: Optional[_Packing] = None) -> int:
    """Columns holding an id that addresses a row in some lane.  They
    lead: a lane that leaves the rows gets NULL from then on."""
    return sum(int(_addressed(pk, c, n)[0].any()) for c in cols)


def gather_next(nxt: torch.Tensor, ids: torch.Tensor, *, hops: int = 1,
                segments=None, seg_rows: int = 0):
    """Chain hops for a batch of lanes.  One hop (the default):
    ``out[i] = nxt[ids[i]]``, NULL where ``ids[i]`` lies outside [0, n),
    int32 (L,).  ``nxt`` is int32 (n,); ``ids`` is int64 or int32 (L,)
    and is range-checked at its own width before any narrowing, so a torn
    2**32 + 3 gives NULL, not node 3.  The gathered value is returned as
    stored (callers sanitize ``nxt``).

    ``hops=h`` (h >= 2) walks h hops in one launch and returns
    ``(walk, length)``: ``walk`` int32 (h, L), row t = t + 1 hops, and
    ``length`` the number of leading columns of the walk (``ids`` first,
    then its h rows) that hold an id in [0, n) in some lane: the walk went
    on past its last row iff ``length == h + 1``.  On the card the length
    is reduced there and read after one stream synchronize.  With
    ``segments``/``seg_rows``, ``nxt`` is shard-major packed: a hop reads
    the packed position of the global id, and ids and the values returned
    stay global."""
    dev = nxt.device
    _vec("nxt", nxt, torch.int32, dev)
    _check_ids(ids, dev)
    if hops < 1:
        raise ValueError(f"gather_next: hops must be >= 1, got {hops}")
    pk = _packing(segments, seg_rows, nxt.shape[0], dev)
    if not _cuda(nxt, "gather_next"):
        return gather_next_plain(nxt, ids, hops=hops, segments=segments,
                                 seg_rows=seg_rows)
    lanes = ids.shape[0]
    out = torch.empty((hops, lanes) if hops > 1 else (lanes,),
                      dtype=torch.int32, device=dev)
    if lanes == 0:
        return out if hops == 1 else (out, 0)
    walk = length = None
    if hops > 1:
        walk, length = _walk_words(dev)
    lib = _build.load("chain_order")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        rc = lib.gather_next_launch(nxt.data_ptr(), ids.data_ptr(),
                                    ids.element_size(), out.data_ptr(),
                                    nxt.shape[0], lanes, hops, _ptr(walk),
                                    _ptr(length), *_pack_args(pk),
                                    stream.cuda_stream)
        _raise_on(rc, "gather_next")
        _build.note_launch(gather_next, lanes, steps=hops)
        if hops == 1:
            return out
        stream.synchronize()
    return out, int(length[0])


gather_next.launches = 0
gather_next.sizes = {}
gather_next.steps = {}

# the walk's device words, per (device, stream): zero between launches, as
# each launch's last block re-arms them; the pinned length word per thread
_walk_scratch: Dict[Tuple[int, int], torch.Tensor] = {}
_walk_host = threading.local()


def _walk_words(dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(dev).cuda_stream)
    scratch = _walk_scratch.get(key)
    if scratch is None:
        scratch = _walk_scratch.setdefault(
            key, torch.zeros(2, dtype=torch.int32, device=dev))
    words = getattr(_walk_host, "words", None)
    if words is None:
        words = _walk_host.words = {}
    host = words.get(index)
    if host is None:
        host = words[index] = torch.zeros(1, dtype=torch.int32,
                                          pin_memory=True)
    return scratch, host


# ---------------------------------------------------------- driver pieces

def sanitize32(nxt: torch.Tensor) -> torch.Tensor:
    """Out-of-range pointers -> NULL, narrowed to int32 only AFTER the
    range check at the input's own width: a torn 2**32+3 must end the
    chain, not alias node 3."""
    n = nxt.shape[0]
    return torch.where((nxt >= 0) & (nxt < n), nxt, NULL).to(
        torch.int32).contiguous()


def chain_tables(jump0: torch.Tensor, bits: int,
                 cnt: Optional[torch.Tensor] = None, *, segments=None,
                 seg_rows: int = 0
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Binary-lifting tables from one ``jump_double`` launch: the int32
    (bits, n) ``tables[b][i]`` is the node 2**b hops after i
    (NULL-absorbing), b < bits.  With ``cnt`` (int64 node weights) the
    launch runs one more round, whose level is dropped, so the returned
    counts are the weights summed over min(2**bits, chain length)
    nodes.  With ``segments``/``seg_rows`` the tables are packed: global
    ids at packed positions."""
    rounds = bits - 1 + (cnt is not None)
    if rounds == 0:
        return jump0[None], cnt
    levels, cnt = jump_double(jump0, cnt, rounds=rounds, keep=True,
                              segments=segments, seg_rows=seg_rows)
    return levels[:bits], cnt


def walk_positions(tables: torch.Tensor, start: int, count: int, *,
                   segments=None, seg_rows: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Node at each position 0..count-1 of the chain from ``start``, read
    off the tables bit by bit: level b moves every position whose bit b
    is set.  Returns (int32 ids, dead) where ``dead`` marks positions past
    the chain end (absorbed into NULL).  The levels used are copied once
    with NULL as an extra id that maps to itself, and the bits of all
    positions are taken in one pass, so a level costs two torch ops: on
    the card the host's calls, not the gathers, set the time.  Packed
    tables (``segments``/``seg_rows``: global ids at packed positions) are
    first gathered back into global order, the levels used in one
    gather."""
    dev = tables.device
    bits = min(tables.shape[0], int(count - 1).bit_length())
    n = tables.shape[1]
    pk = _packing(segments, seg_rows, n, dev)
    if pk is not None:
        # the levels used, back in global order: one gather (an id that
        # addresses no row of a gapped packing is NULL)
        ok, pos = _addressed(pk, torch.arange(n, device=dev), n)
        tables = torch.where(ok, tables[:bits][:, pos], NULL)
    levels = torch.cat([torch.where(tables[:bits] < 0, n, tables[:bits]),
                        torch.full((bits, 1), n, dtype=tables.dtype,
                                   device=dev)], 1)
    pos = torch.arange(count, device=dev)
    step = ((pos >> torch.arange(bits, device=dev)[:, None]) & 1).bool()
    cur = torch.full((count,), start, dtype=torch.int64, device=dev)
    for b in range(bits):
        cur = torch.where(step[b], levels[b][cur], cur)
    dead = cur == n
    return torch.where(dead, NULL, cur).to(torch.int32), dead


def contract_walk(nxt32: torch.Tensor, spine: torch.Tensor, *, k: int,
                  head: int, n_mult: int, promoted: bool,
                  spine_pos: Optional[torch.Tensor] = None,
                  segments=None, seg_rows: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, SegmentMarks]:
    """The contraction local walk in ONE ``walk_segments`` launch: every
    segment walks to its next spine node or the chain end, with a budget
    of ``b * ceil((n + 1) / b)`` hops (``b = max(2k, 64)``), the hop count
    at which a driver of ``b``-hop rounds gives up.  A lane that does not
    cycle visits distinct nodes and ends within n hops; one still walking
    at the budget is in a spine-free cycle and gets the POISON weight
    n + 1, so any length summed through it exceeds n.  Returns
    (cnext, w, marks): the contracted next pointer (spine-index space,
    NULL-terminated), the segment weights (nodes per segment) and the
    walk's checkpoints, in a buffer that a chain whose nodes have one
    predecessor each cannot overflow (``csrc/chain_order.cu``).  A packed
    ``nxt32`` (``segments``/``seg_rows``) is walked in place."""
    n = nxt32.shape[0]
    b = max(2 * k, 64)
    walk = dict(nxt=nxt32, k=k, head=head, n_mult=n_mult,
                promoted=promoted, budget=b * -(-(n + 1) // b),
                spine_pos=spine_pos)
    if segments is not None:
        walk.update(segments=segments, seg_rows=seg_rows)
    capacity = -(-n // MARK_STRIDE) + spine.shape[0]
    cur, sp, wd, (rec, total) = walk_segments(
        starts=spine.to(torch.int32), marks=capacity, **walk)
    w = torch.where((cur >= 0) & (sp < 0), n + 1, wd.long())
    return sp, torch.clamp(w, min=1), SegmentMarks(rec, total, walk)
