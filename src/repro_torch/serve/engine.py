"""Serving engine: batched greedy decode with partly-persistent request
state, the port of ``repro.serve.engine``.

State classification (the paper's contract, applied to serving):

* ESSENTIAL: the request table (Hashmap: rid -> slot/lengths), the token
  log (prompt + generated tokens per slot) and the request journal, all
  arena-backed;
* DERIVABLE: the KV caches on the card, rebuilt by re-prefilling the
  persisted token log after a crash, and the paged-LRU metadata, rebuilt
  from its persistent NEXT chain (``serve/kvcache.py``).

Decode runs ``Model.decode_step`` per slot at batch 1 over slot-contiguous
caches; greedy sampling keeps recovery checkable.  A context model (vlm,
audio) prefills with a context of zeros, as the reference's engine does,
and its cross caches (``xk``, ``xv``) pass through decode without a
copy.

The caches hold every logged token but the last.  Admission prefills a
prompt's first p - 1 tokens; a step feeds the last logged token at its
own position p - 1 and logs the greedy token at p; recovery re-prefills
each live log but its last token.  A log of one token seats the zero
caches ``init_cache`` gives, which is what a prefill of nothing leaves.
So cache slot j holds token j, a recurrent state (hymba's ``ssm`` and
``conv``, xLSTM's ``c``, ``n``, ``m``, ``h``) has taken each logged token
exactly once, and a re-prefill
rebuilds the caches decoding built, up to the prefill's rounding.  This
is the one place the port departs from the reference, whose step feeds
token p - 1 at position p after a prefill that already took it: there
every K/V slot past the prompt holds the token before its own, and a
recurrent state takes the prompt's last token twice (and, after a
re-prefill, the log's last token twice), so a recovered engine differs
from an uninterrupted one as soon as two consecutive tokens differ
(ROADMAP Queue 3 departure 3).  Models whose greedy tokens repeat their
last input, as the reference's random test models do, give the same
tokens under both on attention archs.  A crash clears the
per-slot readiness bitmap (``slot_ready``); recovery re-admits each slot
the moment its grouped re-prefill lands, so ``step()`` decodes ready slots
and ``add_request`` seats new work only on ready slots.  ``on_slot_ready``
callbacks fire per admitted group (slots, length, seconds since the
engine stage began; on the card the group's caches are seated, the device
synchronised, before the clock is read).

Each re-prefill group computes its caches with one batched prefill (its
attention through the ``flash_attention`` kernel) and seats them with one
``scatter_rows`` launch per cache leaf: the leaf, viewed as
``(n_super * max_batch, row)`` rows, is updated in place, so the multi-GB
cache tree is never copied.  Under ``recover(concurrency>1)`` the groups
run in a thread pool, but they share the card's one stream: the host work
overlaps, the kernels do not.

``recover(salvage=True)`` rides the manager's salvage mode (DESIGN.md
§13): a token-log row that fails its checksum loses its request's prompt,
so that rid (its table entry intact) lands in ``quarantined_rids`` and its
slot frees; a rid whose table row rotted is quarantined by the table.
Admission refuses a quarantined rid with ``QuarantinedError`` until
``readmit``.

The engine runs on the card unless the caller passes ``device="cpu"``;
its parameters must live there.  ``n_shards > 1`` puts the engine's
arena and its page pool's arena on sharded arenas (barrier commit): the
token log stripes slot-per-shard, and re-prefill groups by (token-log
shard, prompt length), which at one shard is the per-length grouping.
``commit_mode="shadow"`` (DESIGN.md §9) commits both arenas by the shadow
protocol, at any shard count.  ``paged=True`` (or ``None`` under
``REPRO_PAGED=1``, DESIGN.md §12) opens both arenas paged with the
config's ``block_bytes``/``cache_blocks``: the token log, the request
table and the LRU's node slab become block pools behind each arena's
cache (the table and the token log's unconverted consumers spill, as in
the reference).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import reconstruct as rec
from repro_torch.core.arena import (CorruptLineError, QuarantinedError,
                                    journal_enabled, open_arena,
                                    resolve_device)
from repro_torch.core.recovery import RecoveryManager, RecoveryReport
from repro_torch.kernels.pack_flush import scatter_rows_
from repro_torch.models.model import Model
from repro_torch.pstruct.dll import _salvage_bad_rows
from repro_torch.pstruct.hashmap import H_FRESH as HM_FRESH
from repro_torch.pstruct.hashmap import Hashmap
from repro_torch.serve.journal import (OP_ADMIT, OP_COMPLETE, ST_NEVER,
                                       DuplicateRequestError, RequestJournal,
                                       args_digest)
from repro_torch.serve.kvcache import PagedAllocator, PagedConfig

# request-table value row: (slot, prompt_len, total_len, active, 0, 0, 0)
V_SLOT, V_PLEN, V_TLEN, V_ACTIVE = range(4)


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 4
    s_max: int = 128
    max_requests: int = 64
    mode: str = "partly"          # persistence mode for host structures
    page_tokens: int = 16
    n_shards: int = 1
    commit_mode: str = "barrier"
    # chain-ranking strategy for every recovery NEXT walk
    chain_method: str = "auto"
    # order snapshots of the request hashmap and the LRU: None defers to
    # REPRO_SNAPSHOT
    snapshot: Optional[bool] = None
    # page-pool capacity override (None = max_batch * s_max / page_tokens)
    n_pages: Optional[int] = None
    # persistent request journal: None defers to REPRO_JOURNAL
    journal: Optional[bool] = None
    # paged regions: None defers to REPRO_PAGED (default off); the block
    # cache geometry below applies to both arenas
    paged: Optional[bool] = None
    block_bytes: int = 4096
    cache_blocks: int = 1024


class ServingEngine:
    def __init__(self, model: Model, params, cfg: EngineConfig,
                 arena_path: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"parameters on {params['embed'].device}, "
                             f"engine on {self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        layout = dict(Hashmap.layout(cfg.max_requests, cfg.mode, name="req",
                                     snapshot=cfg.snapshot))
        # token-log rows stripe slot-per-shard: re-prefill after a crash
        # reads each slot's prompt from its own shard file
        layout["tokens"] = (np.int32, (cfg.max_batch, cfg.s_max),
                            ("seg", 1))
        # journal ring appended LAST: journal-off layouts keep every
        # shared region at its offset
        jr_cap = 4 * cfg.max_requests
        if journal_enabled(cfg.journal):
            layout.update(RequestJournal.layout(jr_cap, name="req"))
        self.arena = open_arena(arena_path, layout, n_shards=cfg.n_shards,
                                commit_mode=cfg.commit_mode,
                                paged=cfg.paged, block_bytes=cfg.block_bytes,
                                cache_blocks=cfg.cache_blocks,
                                device=self.device)
        self.table = Hashmap(self.arena, cfg.max_requests, cfg.mode,
                             name="req", chain_method=cfg.chain_method,
                             snapshot=cfg.snapshot)
        # HEAD/TAIL piggyback on the request hashmap's header line (words
        # 4-5), which every admission / completion epoch already marks
        self.journal = RequestJournal(
            self.arena, jr_cap, name="req", header=self.table.header) \
            if journal_enabled(cfg.journal) else None
        self.tok_region = self.arena.regions["tokens"]
        self.paging = PagedAllocator(PagedConfig(
            n_pages=max(cfg.n_pages or 0,
                        cfg.max_batch * (cfg.s_max // cfg.page_tokens)),
            page_tokens=cfg.page_tokens, mode=cfg.mode,
            n_shards=cfg.n_shards, commit_mode=cfg.commit_mode,
            chain_method=cfg.chain_method, snapshot=cfg.snapshot,
            paged=cfg.paged, block_bytes=cfg.block_bytes,
            cache_blocks=cfg.cache_blocks), device=self.device)
        # device state (DERIVABLE)
        self.cache = model.init_cache(cfg.max_batch, cfg.s_max, self.device)
        self.pos = np.zeros(cfg.max_batch, np.int64)       # per-slot length
        self.slot_rid = np.full(cfg.max_batch, -1, np.int64)
        self.slot_ready = np.ones(cfg.max_batch, bool)
        self.on_slot_ready: Optional[Callable[[np.ndarray, int, float],
                                              None]] = None
        # the scatter into the shared cache tree serializes; admission
        # events serialize apart, so a callback may decode (step())
        self._cache_lock = threading.Lock()
        self._admit_lock = threading.Lock()
        self._recover_concurrency = 1
        self.last_recovery: Optional[RecoveryReport] = None
        # rids lost to media corruption in the last salvage recovery:
        # admission refuses them (QuarantinedError) until readmit()
        self.quarantined_rids: set = set()
        # {rid: (vocab_padded,) f32 logits} of the last step
        self.step_logits: Dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------------
    def _free_slot(self) -> int:
        for i in range(self.cfg.max_batch):
            if self.slot_rid[i] < 0 and self.slot_ready[i]:
                return i
        raise RuntimeError("no free slots")

    def add_request(self, rid: int, prompt: np.ndarray) -> int:
        if int(rid) in self.quarantined_rids:
            raise QuarantinedError(
                f"request {rid} was lost to media corruption in the last "
                "salvage recovery; readmit() it explicitly to resubmit")
        if self.journal is not None:
            st = self.journal.state_of(rid)
            if st != ST_NEVER:
                raise DuplicateRequestError(
                    f"request {rid} already journaled as {st}")
        slot = self._free_slot()
        prompt = np.asarray(prompt)
        plen = len(prompt)
        # ESSENTIAL: token log row + request-table entry (+ journal
        # admission descriptor), one epoch
        with self.arena.epoch():
            self.tok_region.write_at([slot], slice(0, plen), prompt[None])
            self.tok_region.mark_range(slot, slot + 1)
            val = np.zeros((1, 7), np.int64)
            val[0, :4] = [slot, plen, plen, 1]
            self.table.insert_batch(np.array([rid], np.int64), val)
            self.paging.alloc(rid, -(-plen // self.cfg.page_tokens))
            if self.journal is not None:
                self.journal.log(OP_ADMIT, rid,
                                 digest=args_digest(prompt), info=slot)
            self.arena.commit()
        # DERIVABLE: device prefill into the slot of every token but the
        # last, which the first step feeds
        self._prefill_slot(slot, prompt[:-1])
        self.slot_rid[slot] = rid
        self.pos[slot] = plen
        return slot

    def _prefill_slot(self, slot: int, tokens) -> None:
        self._prefill_slots(np.asarray([slot], np.int64),
                            torch.as_tensor(np.asarray(tokens))[None])

    def _prefill_slots(self, slots: np.ndarray, tokens) -> None:
        """Prefill a group of slots sharing one length with a single
        batched model call (tokens: (g, plen)), then seat the (g, ...)
        cache rows into their slots with one ``scatter_rows`` launch per
        cache leaf.  ``plen`` 0 seats zero caches, as a prefill of
        nothing would leave them."""
        tokens = torch.as_tensor(tokens).to(self.device)
        if tokens.shape[1] == 0:
            kv = self.model.init_cache(len(slots), self.cfg.s_max,
                                       self.device)
            with self._cache_lock:
                _map_slot(self.cache, kv, lambda full, grp, ax:
                          _scatter_batch(full, grp, slots, ax))
            return
        batch = {"tokens": tokens}
        # a context model serves with a context of zeros, as the
        # reference's engine does (its requests carry no frames or image)
        cfg = self.model.cfg
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (len(slots), cfg.encoder_seq, cfg.d_model),
                dtype=self.model.compute_dtype, device=self.device)
        if cfg.family == "vlm":
            batch["context"] = torch.zeros(
                (len(slots), cfg.context_seq, cfg.d_model),
                dtype=self.model.compute_dtype, device=self.device)
        _, kv = self.model.prefill(self.params, batch, s_max=self.cfg.s_max)
        # the model call above runs lock-free (groups prefill in threads
        # under recover(concurrency>1)); the scatter serializes
        with self._cache_lock:
            _map_slot(self.cache, kv, lambda full, grp, ax: _scatter_batch(
                full, grp.to(full.dtype), slots, ax))

    def step(self) -> Dict[int, int]:
        """One greedy decode step for every active ready slot; returns
        {rid: token}.  The whole step is one persistence epoch."""
        out: Dict[int, int] = {}
        self.step_logits = {}
        with self.arena.epoch():
            for slot in range(self.cfg.max_batch):
                rid = int(self.slot_rid[slot])
                if rid < 0 or not self.slot_ready[slot]:
                    continue
                p = int(self.pos[slot])
                if p >= self.cfg.s_max:
                    continue
                # one device sync on a card-resident token log
                last_tok = self.tok_region.read_one(slot, p - 1)
                # the last logged token, the one the caches do not hold
                # yet, at its own position (the reference: p)
                logits = self._decode_slot(slot, last_tok, p - 1)
                tok = int(torch.argmax(logits))
                # ESSENTIAL: append the generated token + bump lengths
                self.tok_region.write_at([slot], p, tok)
                self.tok_region.mark_range(slot, slot + 1)
                ok, cur = self.table.find_batch(np.array([rid], np.int64))
                cur[0, V_TLEN] += 1
                self.table.insert_batch(np.array([rid], np.int64), cur)
                self.pos[slot] = p + 1
                out[rid] = tok
                self.step_logits[rid] = logits
            self.arena.commit()
        return out

    def finish_request(self, rid: int) -> int:
        """Retire a completed request: journal the completion and tombstone
        its table entry in ONE epoch, then release its pages and slot.
        Returns the final token count."""
        rid = int(rid)
        ok, val = self.table.find_batch(np.array([rid], np.int64))
        val = val.cpu().numpy()
        if not bool(ok[0]) or int(val[0, V_ACTIVE]) != 1:
            raise KeyError(f"request {rid} is not active")
        slot, tlen = int(val[0, V_SLOT]), int(val[0, V_TLEN])
        with self.arena.epoch():
            if self.journal is not None:
                toks = self.tok_region.read_at([slot], slice(0, tlen))[0]
                self.journal.log(OP_COMPLETE, rid,
                                 digest=args_digest(toks), info=tlen)
            self.table.remove_batch(np.array([rid], np.int64))
            self.arena.commit()
        self.paging.free_request(rid)
        self.slot_rid[slot] = -1
        self.pos[slot] = 0
        return tlen

    def _decode_slot(self, slot: int, token: int, p: int) -> torch.Tensor:
        # the slot's cache rows as views, decode at B=1, re-seat in place
        # under the cache lock (a sibling group's scatter may be running
        # during early-admission decoding)
        one = _map_slot(self.cache, self.cache,
                        lambda full, _, ax: full.narrow(ax, slot, 1))
        logits, one2 = self.model.decode_step(
            self.params, one, torch.tensor([token], device=self.device), p)
        with self._cache_lock:
            _map_slot(self.cache, one2, lambda full, o, ax: _reseat(
                full.narrow(ax, slot, 1), o))
        return logits[0]

    # ------------------------------------------------------------------
    def crash(self) -> None:
        """Drop ALL device + volatile host state.  No slot is ready to
        serve until recovery re-admits it."""
        self.cache = None
        self.pos = None
        self.slot_rid = None
        self.slot_ready = np.zeros(self.cfg.max_batch, bool)
        self.step_logits = {}
        self.arena.crash()

    def readmit(self, rids) -> None:
        """Abandon quarantined ``rids``: lift the admission gate and, when
        journaling, close each rid's exactly-once accounting with a
        COMPLETE descriptor."""
        rids = {int(r) for r in np.atleast_1d(rids)}
        self.quarantined_rids -= rids
        if self.journal is None:
            return
        stale = [r for r in sorted(rids)
                 if r in self.journal._admit
                 and r not in self.journal._complete]
        if stale:
            with self.arena.epoch():
                for r in stale:
                    self.journal.log(OP_COMPLETE, r, info=-1)
                self.arena.commit()

    def recover(self, concurrency: int = 1, on_stage=None,
                salvage: bool = False) -> float:
        """Reopen the arenas once, then reconstruct in dependency order:
        request hashmap + LRU chain, page tables, journal, engine slots
        (slab scan + grouped re-prefill).  ``concurrency>1`` runs
        independent stages and the engine's prefill groups in thread
        pools.  ``salvage=True``: corrupted stages quarantine instead of
        aborting, and the rids whose table entry or token-log row was lost
        land in ``quarantined_rids``.  Returns seconds; the RecoveryReport
        lands in ``last_recovery``."""
        self._recover_concurrency = max(1, int(concurrency))
        # journal rings load with the journal stage, sidecars with the
        # verify paths: neither belongs to the table's own load stage
        req_regions = tuple(n for n in self.arena.regions
                            if n.startswith("req.")
                            and not n.endswith(".jrnl")
                            and not n.endswith(".integ"))
        mgr = RecoveryManager(self.arena, self.paging.arena)
        mgr.add("req_table", "pstruct.hashmap", self.table,
                regions=req_regions)
        lru_regions = ("lru.nodes", "lru.header")
        if self.paging.lru.snapshot:
            lru_regions += ("lru.snapring", "lru.snaprec")
        mgr.add("lru", "pstruct.dll", self.paging.lru, regions=lru_regions)
        mgr.add("pages", "serve.paged_alloc", self.paging,
                depends=("lru",), regions=("lru.nodes",))
        eng_deps = ("req_table", "pages")
        if self.journal is not None:
            mgr.add("journal", "serve.journal", self.journal,
                    regions=("req.jrnl", "req.header"))
            eng_deps += ("journal",)
        mgr.add("engine", "serve.engine", self, depends=eng_deps,
                regions=req_regions + ("tokens",))
        report = mgr.recover(concurrency=concurrency, on_stage=on_stage,
                             salvage=salvage)
        self.last_recovery = report
        self.quarantined_rids = {int(k) for k in self.table.quarantined}
        return report.total_seconds


@rec.register("serve.engine")
def _reconstruct_engine(eng: ServingEngine) -> dict:
    """Pure rebuild of the engine's DERIVABLE state from the recovered
    request table: one scan of the dense entry slab (one copy to the
    host), then grouped re-prefill of each live log but its last token:
    slots sharing a (token-log shard, length) pair share one batched
    prefill.  Each group's slots are
    re-admitted the moment its caches are seated; empty slots admit right
    after the scan.  With a journal, its must-retry set is cross-checked
    against the table's live set first."""
    cfg = eng.cfg
    t0 = time.perf_counter()
    eng.cache = eng.model.init_cache(cfg.max_batch, cfg.s_max, eng.device)
    eng.pos = np.zeros(cfg.max_batch, np.int64)
    eng.slot_rid = np.full(cfg.max_batch, -1, np.int64)
    fresh = int(eng.table.header.read_row(0)[HM_FRESH])
    keys = eng.table.keys[:fresh].cpu().numpy()
    vals = eng.table.values[:fresh].cpu().numpy()
    # valid rids are non-negative; KEY_NULL tombstones are negative too
    live = (keys >= 0) & (vals[:, V_ACTIVE] == 1)
    salvage = eng.arena._salvage
    lost_tok = 0
    if salvage:
        # token-log salvage: a corrupt slot row loses its request's
        # prompt; the table entry is intact, so the rid quarantines by
        # name and its slot frees for new work
        bad_slots = _salvage_bad_rows(eng.arena, eng.tok_region)
        if bad_slots.size:
            hit = live & np.isin(vals[:, V_SLOT], bad_slots)
            eng.table.quarantined.update(int(k) for k in keys[hit])
            live = live & ~hit
            lost_tok = int(hit.sum())
    lost = set(eng.table.quarantined)
    if eng.journal is not None:
        # two independent persisted records of the same fact; the shared
        # req.header flush line makes divergence impossible in any
        # committed image, so a mismatch is corruption
        retry = eng.journal.must_retry()
        table_live = {int(k) for k in keys[live]}
        if salvage and lost:
            # rids cut out by salvage are EXPECTED to diverge: the journal
            # still remembers admissions the table lost
            retry = retry - lost
            table_live = table_live - lost
        if retry != table_live:
            msg = ("journal/table divergence after recovery: journal "
                   f"must-retry={sorted(retry)} vs table live="
                   f"{sorted(table_live)}")
            if salvage:
                # residual divergence IS corruption: quarantine the engine
                # stage rather than abort the whole recovery
                raise CorruptLineError("req.jrnl", np.empty(0, np.int64),
                                       detail=msg)
            raise RuntimeError(msg)
    slots = vals[live, V_SLOT]
    tlens = vals[live, V_TLEN]
    eng.slot_rid[slots] = keys[live]
    eng.pos[slots] = tlens
    ready = np.ones(cfg.max_batch, bool)
    ready[slots] = False
    eng.slot_ready = ready
    shards = eng.arena.region_shards("tokens", slots)
    groups = sorted({(int(s), int(tl)) for s, tl in zip(shards, tlens)})

    def prefill_group(key: Tuple[int, int]) -> float:
        shard, tl = key
        sel = slots[(shards == shard) & (tlens == tl)]
        # every logged token but the last, which the next step feeds
        eng._prefill_slots(sel, eng.tok_region.read_at(sel,
                                                       slice(0, tl - 1)))
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        with eng._admit_lock:
            eng.slot_ready[sel] = True
            admitted = time.perf_counter() - t0
            cb = eng.on_slot_ready
            if cb is not None:
                cb(sel, int(tl), admitted)
        return admitted

    conc = max(1, int(eng._recover_concurrency))
    if conc > 1 and len(groups) > 1:
        with ThreadPoolExecutor(max_workers=min(conc, len(groups))) as ex:
            admissions = list(ex.map(prefill_group, groups))
    else:
        admissions = [prefill_group(g) for g in groups]
    out = {"requests": int(live.sum()),
           "prefill_groups": len(groups),
           "shard_groups": int(np.unique(shards).size) if slots.size
           else 0,
           "first_admission_s": round(min(admissions), 6)
           if admissions else 0.0,
           "last_admission_s": round(max(admissions), 6)
           if admissions else 0.0}
    if lost:
        out.update(degraded=True, quarantined_rids=sorted(lost),
                   lost_token_rows=lost_tok)
    return out


def _reseat(view: torch.Tensor, new: torch.Tensor) -> None:
    """Write a decoded slot's leaf back into its view of the full cache,
    unless decode passed that view on unchanged (the cross caches): the
    same storage, shape and strides need no copy."""
    if new.data_ptr() == view.data_ptr() and new.shape == view.shape \
            and new.stride() == view.stride():
        return
    view.copy_(new)


def _scatter_batch(full: torch.Tensor, grp: torch.Tensor, slots, ax: int
                   ) -> torch.Tensor:
    """``full[slots] = grp`` along the structural batch axis ``ax`` (0, or
    1 under a leading superblock dim), in place through ``scatter_rows_``
    on ``full`` viewed as rows."""
    slots = torch.as_tensor(np.asarray(slots, np.int64), device=full.device)
    if ax == 0:
        rows = full.view(full.shape[0], -1)
        idx = slots
    else:
        n_super, b = full.shape[:2]
        rows = full.view(n_super * b, -1)
        idx = (torch.arange(n_super, device=full.device)[:, None] * b
               + slots[None, :]).reshape(-1)
    packed = grp.reshape(-1, rows.shape[1]).contiguous()
    scatter_rows_(rows, packed, idx.to(torch.int32))
    return full


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _map_slot(full_tree, other_tree, fn):
    """Apply fn(full_leaf, other_leaf, batch_axis) over a cache tree.  The
    batch axis is structural: leaves under "blocks" carry a leading
    superblock dim (batch at axis 1); leaves under "rem" have batch at
    axis 0."""
    out = dict(full_tree)
    if "blocks" in full_tree:
        out["blocks"] = _zip_map(lambda f, o: fn(f, o, 1),
                                 full_tree["blocks"], other_tree["blocks"])
    if "rem" in full_tree:
        out["rem"] = _zip_map(lambda f, o: fn(f, o, 0),
                              full_tree["rem"], other_tree["rem"])
    return out
