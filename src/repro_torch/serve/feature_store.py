"""Partly-persistent embedding/feature store with exactly-once request
semantics (the recommender serving path), the port of
``repro.serve.feature_store``.

Requests carry per-key embedding deltas.  The paper's state split, per
structure:

* ESSENTIAL: the embedding hashmap ``emb`` (key -> per-key apply counters;
  its keys are persisted by the hashmap itself), the sample log (the
  B+Tree ``sx``: sample id -> (emb key, delta); the tree records ARE the
  log), and the request journal ring.
* DERIVABLE: the dense hot rows (``vectors``, one accumulator row per
  hashmap slab slot), the per-slot apply ``counts`` and the
  ``next_sample`` cursor, rebuilt by replaying the committed sample log.
  ``vectors`` and ``counts`` are int64 tensors on the arena's device; the
  replay is one ``index_add_`` per tensor, exact in any order.

Exactly-once: every ``apply`` journals one fused OP_APPLY descriptor in the
SAME epoch as its table and tree mutations.  After a crash, recovery
classifies each request from the committed journal window: a retry of a
completed request is refused (``apply`` returns False); a request whose
epoch never committed left no trace anywhere and retries cleanly.

The store does not pin ``integrity``: it resolves through
``REPRO_INTEGRITY`` (on by default), as in the reference.
``recover(salvage=True)`` (DESIGN.md §13) keeps what verifies: keys the
table lost are refused (``QuarantinedError``) until ``readmit``,
quarantined or lost log records replay as holes, and a key whose replayed
apply count falls short of the table's counter is quarantined by name.
``n_shards > 1`` opens the store's arena sharded; ``commit_mode="shadow"``
commits by the shadow protocol (DESIGN.md §9) at any shard count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import reconstruct as rec
from repro_torch.core.arena import (CorruptLineError, QuarantinedError,
                                    journal_enabled, open_arena)
from repro_torch.core.recovery import RecoveryManager
from repro_torch.pstruct.bptree import BPTree
from repro_torch.pstruct.hashmap import H_FRESH as HM_FRESH
from repro_torch.pstruct.hashmap import KEY_NULL, Hashmap
from repro_torch.serve.journal import (OP_APPLY, ST_DONE, ST_NEVER,
                                       RequestJournal, args_digest)

# the emb header line, word by word: the hashmap owns 0-3
# (H_FLAG/H_SIZE/H_FRESH/H_BUCKETS), the piggybacked journal takes 4-5
# (HEAD/TAIL), and the store's committed sample cursor rides word 6, so
# table size, journal head and log cursor commit in ONE 64 B line.  The
# cursor must live here: a torn (data-phase) crash leaves in-place row
# rewrites durable in both structures, and only metadata lines are
# crash-ordered.
FS_CURSOR = 6


@dataclasses.dataclass
class FeatureConfig:
    n_keys: int = 256             # embedding-table capacity (slab slots)
    dim: int = 4                  # delta words per key (<= 6: the tree
                                  # record packs (key, delta) in 7 words)
    n_samples: int = 1024         # sample-log capacity
    mode: str = "partly"
    n_shards: int = 1
    commit_mode: str = "barrier"
    chain_method: str = "auto"
    snapshot: Optional[bool] = None
    journal: Optional[bool] = None


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.int64).numpy()
    return np.asarray(x, np.int64)


class FeatureStore:
    def __init__(self, cfg: FeatureConfig, path: Optional[str] = None,
                 device=None):
        if not 1 <= cfg.dim <= 6:
            raise ValueError(f"dim {cfg.dim} outside [1, 6]")
        self.cfg = cfg
        node_cap = max(64, cfg.n_samples // 4)
        layout = dict(Hashmap.layout(cfg.n_keys, cfg.mode, name="emb",
                                     snapshot=cfg.snapshot))
        layout.update(BPTree.layout(node_cap, cfg.n_samples, cfg.mode,
                                    name="sx"))
        jr_cap = 2 * cfg.n_samples
        if journal_enabled(cfg.journal):
            layout.update(RequestJournal.layout(jr_cap, name="emb"))
        self.arena = open_arena(path, layout, n_shards=cfg.n_shards,
                                commit_mode=cfg.commit_mode, device=device)
        self.device = self.arena.device
        self.table = Hashmap(self.arena, cfg.n_keys, cfg.mode, name="emb",
                             chain_method=cfg.chain_method,
                             snapshot=cfg.snapshot)
        self.tree = BPTree(self.arena, node_cap, cfg.n_samples, cfg.mode,
                           name="sx", chain_method=cfg.chain_method)
        # HEAD/TAIL piggyback on the emb header line, which apply() marks
        # every epoch through insert_batch
        self.journal = RequestJournal(
            self.arena, jr_cap, name="emb", header=self.table.header) \
            if journal_enabled(cfg.journal) else None
        # DERIVABLE hot rows + per-key apply counters, indexed by hashmap
        # slab slot; both replayed from the committed sample log
        self.vectors = self._zeros(cfg.n_keys, cfg.dim)
        self.counts = self._zeros(cfg.n_keys)
        self.next_sample = 0
        self.last_recovery = None
        # keys whose state a salvage recovery lost: lookup/apply refuse
        # them until readmit()
        self.quarantined_keys: set = set()

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------- write
    def apply(self, rid: int, keys, deltas, _torn_crash: bool = False
              ) -> bool:
        """Apply one request's embedding deltas, exactly once.  Returns
        False (no effects) when the journal has already seen ``rid``.  One
        atomic epoch: per-key counter bumps in the table, the request's
        samples appended to the log, and the fused OP_APPLY descriptor.
        ``_torn_crash`` is the crash-injection hook: flush the data phase,
        then lose power before the commit."""
        rid = int(rid)
        keys = _host(keys).reshape(-1)
        m = len(keys)
        deltas = _host(deltas).reshape(m, self.cfg.dim)
        if len(np.unique(keys)) != m:
            raise ValueError("apply expects unique keys per request")
        self._refuse_quarantined(keys)
        if self.journal is not None and \
                self.journal.state_of(rid) != ST_NEVER:
            return False
        if self.next_sample + m > self.cfg.n_samples:
            raise MemoryError("sample log full")
        dev = self.device
        keys_t = torch.from_numpy(keys).to(dev)
        sids = np.arange(self.next_sample, self.next_sample + m,
                         dtype=np.int64)
        # value rows are written from VOLATILE truth, never read-modify-
        # write of the table copy: a torn crash can leave an uncommitted
        # in-place value rewrite durable, and incrementing that on retry
        # would double-count
        slots0 = self.table._find_slots(keys_t)
        pre = torch.where(slots0 >= 0, self.counts[slots0.clamp(min=0)], 0)
        with self.arena.epoch():
            # per-key value row: word 0 = applied-sample count, word 1 =
            # last sample id, ALWAYS rewritten for every touched key, so
            # the emb.header line is marked every apply epoch (the
            # journal's piggyback ride)
            vals = self._zeros(m, 7)
            vals[:, 0] = pre + 1
            vals[:, 1] = torch.from_numpy(sids).to(dev)
            self.table.insert_batch(keys_t, vals)
            self.table.header.vol[0, FS_CURSOR] = self.next_sample + m
            recs = np.zeros((m, 7), np.int64)
            recs[:, 0] = keys
            recs[:, 1:1 + self.cfg.dim] = deltas
            self.tree.insert_batch(sids, recs)
            if self.journal is not None:
                self.journal.log(
                    OP_APPLY, rid,
                    digest=args_digest(np.concatenate([keys,
                                                       deltas.ravel()])),
                    info=m)
            if _torn_crash:
                self.arena.writeset.flush(include_meta=False)
                self.crash()
                return False
            self.arena.commit()
        slots = self.table._find_slots(keys_t)
        self.vectors.index_add_(0, slots, torch.from_numpy(deltas).to(dev))
        self.counts[slots] = pre + 1
        self.next_sample += m
        return True

    def _refuse_quarantined(self, keys) -> None:
        if not self.quarantined_keys:
            return
        bad = sorted(int(k) for k in np.atleast_1d(_host(keys))
                     if int(k) in self.quarantined_keys)
        if bad:
            raise QuarantinedError(
                f"keys {bad} were lost to media corruption in the last "
                "salvage recovery; readmit() them to start fresh")

    def readmit(self, keys) -> None:
        """Lift the quarantine on ``keys``: the caller accepts that the
        lost history is gone and wants the keys writable again."""
        self.quarantined_keys -= {int(k) for k in
                                  np.atleast_1d(_host(keys))}

    # -------------------------------------------------------------- read
    def lookup(self, keys) -> torch.Tensor:
        """Dense embedding rows (len(keys), dim) int64 on the store's
        device for ``keys`` (zeros for absent keys).  Raises
        QuarantinedError if any key is quarantined."""
        keys = _host(keys).reshape(-1)
        self._refuse_quarantined(keys)
        slots = self.table._find_slots(torch.from_numpy(keys).to(
            self.device))
        out = self._zeros(len(keys), self.cfg.dim)
        ok = slots >= 0
        out[ok] = self.vectors[slots[ok]]
        return out

    # ---------------------------------------------------------- recovery
    def crash(self) -> None:
        self.vectors = torch.zeros_like(self.vectors)
        self.counts = torch.zeros_like(self.counts)
        self.next_sample = 0
        self.arena.crash()

    def recover(self, concurrency: int = 1, on_stage=None,
                salvage: bool = False):
        """Reopen the arena, then rebuild table, sample log, journal and
        the store's hot rows in dependency order.  Returns the
        RecoveryReport (also in ``last_recovery``).  ``salvage=True``
        quarantines instead of aborting (module docstring)."""
        mgr = RecoveryManager(self.arena)
        emb_regions = tuple(n for n in self.arena.regions
                            if n.startswith("emb.")
                            and not n.endswith(".jrnl")
                            and not n.endswith(".integ"))
        sx_regions = tuple(n for n in self.arena.regions
                           if n.startswith("sx.")
                           and not n.endswith(".integ"))
        mgr.add("emb", "pstruct.hashmap", self.table, regions=emb_regions)
        mgr.add("samples", "pstruct.bptree", self.tree, regions=sx_regions)
        deps = ("emb", "samples")
        if self.journal is not None:
            mgr.add("journal", "serve.journal", self.journal,
                    regions=("emb.jrnl", "emb.header"))
            deps += ("journal",)
        mgr.add("store", "serve.feature_store", self, depends=deps,
                regions=())
        report = mgr.recover(concurrency=concurrency, on_stage=on_stage,
                             salvage=salvage)
        self.last_recovery = report
        if salvage:
            # even if the store stage was skipped (a quarantined
            # dependency), the table's losses still gate
            self.quarantined_keys |= {int(k) for k in self.table.quarantined}
        return report


@rec.register("serve.feature_store")
def _reconstruct_feature_store(fs: FeatureStore) -> dict:
    """Pure rebuild of the hot rows: replay the committed sample log (tree
    records) into the slot-indexed accumulators with one ``index_add_``
    per tensor.  The committed cursor comes from the header line's
    FS_CURSOR word, NOT from the tree's largest key or table values: a
    torn (data-phase-only) crash leaves in-place row rewrites durable in
    both slabs, so only the crash-ordered metadata line says where the
    committed prefix ends.  Torn tree records beyond the cursor are
    ignored here and overwritten when the request retries.  Within the
    committed prefix, holes or unknown keys are corruption: fail
    loudly."""
    cfg = fs.cfg
    salvage = fs.arena._salvage
    fs.quarantined_keys = {int(k) for k in fs.table.quarantined} \
        if salvage else set()
    fs.vectors = fs._zeros(cfg.n_keys, cfg.dim)
    fs.counts = fs._zeros(cfg.n_keys)
    fs.next_sample = fs.table.header.read_one(0, FS_CURSOR)
    if not 0 <= fs.next_sample <= cfg.n_samples:
        msg = f"committed sample cursor {fs.next_sample} out of range"
        if salvage:
            raise CorruptLineError("emb.header", np.array([0], np.int64),
                                   detail=msg)
        raise RuntimeError(msg)
    replayed = missing = 0
    if fs.next_sample:
        sids = torch.arange(fs.next_sample, dtype=torch.int64,
                            device=fs.device)
        ok, recs = fs.tree.find_batch(sids)
        if not bool(ok.all()):
            if not salvage:
                raise RuntimeError(
                    f"sample log has holes: {int((~ok).sum())} missing "
                    f"ids")
            # salvage: quarantined or lost log records replay as holes;
            # the per-key count cross-check below names the losers
            missing = int((~ok).sum())
            recs = recs[ok]
        slots = fs.table._find_slots(recs[:, 0])
        absent = slots < 0
        if bool(absent.any()):
            if not salvage:
                raise RuntimeError(
                    "sample log names keys absent from the committed "
                    "table")
            # the table lost these keys (row quarantined): their log
            # records survive and name them precisely
            fs.quarantined_keys.update(recs[absent, 0].tolist())
            recs, slots = recs[~absent], slots[~absent]
        fs.vectors.index_add_(0, slots, recs[:, 1:1 + cfg.dim])
        fs.counts.index_add_(0, slots, torch.ones_like(slots))
        replayed = int(slots.shape[0]) if salvage else fs.next_sample
    if salvage:
        # the table's committed per-key apply counters against the
        # replayed ones: a key whose samples were lost (its log record
        # was corrupt, so the key inside it is unreadable) falls short
        # and is quarantined BY NAME here
        fresh = int(fs.table.header.read_row(0)[HM_FRESH])
        tk = fs.table.keys[:fresh]
        short = (tk != KEY_NULL) & (fs.table.values[:fresh, 0]
                                    != fs.counts[:fresh])
        fs.quarantined_keys.update(tk[short].tolist())
    detail = {"samples": replayed, "keys": fs.table.size}
    if fs.journal is not None:
        detail["journal_completed"] = sum(
            1 for s in fs.journal.classify().values() if s == ST_DONE)
    if salvage and (fs.quarantined_keys or missing):
        detail.update(degraded=True, missing_samples=missing,
                      quarantined_keys=sorted(fs.quarantined_keys))
    return detail
