"""Paged KV-cache allocator, the port of ``repro.serve.kvcache``.

Device tensors hold the actual KV pages; this module manages the page
metadata:

* page table (request -> page list) + request payloads: ESSENTIAL
  (persisted through the arena; 64 B rows);
* the free list and the LRU eviction order: a DoublyLinkedList whose NEXT
  chain is persistent and whose PREV/tail/order ring are volatile
  redundancy, reconstructed after a crash;
* the KV page contents on the device: DERIVABLE, re-prefilled from the
  persisted request payloads on recovery.

The DLL's node rows live on the arena's device; the allocator's own
bookkeeping (``owner``, ``pages_free``, ``page_of_node``) is host numpy,
as in the reference, so allocation decisions cost no device sync beyond
the DLL's own.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import reconstruct as rec
from repro_torch.core.arena import open_arena
from repro_torch.core.recovery import RecoveryManager, RecoveryReport
from repro_torch.pstruct.dll import DoublyLinkedList


@dataclasses.dataclass
class PagedConfig:
    n_pages: int = 1024
    page_tokens: int = 64
    mode: str = "partly"
    n_shards: int = 1      # shard count of the page-metadata arena
    commit_mode: str = "barrier"   # "barrier" | "shadow"
    # chain-ranking strategy for the LRU ring scan after a crash
    chain_method: str = "auto"
    # order snapshots: None defers to REPRO_SNAPSHOT
    snapshot: Optional[bool] = None
    # paged regions (DESIGN.md §12): None defers to REPRO_PAGED (default
    # off).  With paging on, the node slab's volatile side is a block pool
    # behind an LRU cache of cache_blocks x block_bytes, and recovery
    # faults only the blocks it touches.
    paged: Optional[bool] = None
    block_bytes: int = 4096
    cache_blocks: int = 1024


class PagedAllocator:
    """LRU page pool.  Data row of the DLL node = (page_id, owner_request,
    first_token, n_tokens, 0, 0, 0).

    With ``n_shards > 1`` the LRU's node slab stripes across the arena's
    shards (the DLL's segment router), so the page-metadata flushes of an
    allocation burst fan out over the shard files (DESIGN.md §7)."""

    def __init__(self, cfg: PagedConfig, path: Optional[str] = None,
                 device=None):
        self.cfg = cfg
        layout = DoublyLinkedList.layout(cfg.n_pages, cfg.mode, name="lru",
                                         snapshot=cfg.snapshot)
        self.arena = open_arena(path, layout, n_shards=cfg.n_shards,
                                commit_mode=cfg.commit_mode,
                                paged=cfg.paged,
                                block_bytes=cfg.block_bytes,
                                cache_blocks=cfg.cache_blocks, device=device)
        self.lru = DoublyLinkedList(self.arena, cfg.n_pages, cfg.mode,
                                    name="lru",
                                    chain_method=cfg.chain_method,
                                    snapshot=cfg.snapshot)
        self.page_of_node: Dict[int, int] = {}
        # free pages as a numpy stack (top = end)
        self.pages_free: np.ndarray = np.arange(cfg.n_pages,
                                                dtype=np.int64)
        self.owner: np.ndarray = np.full(cfg.n_pages, -1, np.int64)
        self.last_recovery: Optional[RecoveryReport] = None

    def alloc(self, request_id: int, n: int) -> np.ndarray:
        """Allocate n pages to a request (LRU-evicting if exhausted).
        Eviction, append and commit share one epoch."""
        with self.arena.epoch():
            if len(self.pages_free) < n:
                self._evict(n - len(self.pages_free))
            top = len(self.pages_free) - n
            pages = self.pages_free[top:][::-1].copy()
            self.pages_free = self.pages_free[:top]
            vals = np.zeros((n, 7), np.int64)
            vals[:, 0] = pages
            vals[:, 1] = request_id
            ids = self.lru.append_batch(vals)
            for nd, pg in zip(ids.tolist(), pages.tolist()):
                self.page_of_node[nd] = pg
            self.owner[pages] = request_id
            self.arena.commit()
        return pages

    def free_request(self, request_id: int) -> None:
        pages = np.nonzero(self.owner == request_id)[0]
        if pages.size == 0:
            return
        nodes = [nd for nd, pg in self.page_of_node.items()
                 if self.owner[pg] == request_id]
        with self.arena.epoch():
            self.lru.delete_batch(np.asarray(nodes, np.int64))
            for nd in nodes:
                self.page_of_node.pop(nd, None)
            self.owner[pages] = -1
            self.pages_free = np.concatenate([self.pages_free, pages])
            self.arena.commit()

    def _evict(self, n: int) -> np.ndarray:
        nodes = self.lru.pop_front_batch(n)
        pages = np.asarray([self.page_of_node.pop(nd)
                            for nd in nodes.tolist()], np.int64)
        self.owner[pages] = -1
        self.pages_free = np.concatenate([self.pages_free, pages])
        return pages

    def pages_of(self, request_id: int) -> np.ndarray:
        return np.nonzero(self.owner == request_id)[0]

    # ------------- crash recovery -------------
    def recover(self, concurrency: int = 1, on_stage=None) -> float:
        """Rebuild all volatile metadata from the persistent NEXT chain and
        node payloads through the recovery manager: LRU chain first, page
        tables second.  Returns seconds (the full RecoveryReport lands in
        ``last_recovery``)."""
        mgr = RecoveryManager(self.arena)
        lru_regions = ("lru.nodes", "lru.header")
        if self.lru.snapshot:
            lru_regions += ("lru.snapring", "lru.snaprec")
        mgr.add("lru", "pstruct.dll", self.lru, regions=lru_regions)
        mgr.add("pages", "serve.paged_alloc", self, depends=("lru",),
                regions=("lru.nodes",))
        report = mgr.recover(concurrency=concurrency, on_stage=on_stage)
        self.last_recovery = report
        return report.total_seconds


@rec.register("serve.paged_alloc")
def _reconstruct_paged_alloc(pa: PagedAllocator) -> dict:
    """Pure rebuild of owner/page_of_node/pages_free from the reconstructed
    LRU: one gather of the node payloads (one copy to the host)."""
    order = pa.lru.order()          # materialized by the DLL reconstructor
    vals = pa.lru.data_rows(order).cpu().numpy()   # block-routed, no spill
    pages = vals[:, 0]
    pa.page_of_node = dict(zip(order.tolist(), pages.tolist()))
    pa.owner = np.full(pa.cfg.n_pages, -1, np.int64)
    pa.owner[pages] = vals[:, 1]
    free = np.ones(pa.cfg.n_pages, bool)
    free[pages] = False
    pa.pages_free = np.nonzero(free)[0].astype(np.int64)
    return {"pages_live": int(pages.size),
            "pages_free": int(pa.cfg.n_pages - pages.size)}
