"""Larger-than-memory arena on the port: demand-paged crash recovery, the
counterpart of ``examples/paged_arena.py``.

Builds a paged-KV allocator whose node slab is ``--factor`` times the block
cache's budget (DESIGN.md §12), churns about 75 % of it, frees all but two
requests, crashes, recovers, and prints how many blocks each recovery
stage faulted against the arena's total: recovery reads the working set,
not the file.  With the defaults it prints the same pool size, per-stage
block faults and totals as the reference's example.  It runs on the GPU;
``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python -m repro_torch.paged_arena [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.core.arena import resolve_device
from repro_torch.serve.kvcache import PagedAllocator, PagedConfig

BLOCK_BYTES = 4096
CACHE_BLOCKS = 64
FACTOR = 10                           # arena bytes / cache capacity


def run(device=None, factor: int = FACTOR, cache_blocks: int = CACHE_BLOCKS,
        block_bytes: int = BLOCK_BYTES, out=print) -> dict:
    """Build, churn, crash and recover the paged allocator; ``out`` takes
    each printed line.  Returns the per-stage faults and the cache's
    counters."""
    device = resolve_device(device)
    rows_per_block = block_bytes // 64    # partly-mode DLL node row: 64 B
    n_pages = factor * cache_blocks * rows_per_block
    with tempfile.TemporaryDirectory() as tdir:
        # snapshots seed the LRU order from the newest committed record
        # (DESIGN.md §10), so the lru stage faults only what it verifies
        pa = PagedAllocator(PagedConfig(n_pages=n_pages, paged=True,
                                        snapshot=True,
                                        block_bytes=block_bytes,
                                        cache_blocks=cache_blocks),
                            path=os.path.join(tdir, "pool.bin"),
                            device=device)
        cache = pa.arena.cache
        out(f"pool: {n_pages} pages, cache budget "
            f"{cache.capacity_bytes / 1024:.0f} KiB "
            f"({cache_blocks} x {block_bytes} B blocks)")
        # churn ~75% of the slab, then free all but two requests: the
        # file has seen most pages, the live working set is ~10% of them
        touched = int(n_pages * 0.75)
        rid = 0
        for i in range(0, touched, 2048):
            pa.alloc(rid, min(2048, touched - i))
            rid += 1
        keep = {0, rid // 2}
        for r in range(rid):
            if r not in keep:
                pa.free_request(r)
        live = sum(len(pa.pages_of(r)) for r in keep)
        out(f"built: {rid} requests churned {touched} pages; "
            f"{live} live after frees; cache peak "
            f"{cache.peak_resident_bytes / 1024:.0f} KiB")

        pa.arena.crash()
        cache.reset_peak()                # recovery's own residency
        t0 = time.perf_counter()
        pa.recover()
        secs = time.perf_counter() - t0

        total_blocks = sum(r.total_blocks
                           for r in pa.arena.regions.values()
                           if r.is_paged)
        out(f"\nrecovered in {secs * 1000:.1f} ms; per-stage faults "
            f"(of {total_blocks} paged blocks total):")
        faulted, stages = 0, {}
        for st in pa.last_recovery.stages:
            bf = st.detail.get("block_faults")
            stages[st.name] = bf
            if bf is None:                # the reopen prologue: lazy reset
                out(f"  {st.name:<8} {st.seconds * 1000:7.2f} ms  (lazy)")
                continue
            faulted += bf
            out(f"  {st.name:<8} {st.seconds * 1000:7.2f} ms  "
                f"{bf:4d} blocks faulted")
        out(f"\nfaulted {faulted}/{total_blocks} blocks "
            f"({100 * faulted / total_blocks:.0f}% of the arena); "
            f"peak resident {cache.peak_resident_bytes / 1024:.0f} KiB "
            f"<= budget {cache.capacity_bytes / 1024:.0f} KiB "
            f"(+admit slack); spills={cache.spills}")
        row = {"n_pages": n_pages, "total_blocks": total_blocks,
               "stages": stages, "faulted": faulted,
               "faults": cache.faults, "hits": cache.hits,
               "evictions": cache.evictions, "spills": cache.spills,
               "peak_resident_bytes": cache.peak_resident_bytes,
               "peak_pool_bytes": cache.peak_pool_bytes,
               "recover_s": secs}
        pa.arena.close()
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--factor", type=int, default=FACTOR)
    args = p.parse_args(argv)
    run(args.device, factor=args.factor)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
