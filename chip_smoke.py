#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py [--report PATH] [--crossover-study]
    python3 chip_smoke.py --ab-parent DIR [--ab-crossover | --ab-model | --ab-paged] [--report PATH]

Phases (any failure exits non-zero; no phase catches its own failure):

1. card: name and power limit (nvidia-smi), build of every CUDA kernel
   from ``src/repro_torch/csrc`` (all compilers started together), the
   registers, spills, stack and shared memory of each flash kernel
   (forward; backward: the dK/dV and dQ kernels and the Di pass, each in
   both dtypes at every head width; the D = 256 kernels, gemma2's, on a
   line of their own), and
   the pinned device-to-host rate (256 MB copies), the link bound of the
   drains;
2. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes, exact equality (integer results, the quantize
   kernels' int8, scales and dequantized floats, and ``scatter_rows`` at
   the phase-7 cache leaf: tolerance 0), ``flash_attention`` within 1e-4
   in f32 (summation order) and 2e-2 in bf16 (the kernel's rounding of P
   and one bf16 rounding of the output), causal with 96 query heads over
   32 KV heads at S = 1024 and at the four shapes phase 7 gives it, in
   both dtypes, and a ragged S = 1000 in f32; untimed at every head width
   (16, 32, 64, 128, 256) in both dtypes, causal and not, 6 heads over 2
   at S = 1000; with a sliding window and a score softcap at
   gemma3-27b's local layer (q (32, 3072, 128) over (16, 3072, 128),
   window 1024) and gemma2-9b's (q (16, 4608, 256) over (8, 4608, 256),
   window 4096, softcap 50), both dtypes, timed beside the band-counted
   flop bound (4 D flops per kept pair), the same call without the
   window and ``sdpa`` with the boolean band mask (none for a softcap),
   and untimed at window 1, 100, 129, S and 5 S, causal and not, a
   softcap alone at D = 64 and 128 and both at D = 256;
   ``dequantize_blockwise(dtype=bf16)`` bitwise against its plain
   version at phase 6's embed rows, timed beside its bytes; a llama3.2-3b
   bf16 prefill at full width and depth (2 x 1536 tokens) through the
   kernel against the same prefill through the plain version, logits
   within 5e-2 of the largest |logit|;
   ``flash_attention_bwd`` against its plain version on the
   forward kernel's o and lse at every head width (256 included) in both
   dtypes, causal and not, 6 query heads over 6 and over 2 KV heads, at
   S = 1000 and at Sq = 77 over Skv = 333: within 1e-4 (f32) and 2e-2
   (bf16) of the largest |grad|, two runs equal bit for bit, the
   forward's lse within 1e-5 of the plain one's, the Di pass within 1e-5
   of the largest |Di|; the same checks with a window and a softcap at
   window 1, 100, 129, S and 5 S, causal and not, a softcap alone at
   D = 64 and 128, both at D = 256 (also Sq = 77 over Skv = 333 and 333
   over 77, where rows see no key), and at phase 16's training layers:
   gemma3-27b's local layer (q (32, 2048, 128) over (16, 2048, 128),
   window 1024) and gemma2-9b's local and global ones (q (16, 8192, 256)
   over (8, 8192, 256), softcap 50, window 4096 and none), both dtypes,
   timed beside the band-counted flop bound (10 D flops per kept pair),
   the design's floor (14, 22 at D = 256), the same call without the
   window and ``sdpa``'s backward with the boolean band mask (none under
   a softcap);
   flash_attention's autograd on CUDA tensors (one backward launch,
   non-zero grads equal to torch autograd through the plain forward); the
   backward timed at phase 10's shape (96 query heads over 32 KV heads,
   S = 1024, D = 128, causal), f32 and bf16, beside its flop bound (10
   flops per causal pair and width), its design's floor (14) and
   ``scaled_dot_product_attention``'s backward, and each of its kernels
   alone (the Di pass beside its bytes);
   ``quantize_blockwise`` exact on groups holding NaN, +inf and -inf;
   ``probe`` and
   ``probe_hashed`` (``hash_lookup``'s form), both kernels (grouped and
   query-major) and the dispatch between them, exact on phase 8's table
   at its uniform queries (also with out-of-range bucket ids), at 2**22
   Zipf(1.1) queries over the present keys, at 2**20 queries in one
   bucket and at 1, 31, 33 and 1024 queries; each kernel timed with CUDA
   events beside its bound and, where one exists, one PyTorch library
   call computing the same function (``probe`` uniform, Zipf and one
   bucket beside bytes once and the sector bound, with the grouped
   kernel's stage shares from its %globaltimer stamps, and both kernels
   swept over 2**10..2**22 queries at 2**16 and 2**20 buckets, the
   crossover GROUPED_MIN_QUERIES rests on); then the grouped
   ``pack_rows`` at two drains captured from real structures (one epoch
   of the DLL and of the hashmap, 2**22, partly, snapshots on) and at its
   edge cases (-1 and out-of-range indices, empty regions, 4/12/20 B rows,
   more than 64 regions), exact against its plain version, the write
   set's gather exact against the per-region gather; each drain's device
   half (indices up, gather, rows to the host, synchronize) timed on the
   host clock and with CUDA events, in rotating order, as the write set's
   grouped gather (the kernel writing pinned host memory), as the same
   kernel into a device buffer plus one pinned download, as the
   per-region gather drains used before and as ``index_select`` per
   region with one ``torch.cat``, beside the kernel alone and the bound
   (bytes once at 3.35 TB/s or the staging bytes at phase 1's link
   rate); then ``jump_double(rounds=)`` in its three main-path forms (the
   tables of ``_contract_tables``, the counted tables of ``chain_order``,
   ``_absorb``) at 2**16, the contracted 131,073, 2**18 and 2**22 nodes
   with NULLs, out-of-range values and a cycle, and
   ``gather_next(hops=)`` at 2, 8 and 16 hops from 8192 lanes over
   2**22 pointers (unsanitized, int64 ids with 2**32 + 3 and int32 ids,
   and the hashmap's bucket chains), exact against their plain versions
   (walk and length); each timed with CUDA events under the L2 eviction
   as one launch and as one launch per round or per hop, beside its
   bound for the call and per round or hop; and a delete batch's whole
   ``chain_walk`` against the per-column walk it replaced, on the host
   clock; then the contraction on a random 2**22-node permutation chain
   (and, after phase 3, on the DLL chain phase 3 recovered):
   ``walk_segments`` in its new form (one launch of the whole budget,
   with checkpoints; checkpoints compared as a set) and its old one (the
   first round of 64 hops), ``expand_segments`` on the split plan (runs of
   at most MARK_STRIDE ids) and on the unsplit one, all exact against
   their plain versions and the chain, timed with CUDA events with the L2
   evicted and with nxt resident, beside their bytes-once and sector
   bounds and the round driver's launches back to back; the whole
   contraction (``contract_walk``, ``_order_contract``) against the round
   driver and the unsplit plan on the host clock, L2 evicted and warm;
   the checkpoint stride at 8, 16 and 32; the walk and the expand once
   at 2**24 nodes (nxt larger than the L2); and the contraction's other
   paths (several heads through ``spine_pos``, k = 7, torn pointers, and
   the plan's second walk for merged segments, a spine-free cycle and a
   cycle under explicit counts), card against CPU; and
   the four chain kernels on the shard-major packed layout
   (``segments=``/``seg_rows=``) of a random 2**22 chain packed by
   ("seg", 64) over 4 and over 3 shards, and over 4 shards with one
   padding row after each shard's rows but the last's (offsets with
   gaps, launched with the offsets in the kernel parameters): a counted
   ``jump_double`` round and chain_order's doubling tables (21 rounds),
   a ``gather_next`` hop of 7n/8 int64 ids, the contraction's
   ``walk_segments`` (checkpoints as a set) and ``expand_segments`` on
   its split plan, each exact against its plain version with the same
   segments and against the same kernel on the global layout, timed with
   CUDA events, L2 evicted, beside that global launch, its bound and
   (gapped) the closed-form launch over the router's partition; and the
   smallest gapped input (a 6-node chain at offsets [0, 5, 7]), where
   ``gather_next`` must answer [1, 2, 3, 4, 5, -1] and ``chain_order``
   rank both ways;
3. main path: the quickstart loop (insert, delete/pop, commit, crash,
   reopen, reconstruct) for the DLL and the hashmap at 2**22 entries and
   the B+Tree at 2**17 (cut from 2**19 for the time of phases 14 and
   15; phase 11's integrity-off B+Tree twin is this run), both modes,
   order snapshots and integrity pinned off, every epoch drain through
   ``pack_rows``; the recovered state is checked; ``pack_rows`` launches
   must equal the write sets' grouped gathers (one per drain);
   ``jump_double`` must launch once per ``chain_tables``/``_absorb`` call
   and every level-synchronous hashmap ``chain_walk`` within 1 +
   ceil(log2(columns / 8)) ``gather_next`` launches, ``walk_segments`` once
   per ``contract_walk`` call and ``expand_segments`` once per split plan,
   no run longer than MARK_STRIDE (counted at the call sites); then device
   syncs per operation, snapshots off and on;
4. card vs CPU: the same workload at 2**14 on ``cuda`` and on ``cpu``
   must write identical arena images (sha256) and FlushStats; with order
   snapshots on, the DLL and hashmap runs of phase 5 at 2**14 must also
   give identical stage details (timing fields aside); a checkpoint of a
   small llama3.2-3b-shaped state (d_model 256, 2 layers) under each of
   the four policies must write identical files (sha256) on both; and
   a llama3.2-3b engine at full width, 2 layers, f32, parameters drawn
   on the CPU and copied to the card, serving two requests for 8 steps
   on each (also: a train state with bf16 moments under each
   policy, identical files and an exact restore on the card; the hashmap
   workload at pack_flush_rows 0, 1 and 10**6, one and four shards,
   identical images and FlushStats, pack_rows launches equal to
   gathers): prefill and decode logits within 1e-4 of the largest |logit|,
   the same tokens (a differing token passes only where its top-2 logit
   gap is below that tolerance) and identical engine arena files; the
   feature store (both modes, journal on and off: 48 requests, a torn
   crash, recovery, a replay of 64), a sample index (3000 ids, crash,
   recover) and ``ops.pack_rows``/``scatter_rows`` at D = 100 and 256,
   with identical images, FlushStats and answers; with integrity on (the
   only arenas of phases 1-10 that have it), the quickstart workload at
   2**14 for each structure in both modes and a mixed DLL + B+Tree +
   hashmap arena (2**14, 2**12, 2**14; snapshots on) in both modes, then
   a crash, the same flipped rows, scrub and a salvage recovery: identical
   images (``.integ`` sidecars included), FlushStats (``integrity_lines``
   included), scrub results, salvage reports (timing aside) and recovered
   states; the quickstart workload at 2**14 for each structure in both
   modes on four-shard arenas, integrity off and on: identical shard
   images, manifests and FlushStats (aggregate and per shard), and on
   four-shard shadow arenas (committed after the inserts too, recovered
   through the per-region load stages) identical shard images, manifests,
   FlushStats and recovered states; on shadow
   arenas (one arena, DESIGN.md §9), the quickstart workload at 2**14 for
   each structure in both modes (committed after the inserts and after
   the deletes, integrity off), then the mixed arena with integrity on in
   both modes, faulted in one row of each structure that the
   authoritative bank remaps: identical images (both remap banks, the
   mirrors and the meta line included), FlushStats, recovered states,
   scrub results and salvage reports; then the serving
   launcher ``repro_torch.launch.serve --arch llama3.2-3b --crash`` on
   the card, which must return 0 after recovering, and the same for
   ``--arch gemma3-27b`` and ``--arch gemma2-9b``; reduced gemma3-27b and
   gemma2-9b (window 8, softcaps 50 and 30 for gemma2) trained 3 steps in
   f32 on the card and on the CPU from the same parameters, losses within
   1e-5 relative; reduced dbrx-132b and llama4-maverick-400b-a17b (4
   experts, top 2 and 1, groups of 64) served as the llama3.2-3b engine
   is, prefill and decode logits within 1e-4 with the same tokens, and
   trained 3 steps in f32 on the card (twice, torch's kernels
   deterministic: losses and parameters equal bit for bit) and on the
   CPU, losses within 1e-5 relative; ``launch.serve --arch dbrx-132b
   --crash`` and ``launch.train --arch llama4-maverick-400b-a17b
   --crash-at-step 6`` on the card, rc 0; before those, the card's bf16
   products with f32 results (``torch.mm``/``bmm`` with ``out_dtype``)
   against the CPU's upcast on the same bf16 values: ``decode_attention``
   at ROADMAP Queue 3 item 19's smallest input, softcap 0 and 50, within
   2**-7 of the largest |output| (the scores rounded to bf16 before the
   cap, run beside it, must exceed that), and ``f32_product`` at
   llama3.2-3b's gate and dbrx-132b's expert widths within 5e-5 of the
   largest |result| (the product rounded to bf16 must exceed that), with
   ``gate_up`` and the 2-D product's gradients within 2**-7;
5. snapshot recovery: the DLL and the hashmap at 2**22 entries, both
   modes, order snapshots on, a commit after every batch of 8192, then
   deletes and pops, a commit, a suffix of 120 appends or inserts and a
   commit; crash and recover through ``RecoveryManager`` three times
   (clean; newest record torn; whole snapshot ring corrupted), checking
   ``chain``/``replayed`` and the recovered state each time; launches
   equal to gathers and the chain calls checked as in phase 3; then
   ``pack_rows``, ``jump_double`` and ``gather_next`` timed at every
   power-of-two size, and hop or round count, phases 3 and 5 launched
   them at (and ``jump_double`` at the contracted 131,073), for
   launches x (time - bound), beside the same work at one launch per
   round or per column; and ``walk_segments``/``expand_segments`` at
   every chain size phases 3 and 5 contracted, beside the round driver's
   launches and the unsplit expand;
6. checkpoint: a train state at the full width of llama3.2-3b, cut to 4
   layers (params, mu and nu: 796,683,264 parameters each, 9.56 GB on the
   card), saved by ``CheckpointManager`` under ``PARTLY_Q8`` with
   incremental on, saved again unchanged (0 bytes), "crashed" (manager
   and state dropped), restored inline and with background warmup; params
   must match the manifest's md5 digests, moments equal the plain
   dequantization of their files exactly and lie within amax/127 of the
   originals, ``rng`` equal ``rebuild_rng(seed, step)``;
7. serving: llama3.2-3b at full width and depth (28 layers,
   3,212,749,824 parameters, f32), two ``ServingEngine``s with
   ``max_batch=8, s_max=2048`` (3.76 GB of KV cache each), journal and
   order snapshots on, eight numpy-seeded prompts of 1536, 1536, 1024,
   1024, 512, 512, 128 and 128 tokens; 8 steps, one request finished, 8
   steps, then one engine crashes and recovers (four re-prefill groups)
   beside its twin: caches within 1e-4 of the largest |k|, |v|, 8 more
   steps with equal tokens and logits within 1e-4 relative, the finished
   request refused, a new request seated on its slot
   (``repro_torch.serve_recover.run``);
8. hash lookup: ``ops.hash_lookup`` over a (2**20, 128) int32 table
   (512 MiB) holding 2**25 distinct keys placed by ``hash32`` (mean load
   32 of 128, no bucket overflowing), 2**22 shuffled queries: half
   present keys, a quarter absent, a quarter negative ints with -1 among
   them; every answer equal to a numpy oracle built from the placement,
   and again at the Zipf queries; exactly one ``probe`` launch per
   ``hash_lookup`` call; ``hash_lookup`` (uniform and Zipf), torch's
   ``hash32`` pass alone (the hashing the kernel took over, a yardstick)
   and ``probe`` on precomputed buckets timed under the same L2
   eviction;
9. feature store: ``FeatureConfig(n_keys=2**22, dim=4, n_samples=2**18)``,
   partly, journal on; 256 requests of 1024 unique keys (of 2**21),
   deltas in [-9, 9]; a torn crash in request 192, recovery, a replay of
   all 256 that must refuse exactly the 192 completed ones, and vectors,
   counts, cursor and journal classes equal to an uninterrupted twin's
   (``repro_torch.feature_recover.twin``); then a ``SampleIndex`` of
   2**18 ids, one add, crash, recover, a lookup of every 13th id;
   launches equal to gathers as in phase 3, and ``walk_segments`` once
   per ``contract_walk`` call (it contracts no chain);
10. training: llama3.2-3b at its published widths, cut to 4
   layers (796,683,264 parameters; params, grads and moments 12.7 GB),
   f32, 4 x 1024 tokens a step, PARTLY_PERSISTENT with async checkpoints
   every 4 steps, a crash after step 5, a resume at 4 and a run to 6
   (a 9.56 GB save before the crash), beside an uninterrupted twin of 6
   steps (cut from 12 steps and a crash after 10, then from 8 and a save
   after the resume, for the run's time),
   torch's kernels
   deterministic (``CUBLAS_WORKSPACE_CONFIG`` is set before phase 1):
   every loss and the final parameters equal the twin's bit for bit
   (delta 0); flash_attention launched 2 x layers per step (the forward
   and its recomputation under remat), flash_attention_bwd layers per
   step; step ms, tokens/s, each save's seconds and bytes, the restore's
   stages, peak memory and one more step's attention share (CUDA events
   around the flash launches); then the same step in bf16 (``Model(cfg,
   compute_dtype=torch.bfloat16)``, as the launcher trains on a card), no
   checkpoint inside the steps, run twice for 6 steps from the same
   parameters: losses and final parameters equal bit for bit, flash
   launches 2 x layers and layers a step, step ms, tokens/s and one more
   step's attention share; the small checkpoint config trained 3 steps on
   the card and on the CPU from the same parameters (losses within 1e-5
   relative); and ``repro_torch.launch.train --arch
   llama3.2-3b --crash-at-step 6 --steps 10 --device cuda`` (reduced,
   bf16) with ``python -m`` in a process of its own, as users run it
   (the launcher sets ``CUBLAS_WORKSPACE_CONFIG`` itself there), which
   must return 0;
11. integrity and salvage (DESIGN.md §13), with ``REPRO_INTEGRITY``
   unset so integrity resolves on: phase 3's workload with integrity on
   and snapshots off (DLL and hashmap 2**22, the B+Tree 2**17), both
   modes, whose lines, bytes and calls must equal phase 3's (for the
   B+Tree, an integrity-off run here) with integrity_lines > 0, insert
   and delete seconds beside the integrity-off run's and the
   persisted-line throughput (data + snapshot + journal + sidecar lines
   per second of drain) on over off beside the reference's 0.95 gate; a
   clean scrub of each committed image must return {} (seconds printed);
   the reference's gate itself (30,000 hashmap inserts in epochs of
   1024, on and off interleaved, best of 7); then a mixed arena (DLL and
   hashmap 2**22, B+Tree 2**17, partly, snapshots on), ``pack_rows``
   launches equal to gathers, crashed and recovered with salvage three
   times: no fault (every structure exact); a flip in the B+Tree's second
   leaf (the DLL and hashmap exact, the B+Tree's survivors a subset of
   its keys disjoint from its quarantined ones); flips in the DLL node at
   chain position 2**21, one hashmap entry and that leaf and a stuck line
   in a later DLL row (the DLL its pre-crash order cut at 2**21, the
   hashmap missing and quarantining exactly the flipped entry's key);
   scrub must name exactly the faulted rows, and ``jump_double``,
   ``gather_next``, ``walk_segments`` and ``expand_segments`` must launch
   over the two faulted recoveries; a full-mode B+Tree quarantines
   wholesale and its dependent stage reports ``skipped``; a corrupt
   header is ``ManifestError`` under salvage, a truncated backing file
   ``ShardLossError`` at open; the feature store at phase 9's config
   (64 requests): one key's table row flipped, exactly that key refused
   until ``readmit``, every other key's effects equal to an uninterrupted
   twin's; phase 4's engine at full width, 2 layers: rid 0's token-log
   row flipped, that rid refused until ``readmit``, the others' logits
   within 1e-4 of a twin's; ``CheckpointCatalog`` at its default
   capacity, 1024 steps recorded, crash, reopen, ``steps()`` and
   ``latest()`` unchanged.  The phase's seconds are printed;
12. sharded arenas (DESIGN.md §7, barrier commit), four shards: phase
   3's workload (DLL and hashmap 2**19, the B+Tree 2**15: cut from 2**22
   and 2**17 for the time phase 13's four-shard half takes), both modes,
   integrity off, recovered through
   ``RecoveryManager(concurrency=4)`` with per-region load stages: the
   recovered state checked, the DLL's and hashmap's aggregate
   FlushStats equal in every field but ``calls`` (one flush call per
   shard file written) to a one-shard run of the same just before it
   (phase 3's, at phase 3's sizes), the shards' lines and bytes summing
   to the aggregate, ``pack_rows`` launches equal to the grouped gathers
   and no more gathers than the one-shard run's, and insert, delete and
   recovery seconds beside it;
   the packed API on the committed partly DLL: its shards'
   persistent NEXT views concatenated, ``chain_order(segments=,
   seg_rows=64)`` by doubling, by contraction and through the snapshot
   verify equal to the DLL's order, the four chain kernels launched,
   each call timed beside the same call on the global column; a mixed
   four-shard arena (DLL and hashmap 2**20, B+Tree 2**15, integrity and
   snapshots on) whose commit crashes after shard k for k = 0..3, each
   recovered to the manifest's generation with the flushed append and
   the next commit sealing the next one, then a clean scrub, a clean
   salvage, and faults in all three structures named exactly by scrub
   and salvaged as phase 11's; a truncated and a removed shard file
   (``ShardLossError``) and a scribbled manifest (``ManifestError``,
   under salvage too); phase 4's 2-layer full-width engine on four
   shards through the twin protocol (one re-prefill group per
   (token-log shard, prompt length), none spanning shards, logits within
   1e-4 of the twin's) and the feature store at phase 9's config on four
   shards, 64 requests, a torn crash at 48, replaying exactly once beside
   its twin; and the reference's flush gate (``benchmarks/
   flush_batching.py`` ``sharded_sweep``, its quick shape: a B+Tree,
   mixed 1:1, 4000-ns line stalls, 1, 2 and 4 shards, best of 3): equal
   line, saved and dedup counts, the 4-shard flush wall at least 1.3x
   faster than one shard's;
13. shadow commit (DESIGN.md §9), on one arena and at four shards.  One
   arena: phase 3's workload,
   committed after the inserts as well (DLL and hashmap 2**19, cut from
   2**22 for time; the B+Tree 2**15), both modes, integrity off, each
   beside a barrier twin of the same run just before it: the recovered
   state checked as in phase 3, ``pack_rows`` launches equal to the
   grouped gathers, one fence a commit, every chain kernel that phase 3
   launched launched here; lines, the lines and rows the rewrites put
   into the remap bank, the entries sealed and the lines the deferred
   folds wrote home, and insert, delete and recover seconds beside the
   twin's; a mixed shadow arena (DLL and hashmap 2**20, B+Tree 2**15,
   partly, integrity and snapshots on): an append torn after its drain,
   one crashed after the seal and before the flip, and a fold of the
   committed bank cut after one region (twice), each recovered to the
   committed generation with every structure exact; then a clean scrub,
   a flip in a DLL row the authoritative bank remaps (the fault's offset
   in that bank's mirror), scrub naming exactly that row, and a salvage
   cutting the DLL there with the others exact; phase 4's 2-layer
   full-width engine through the twin protocol and the feature store at
   phase 9's config, 64 requests, a torn crash at 48 replaying exactly
   once, both on shadow arenas; and the reference's ``shadow_crossover``
   shape (``benchmarks/flush_batching.py``) at one and at four shards: a
   B+Tree, mixed 1:1, epochs of 4 x 64, 250 ns a line and 1 ms a fence,
   barrier and shadow interleaved, best of 2, fences three an epoch
   against one, the four-shard shadow flush wall at least 1.3x faster
   than barrier's (the reference's gate; the one-shard point ungated),
   first in the phase; the four-shard point again at the phase's end
   (after the four-shard serving), reported against the gate; each
   run's epochs profiled on the host clock.  ``--crossover-study`` adds,
   before each, the shard pool's two rules timed against each other
   (``pool_study``).
   Four shards: phase 3's workload (DLL and hashmap 2**20, cut from 2**22
   for the time of phases 14 and 15, B+Tree
   2**15), both modes, integrity off, recovered through RecoveryManager
   (concurrency 4, per-region load stages), each beside a four-shard
   barrier twin just before it: recovered state as in phase 3, one fence
   a commit (none on a shard), ``pack_rows`` launches equal to the
   gathers, one ``scatter_rows`` launch per loaded (region, shard), every
   chain kernel phase 3 launched; a mixed four-shard arena (DLL and
   hashmap 2**20, B+Tree 2**15, integrity on): an append whose commit
   crashes at k = -1 (after the seals), 0, 1, 2, 3 (after shard k's
   flip), each recovered to the manifest's generation without the append,
   every shard re-anchored to it, then a commit sealing the next
   generation on every shard; a clean scrub, a flip in a DLL row shard
   3's authoritative bank remaps, scrub naming exactly it, and a salvage
   cutting only the DLL; the 2-layer engine and the feature store (64
   requests) on four-shard shadow arenas beside twins, one fence a
   commit on every arena;
14. paged regions and the block cache (DESIGN.md §12): (a) the
   reference's ``--paged-parity`` shape (``benchmarks/flush_batching.py``
   ``paged_parity``: a partly DLL of 12,000 nodes, 8192 scattered
   deletes in batches of 256, 16 batches an epoch, 4000 ns a line, 4 KiB
   blocks, a cache that fits the list, best of 3 each side): lines,
   saved lines, snapshot lines, dedup rows, epochs and fences equal
   paged and unpaged, no eviction or spill, flush lines/s paged at least
   0.95x unpaged; the same deletes on a 2**22 DLL with no modeled stall
   and a cache of 65,552 blocks, reported; (b) the reference's
   ``paged_budget_report`` (``benchmarks/recovery_bench.py``) at factor
   10 of a 6554-block cache of 4 KiB blocks (4,194,560 pages), built 75 %
   live in requests of 2048 pages, 64 a commit, interleaved in the LRU as
   decode steps append them, every third request freed; crashed,
   recovered on demand, served (5 allocations, 3 frees): peak resident
   within (cache_blocks + 16) blocks, the pools' peak device bytes
   within twice that, the recovered allocator equal to the pre-crash one
   and to an unpaged reopen of the same file, no spill; block faults per
   stage and recover seconds beside the unpaged reopen's; with snapshots
   (the fast path: only the candidate rows verified) and without them
   (the lru stage ranks the whole NEXT column, read through the cache,
   on the chain kernels, which must launch); (c) the engine's TTFT after
   a crash (first admission plus a decode step) on the full-width
   2-layer llama3.2-3b, paged within 1.5x unpaged (the reference's
   ``--paged-slo`` component B); (d) (b)'s gates on a four-shard shadow
   allocator of 524,160 pages (an 819-block cache; cut from 1639
   blocks for time).  ``pack_rows`` launches equal the grouped gathers
   through the phase, and ``scatter_rows`` launches equal the fault
   batches seated in (a) and (b).  Phase 2 adds the grouped
   ``pack_rows`` over two block pools and a resident 2**22-row region by
   scattered translated indices, and
   ``scatter_rows_`` seating a 64-block fault batch of 4 KiB blocks into
   a 6554-slot pool, each exact and timed beside its bound; phase 4 a
   paged DLL at PARITY_N (512 B blocks, 8 of them) at 1 and 3 shards,
   both modes and both commit modes, card against CPU (images,
   FlushStats, every cache counter, the recovery report, the recovered
   order) and against an unpaged run's image, and a mixed integrity
   arena, paged, whose flipped DLL row makes the demand fault of its
   block raise ``CorruptLineError`` naming the row, card and CPU alike;
15. gemma, f32, through the twin protocol of phase 7
   (``serve_recover.run``, ``max_batch=2``): gemma3-27b at its published
   widths (d_model 5376, 32 heads over 16, head width 128, d_ff 21504,
   vocab 262144, window 1024), 6 layers (one superblock: 5 local, 1
   global; 3.9 B parameters), two prompts of 3072 tokens, 16 steps, the
   first request finished, 16 steps, crash and re-prefill, 32 steps; and
   gemma2-9b at its widths (3584, 16 over 8, head width 256, d_ff 14336,
   vocab 256000, window 4096, softcaps 50 and 30), 4 layers (two
   local/global superblocks), prompts of 4608, 8 + 8 steps, crash, 16
   steps.  Caches, logits and tokens equal the twin's within phase 7's
   tolerances (the rings compared where both hold the same position);
   every prefill, on either engine and in each re-prefill group, calls
   the flash kernel once per local and once per global layer; prefill
   tokens/s, decode ms per slot-step, recovery seconds, peak memory;
16. gemma training at the published widths, depth cut for the card's
   memory and the run's time: gemma3-27b with 2 layers, both local
   (window 1024; 2,235,067,136 parameters, 35.8 GB of f32 params, grads
   and moments), 2 x 2048 tokens a step, so the band hides a quarter of
   the causal pairs (the global layer's backward is phase 10's, with no
   window); gemma2-9b with 2 layers, one local (window 4096) and one
   global, head width 256, softcaps 50 and 30 (1,313,883,648 parameters,
   21.0 GB), 1 x 8192 tokens a step.  Each trained 2 steps in f32 twice
   from the same parameters, then 2 steps in bf16 (as the launcher
   trains on a card) twice, torch's kernels deterministic: losses and
   final parameters equal bit for bit and finite; flash_attention
   launched once a layer a step and once more for each layer a
   superblock's remat recomputes (gemma2's two; gemma3's two layers are
   the pattern's remainder, which is not rematerialized, as in the
   reference), flash_attention_bwd once a layer a step; step ms,
   tokens/s, peak memory and the second twin's last step's attention
   share (CUDA events around the flash launches); then
   ``repro_torch.launch.train --arch gemma2-9b --crash-at-step 6
   --steps 10 --device cuda``
   (reduced, bf16) through its ``main``, which must return 0;
17. MoE serving at the published widths (``models/moe.py``): dbrx-132b
   (d_model 6144, 48 heads over 8, head width 128, 16 experts top-4,
   expert d_ff 10752, vocab 100352, untied) cut to 2 of its 40 layers
   (7,751,301,120 parameters, 31.0 GB) in f32, and llama4-maverick-400b-
   a17b (5120, 40 over 8, 128 experts top-1 of d_ff 8192 with a shared
   expert, dense d_ff 16384, vocab 202048, untied) cut to one superblock
   (a dense and an MoE layer, 18.7 B parameters) with bf16 parameters
   and compute, each through ``serve_recover.run``'s MoE rule: prompts of
   1024 and 4096 tokens (one router group: capacity 1280 and 40), 8
   steps, the first (1024-token) request finished, 8 steps, crash and
   re-prefill (the 4096-token log, 4112 tokens by then, all but its
   last in one group: capacity 1285 and 41), 8 steps.  The recovered caches equal a crash-free prefill of the same
   token logs (1e-4 of the largest |k|, |v| in f32, 2e-2 in bf16) and
   serve on beside it with equal tokens; the decode-built twin is held
   on the first layer's caches only, and its other differences are
   reported with the assignments the re-prefill dropped; the same
   prefill twice gives bitwise-equal logits; every prefill calls the
   flash kernel once a layer; prefill tokens/s, decode ms per slot-step
   beside its weight-read bound, recovery seconds, peak memory.  Then one
   dbrx-width MoE layer in train mode on 1 x 4096 tokens, no optimizer,
   forward and backward twice in f32 and in bf16 compute, torch's
   kernels deterministic: every gradient equal bit for bit.
18. the context archs at their published widths (``models/model.py``
   ``_context``/``_encode``, the ``cross`` layers of
   ``models/backbone.py``): llama-3.2-vision-90b (d_model 8192, 64 heads
   over 8, head width 128, d_ff 28672, vocab 128256, untied, 1600 image
   patches) cut to one superblock, 4 dense layers and the gated cross
   layer of its 100 (6,379,626,497 parameters, 25.5 GB in f32), and
   whisper-large-v3 whole (32 encoder and 32 decoder layers, 20 heads of
   width 64, 1500 frames, s_max 448; 1,954,163,200 parameters), f32,
   each through ``serve_recover.run``'s dense twin rule: prompts of 1024
   and 4096 (vision) or 64 and 224 (whisper) tokens, 4 steps, the first
   request finished, 4 steps, crash and re-prefill (whisper's re-runs
   the encoder over 1500 frames), 4 steps; the engine's context is zeros,
   as the reference engine's is.  Every prefill calls the flash kernel 5
   times (vision: 4 self, 1 cross) or 96 (whisper: 32 encoder, 32 self,
   32 cross).  Then, on the same parameters with every xgate 1, a seeded
   context (the pipeline's ``context_at`` / ``frames_at``), batch 2: the
   prefill through the kernels against the same prefill through
   ``flash_attention_plain`` (1e-4 of the largest |logit| in f32, 5e-2 in
   bf16), a prefill of n tokens and a decode step at n against the
   prefill of n + 1 (1e-4, the reference's rule), and the same prefill
   twice, bitwise.  whisper trained at its published widths and depth, 3
   steps of 2 x 448 tokens with 2 x 1500 frames, f32 and bf16 twins
   bitwise, flash launches a step counted (encoder, self and cross,
   again under remat); one vision cross layer's forward and backward at
   4096 tokens over 1600 patches twice in each dtype, bitwise, its cross
   weights' gradients non-zero.  Phase 2 holds both flash kernels at
   those layers' shapes (non-causal: q (64, 4096, 128) over (8, 1600,
   128), (20, 1500, 64) over (20, 1500, 64), (20, 448, 64) over (20,
   1500, 64)) in both dtypes, timed beside the flop bound and ``sdpa``;
   phase 4 serves the reduced archs with a seeded context and trains
   them card vs CPU, and runs ``launch.serve --arch whisper-large-v3
   --crash`` and ``launch.train --arch llama-3.2-vision-90b`` on the card.
19. hymba-1.5b whole at its published widths (``models/ssm.py``, the
   ``hybrid`` layers of ``models/backbone.py``: 32 layers, a full and
   seven sliding-window layers a superblock, d_model 1600, 25 heads over
   5 of width 64, window 1024, SSM state 16; 1,352,603,200 parameters,
   5.41 GB in f32), f32, through ``serve_recover.run``'s dense twin rule
   with the ``ssm`` state and ``conv`` tail held beside the K/V caches,
   each against its own largest |value|: prompts whose admissions
   prefill 1024 and 4096 tokens (8 and 32 scan chunks; the 4096 wraps
   the local rings) and 999 (one chunk, the chunk rule's fallback), 4
   steps, the first request finished, 4 steps, crash and re-prefill, 4
   steps.  Every prefill calls the flash kernel 32 times (4 full, 28
   windowed) and every seating (admission or re-prefill group) launches
   ``scatter_rows`` once per cache leaf.  After the last step each live
   slot's ``ssm`` and ``conv`` caches, on the recovered engine and on its
   twin, equal a fresh prefill of its logged tokens but the last within
   1e-4 of their largest |value|.  Prefill tokens/s, decode ms per
   slot-step beside the 1.61 ms weight-read bound, recovery seconds,
   peak memory, and the scan's share of a 4096-token prefill and of a
   decode step (CUDA events around ``ssm_scan`` / ``ssm_step``).  Then
   batch 2 of 1025 tokens: the prefill through the kernels against the
   plain attention (1e-4 f32, 5e-2 bf16), a prefill of 1024 and a decode
   step against the prefill of 1025 (1e-4), repeats bitwise.  Then
   trained whole, 2 steps of 2 x 2048 tokens, f32 and bf16 twins
   bitwise, flash launches a step counted (32 forward, 32 under remat,
   32 backward), step ms, attention share, peak, and the scan's share of
   a step (its forward and backward timed alone at the step's shape).
   Phase 2 holds both flash kernels at hymba's attention shapes (q (25,
   4096, 64) over (5, 4096, 64), causal, window 1024 and none) in both
   dtypes; phase 4 serves and trains the reduced hymba card vs CPU and
   runs ``launch.serve --arch hymba-1.5b --crash`` and ``launch.train
   --arch hymba-1.5b`` on the card.
20. xlstm-1.3b whole at its published widths (``models/xlstm.py``, the
   ``mlstm`` and ``slstm`` layers of ``models/backbone.py``: 48 layers,
   six superblocks of seven mLSTM layers and an sLSTM layer, d_model
   2048, 4 heads, mLSTM dv 512 and dk 256, sLSTM dh 512 with a gated MLP
   of 4096, chunk 256, vocab 50432 untied; 1,214,150,992 parameters,
   4.86 GB in f32), f32, through ``serve_recover.run``'s prefill rule,
   every recurrent leaf kind (``mlstm.c`` apart from ``slstm.c``) against
   its own largest |value|: prompts whose admissions prefill 1024 and
   4096 tokens (4 and 16 mLSTM chunks) and 999 (one chunk, the chunk
   rule's fallback), 4 steps, the first request finished, 4 steps, crash
   and re-prefill, 4 steps.  The recovered caches equal a crash-free
   prefill of each live log but its last token within 1e-4 and serve on
   beside it with equal tokens; the decode-built twin is held on its
   first layer within 1e-4 and reported superblock by superblock (a
   chunkwise prefill and the step round differently, and the gates
   amplify that through the sequence and the depth, the reference's
   prefill and decode as much: ``tests/test_torch_xlstm_model.py``).  No
   prefill calls the flash kernel (the model has no attention layer);
   every seating launches ``scatter_rows`` once per cache leaf (25).
   Prefill tokens/s, decode ms per slot-step beside the 1.45 ms
   weight-read bound, recovery seconds, peak memory, and the mLSTM's and
   sLSTM's shares of a 4096-token prefill and of a decode step (CUDA
   events around ``mlstm_chunkwise``/``mlstm_step`` and
   ``slstm_scan``/``slstm_step``).  Then batch 2 of 1025 tokens: a
   prefill of 1024 and a decode step against the prefill of 1025, the
   first layer's caches within 1e-4 and the logits reported, and each
   layer kind alone on the same input to both, its output and caches
   within 1e-4 (no kernel-vs-plain prefill: no flash kernel runs).  Then
   trained whole, 2 steps of 2 x 512 tokens (two mLSTM chunks a layer),
   f32 and bf16 twins bitwise, no flash launch, step ms, tokens/s, peak,
   and the two recurrences' shares of the second twin's last step (CUDA
   events around their forward calls and their backward nodes).
   Phase 4 serves and trains the reduced xlstm card vs CPU and runs
   ``launch.serve --arch xlstm-1.3b --crash`` and ``launch.train --arch
   xlstm-1.3b`` on the card.

``--ab-parent DIR --ab-paged`` runs phase 14 (a)'s paged parity
(ungated) for an unpacked parent tree at DIR and this one in turns, with
each side's flush wall, the ratio and the paged drain's host code per
epoch on the host clock.

The first five kernels' launch counters must move over phases 3 and 5
together, and ``gather_next``'s in phase 5; the quantize kernels' in
phase 6; ``flash_attention``'s and ``scatter_rows``' in phase 7;
``probe``'s in phase 8; ``pack_rows``' and ``jump_double``'s in phase 9;
``flash_attention``'s and ``flash_attention_bwd``'s in phase 10; the
four chain kernels', ``pack_rows``', ``scatter_rows``' (a shard's
reload) and ``flash_attention``'s in phase 12, and again in phase 13;
the four chain kernels', ``pack_rows``' and ``scatter_rows``' in phase
14; ``flash_attention``'s, ``pack_rows``' and ``scatter_rows``' in
phase 15; ``flash_attention``'s and ``flash_attention_bwd``'s in phase
16; ``flash_attention``'s, ``pack_rows``' and ``scatter_rows``' in phase
17; ``flash_attention``'s, ``flash_attention_bwd``'s, ``pack_rows``' and
``scatter_rows``' in phases 18 and 19; ``pack_rows``' and
``scatter_rows``' in phase 20, where neither flash kernel may launch.
Each count is zeroed just before its phase and read just after; phases
3, 5 and 9 also print each kernel's launches by power-of-two size, and
phases 3 and 5 the hops and rounds of the two chain kernels' launches.

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.  ``--report`` also writes every phase's
numbers to a JSON file.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
SECTOR = 32                    # bytes moved by one random DRAM access
BATCH = 8192
MAIN_N = {"dll": 1 << 22, "hashmap": 1 << 22, "bptree": 1 << 17}
SNAP_N = 1 << 22
PARITY_N = 1 << 14
KINDS = ("dll", "hashmap", "bptree")
SNAP_KINDS = ("dll", "hashmap")
CKPT_ARCH, CKPT_LAYERS = "llama3.2-3b", 4
CKPT_SEED, CKPT_STEP = 7, 1000
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
# cut from 12 steps and a crash after 10 (three saves) to two saves for
# the run's time, then to 6 steps and one save (before the crash, at 4;
# the resume runs to 6) when phase 19 came: the save after the resume
# took this phase from 89.9 to 130.7 s of a 1036.6 s run on an NVIDIA
# H100 80GB HBM3 at 700 W, and the save after a restore runs in the
# launchers
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_CRASH_AT = 6, 4, 5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED = 4, 1024, 5
TRAIN_BF16_STEPS = 6           # each of the bf16 step's two runs
TRAIN_CPU_STEPS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 3, 2, 128
TRAIN_LOSS_TOL = 1e-5          # card vs CPU losses, relative
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
SERVE_ARCH = "llama3.2-3b"
SERVE_PROMPTS = (1536, 1536, 1024, 1024, 512, 512, 128, 128)
SERVE_S_MAX, SERVE_STEPS, SERVE_SEED = 2048, 8, 7
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# gemma's flash shapes: (query heads, KV heads, S, D, window, softcap)
GEMMA_FLASH = {"gemma3": (32, 16, 3072, 128, 1024, 0.0),
               "gemma2": (16, 8, 4608, 256, 4096, 50.0)}
# gemma's training layers, phase 16's (one gemma3 sequence of its two a
# step): (query heads, KV heads, S, D, window, softcap)
GEMMA_BWD = {"gemma3": (32, 16, 2048, 128, 1024, 0.0),
             "gemma2_local": (16, 8, 8192, 256, 4096, 50.0),
             "gemma2_global": (16, 8, 8192, 256, 0, 50.0)}
# phase 18's cross and encoder attention, non-causal: (query heads, KV
# heads, Sq, Skv, D); neither 1500 nor 1600 is a multiple of a key tile
CROSS_FLASH = {"vision_cross": (64, 8, 4096, 1600, 128),
               "whisper_encoder": (20, 20, 1500, 1500, 64),
               "whisper_cross": (20, 20, 448, 1500, 64)}
# phase 19's hybrid layers, forward and backward: hymba's 25 query heads
# over 5 KV heads (G = 5), D = 64, a 4096-token sequence, causal, a local
# layer's window 1024 and a full layer's none: (query heads, KV heads, S,
# D, window)
HYMBA_FLASH = {"hymba_local": (25, 5, 4096, 64, 1024),
               "hymba_full": (25, 5, 4096, 64, 0)}
FLASH_PREFILL_TOL = 5e-2       # bf16 prefill logits, of the largest |logit|
LSE_TOL = 1e-5                 # the forward's lse against the plain one's
DI_TOL = 1e-5                  # the backward's Di, of the largest |Di|
PROBE_BUCKETS, PROBE_KEYS, PROBE_QUERIES = 1 << 20, 1 << 25, 1 << 22
PROBE_SEED = 11
PROBE_ZIPF_A = 1.1             # hot-session lookups: Zipf over present keys
PROBE_ONE_BUCKET = 1 << 20     # queries of the one-bucket case
PROBE_SMALL_Q = (1, 31, 33, 1024)
PROBE_SWEEP_Q = (1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 19,
                 1 << 20, 1 << 21, 1 << 22)
PROBE_SWEEP_BUCKETS = (1 << 16, 1 << 20)
FS_CONFIG = {"n_keys": 1 << 22, "dim": 4, "n_samples": 1 << 18}
FS_REQUESTS, FS_KEYS_PER_REQUEST, FS_KEY_SPACE = 256, 1024, 1 << 21
FS_CRASH_AT, FS_SEED = 192, 5
INDEX_N = 1 << 18
LINK_BYTES = 256 << 20         # the pinned device-to-host copy of phase 1
DRAIN_FILL = 64                # batches before the captured drain
CONTRACTED_N = 131073          # the 2**22-node chain contracted by 32
ROUND_SIZES = (1 << 16, CONTRACTED_N, 1 << 18, 1 << 22)   # jump_double
# pack_rows launches on an H100 when drains launched once per region
PER_REGION_PACK_LAUNCHES = {"main_path": 5568, "snapshot_recovery": 10867,
                            "feature_store": 4616}
TIMING = {"seconds", "t_start", "t_end", "ready_at", "queue_wait",
          "total_seconds", "wall_ms", "total_ms", "critical_path_ms"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ workload

def build_structure(kind: str, mode: str, n: int, device,
                    snapshot: bool = False, integrity: bool = False,
                    n_shards: int = 1, commit_mode: str = "barrier",
                    pack_flush_rows: int = 0):
    """One structure on its own arena (``n_shards`` of them: sharded),
    every feature axis pinned."""
    from repro_torch.core.arena import open_arena
    from repro_torch.pstruct.bptree import BPTree
    from repro_torch.pstruct.dll import DoublyLinkedList
    from repro_torch.pstruct.hashmap import Hashmap
    kw = dict(device=device, integrity=integrity, n_shards=n_shards,
              commit_mode=commit_mode, pack_flush_rows=pack_flush_rows)
    if kind == "dll":
        a = open_arena(None, DoublyLinkedList.layout(n, mode,
                                                     snapshot=snapshot),
                       **kw)
        return a, DoublyLinkedList(a, n, mode, snapshot=snapshot)
    if kind == "hashmap":
        a = open_arena(None, Hashmap.layout(n, mode, snapshot=snapshot),
                       **kw)
        return a, Hashmap(a, n, mode, snapshot=snapshot)
    a = open_arena(None, BPTree.layout(n, 2 * n, mode), **kw)
    return a, BPTree(a, n, 2 * n, mode)


def _inputs(kind: str, n: int, seed: int):
    """Keys (a permutation), 7-word values and the sorted row indices to
    delete (1/8; the DLL deletes 1/16 and pops 1/16), from numpy seeded by
    ``seed``, so every device sees the same inputs."""
    import numpy as np
    rng = np.random.default_rng(seed)
    keys = rng.permutation(n).astype(np.int64)
    vals = rng.integers(0, 1 << 40, (n, 7)).astype(np.int64)
    gone = np.sort(rng.choice(n, n // 8 if kind != "dll" else n // 16,
                              replace=False))
    return rng, keys, vals, gone


def _fill(kind: str, a, s, keys, vals, commit_each: bool = False) -> None:
    """Insert (DLL: append) every row in batches of 8192."""
    for i in range(0, len(vals), BATCH):
        if kind == "dll":
            s.append_batch(vals[i:i + BATCH])
        else:
            s.insert_batch(keys[i:i + BATCH], vals[i:i + BATCH])
        if commit_each:
            a.commit()               # with snapshots on, seals a record


def _thin(kind: str, s, keys, gone) -> int:
    """Delete the rows ``gone`` and, for the DLL, pop as many again from
    the front; returns the number popped."""
    for i in range(0, gone.size, BATCH):
        if kind == "dll":
            s.delete_batch(gone[i:i + BATCH])       # dll ids = 0..n-1
        elif kind == "hashmap":
            s.remove_batch(keys[gone[i:i + BATCH]])
        else:
            s.delete_batch(keys[gone[i:i + BATCH]])
    pops = gone.size if kind == "dll" else 0
    for i in range(0, pops, BATCH):
        s.pop_front_batch(min(BATCH, pops - i))
    return pops


def _check(kind: str, label: str, s, want_order=None, live_keys=None,
           live_vals=None, gone_keys=None) -> None:
    """The recovered state: the DLL's order, or every live key found with
    its value and no deleted key found."""
    import numpy as np
    if kind == "dll":
        got = s.to_list().cpu().numpy()
        if s.count != want_order.size or not np.array_equal(got, want_order):
            raise AssertionError(f"{label}: recovered order differs")
        return
    if kind == "bptree":
        s.check_invariants()
    ok, got = s.find_batch(live_keys)
    if not bool(ok.all()) or not np.array_equal(got.cpu().numpy(),
                                                live_vals):
        raise AssertionError(f"{label}: live keys not recovered")
    ok, _ = s.find_batch(gone_keys)
    if bool(ok.any()):
        raise AssertionError(f"{label}: deleted keys recovered")


def workload(kind: str, mode: str, n: int, device, seed: int = 0,
             integrity: bool = False, n_shards: int = 1,
             concurrency: int = 0, commit_mode: str = "barrier",
             commit_after_fill: bool = False, on_arena=None,
             pack_flush_rows: int = 0) -> dict:
    """Insert n entries in batches of 8192, delete (and, for the DLL, pop)
    1/8 of them, commit, crash, reopen, reconstruct, then check the
    recovered state against what the workload expects.  ``concurrency``
    > 0 recovers through ``RecoveryManager`` at that concurrency, every
    region declared (on a sharded arena: per-region load stages); its
    report is returned under ``recovery``.  ``gathers`` counts the write
    set's grouped gathers, ``commits`` the commits (one more after the
    inserts with ``commit_after_fill``).  ``on_arena(arena)`` runs once
    the arena is built.  ``pack_flush_rows`` is the arena's (the
    reference's threshold, which changes nothing here)."""
    import numpy as np
    import torch
    from repro_torch.core.recovery import RecoveryManager
    from repro_torch.core.writeset import WriteSet

    _, keys, vals, gone = _inputs(kind, n, seed)
    a, s = build_structure(kind, mode, n, device, integrity=integrity,
                           n_shards=n_shards, commit_mode=commit_mode,
                           pack_flush_rows=pack_flush_rows)
    if on_arena is not None:
        on_arena(a)
    gathers0 = WriteSet.gathers
    sync = torch.cuda.synchronize if a.device.type == "cuda" else (
        lambda: None)
    t0 = time.perf_counter()
    _fill(kind, a, s, keys, vals)
    if commit_after_fill:
        a.commit()
    sync()
    t_insert = time.perf_counter() - t0
    t0 = time.perf_counter()
    pops = _thin(kind, s, keys, gone)
    sync()
    t_delete = time.perf_counter() - t0
    a.commit()
    lines = a.stats.lines
    gathers = WriteSet.gathers - gathers0
    a.crash()
    report = None
    t0 = time.perf_counter()
    if concurrency:
        report = RecoveryManager(a).add(
            kind, f"pstruct.{kind}", s, regions=tuple(a.regions)).recover(
                concurrency=concurrency)
    else:
        a.reopen()
        s.reconstruct()
    sync()
    t_recover = time.perf_counter() - t0
    live = np.ones(n, bool)
    live[gone] = False
    _check(kind, f"{kind} {mode}", s, np.flatnonzero(live)[pops:],
           keys[live], vals[live], keys[gone])
    return {"kind": kind, "mode": mode, "n": n, "arena": a, "structure": s,
            "lines": lines, "insert_s": t_insert, "delete_s": t_delete,
            "recover_s": t_recover, "stats": dataclasses.asdict(a.stats),
            "gathers": gathers, "commits": 1 + commit_after_fill,
            "recovery": report}


def snapshot_workload(kind: str, mode: str, n: int, device,
                      seed: int = 0) -> dict:
    """Phase 5: insert n entries in batches of 8192 with a commit after
    each, delete (DLL: and pop) as phase 3 does, commit, append or insert
    a suffix of 120, commit; then crash and recover through
    RecoveryManager three times — clean, the newest record torn, the whole
    snapshot ring corrupted — checking ``chain``/``replayed`` and the
    recovered state after each."""
    import numpy as np
    import torch
    from repro_torch.core.recovery import chain_method
    from repro_torch.snapshot_recovery import (SUFFIX, corrupt_ring,
                                               recover, tear_newest)

    rng, keys, vals, gone = _inputs(kind, n, seed)
    sfx_keys = np.arange(n, n + SUFFIX, dtype=np.int64)
    sfx_vals = rng.integers(0, 1 << 40, (SUFFIX, 7)).astype(np.int64)
    a, s = build_structure(kind, mode, n + SUFFIX, device, snapshot=True)
    sync = torch.cuda.synchronize if a.device.type == "cuda" else (
        lambda: None)
    t0 = time.perf_counter()
    _fill(kind, a, s, keys, vals, commit_each=True)
    sync()
    t_insert = time.perf_counter() - t0
    pops = _thin(kind, s, keys, gone)
    a.commit()
    sfx = s.append_batch(sfx_vals) if kind == "dll" else \
        s.insert_batch(sfx_keys, sfx_vals)
    a.commit()
    sync()
    live = np.ones(n, bool)
    live[gone] = False
    want = (np.concatenate([np.flatnonzero(live)[pops:], sfx.cpu().numpy()])
            if kind == "dll" else None)
    live_keys = np.concatenate([keys[live], sfx_keys])
    live_vals = np.concatenate([vals[live], sfx_vals])
    size = want.size if kind == "dll" else live_keys.size
    # a corrupted ring falls back to the full rank (DLL) or the rebuild
    expect = {"clean": ("snapshot", 0), "torn": ("snapshot", SUFFIX),
              "corrupt": (chain_method(n + SUFFIX, size) if kind == "dll"
                          else "rebuild", size)}
    scenarios, details = [], []
    for name, damage in (("clean", None), ("torn", tear_newest),
                         ("corrupt", corrupt_ring)):
        if damage is not None:
            damage(s)
        report = recover(a, kind, s, f"pstruct.{kind}")
        det = report.stage(kind).detail
        if (det["chain"], det["replayed"]) != expect[name]:
            raise AssertionError(f"{kind} {mode} {name}: chain="
                                 f"{det['chain']} replayed={det['replayed']}"
                                 f", expected {expect[name]}")
        _check(kind, f"{kind} {mode} {name}", s, want, live_keys, live_vals,
               keys[gone])
        scenarios.append({"scenario": name, "chain": det["chain"],
                          "replayed": det["replayed"],
                          "reopen_s": report.seconds("reopen"),
                          "stage_s": report.seconds(kind),
                          "wall_s": report.total_seconds})
        d = report.as_dict()
        details.append({**{k: v for k, v in d.items() if k not in TIMING},
                        "stages": [{k: v for k, v in st.items()
                                    if k not in TIMING}
                                   for st in d["stages"]]})
    return {"kind": kind, "mode": mode, "n": n, "arena": a,
            "insert_s": t_insert, "lines": a.stats.lines,
            "snapshot_lines": a.stats.snapshot_lines,
            "stats": dataclasses.asdict(a.stats), "scenarios": scenarios,
            "details": details}


def count_syncs(fn) -> int:
    """Device synchronizations ``fn`` causes, as torch's sync debug mode
    reports them."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def syncs_per_op(device, kinds=KINDS, snapshot: bool = False) -> dict:
    """Device syncs of one operation of each kind, on structures holding
    64k entries, order snapshots on or off."""
    import numpy as np
    n = 1 << 16
    rng = np.random.default_rng(1)
    out = {}
    for kind in kinds:
        a, s = build_structure(kind, "partly", n, device, snapshot=snapshot)
        keys = rng.permutation(n).astype(np.int64)
        vals = rng.integers(0, 1 << 40, (n, 7)).astype(np.int64)
        for i in range(0, n - BATCH, BATCH):
            if kind == "dll":
                s.append_batch(vals[i:i + BATCH])
            else:
                s.insert_batch(keys[i:i + BATCH], vals[i:i + BATCH])
        tail = slice(n - BATCH, n)
        if kind == "dll":
            out["dll.append_batch"] = count_syncs(
                lambda: s.append_batch(vals[tail]))
            out["dll.delete_batch"] = count_syncs(
                lambda: s.delete_batch(np.arange(0, 4096, 2)))
            out["dll.pop_front_batch"] = count_syncs(
                lambda: s.pop_front_batch(BATCH))
        else:
            out[f"{kind}.insert_batch"] = count_syncs(
                lambda: s.insert_batch(keys[tail], vals[tail]))
            out[f"{kind}.find_batch"] = count_syncs(
                lambda: s.find_batch(keys[:BATCH]))
            rm = s.remove_batch if kind == "hashmap" else s.delete_batch
            out[f"{kind}.{rm.__name__}"] = count_syncs(
                lambda: rm(keys[:BATCH]))
        a.commit()
        a.crash()
        a.reopen()
        out[f"{kind}.reconstruct"] = count_syncs(s.reconstruct)
    return out


# --------------------------------------------------------------- checkpoint

def ckpt_config(small: bool = False):
    """llama3.2-3b at its published widths, cut to CKPT_LAYERS layers; with
    ``small``, the card-vs-CPU config (d_model 256, 2 layers, the reduced
    config's heads, d_ff 1024, vocab 8192)."""
    from repro_torch.configs import base, registry
    cfg = registry.get(CKPT_ARCH)
    if small:
        return dataclasses.replace(base.reduced(cfg), d_model=256,
                                   n_layers=2, d_ff=1024, vocab=8192)
    return dataclasses.replace(cfg, n_layers=CKPT_LAYERS)


def quant_rows_shape():
    """The (rows, width) that ``quantize_leaf`` gives the largest leaf of
    phase 6 (the embedding table)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.backbone import param_specs
    embed = param_specs(ckpt_config())["embed"]
    return tuple(ops._as_rows(torch.empty(embed.shape,
                                          device="meta")).shape)


def ckpt_state(cfg, device, seed: int = 0):
    """A TrainState of ``cfg`` on ``device`` from a seeded generator:
    params by ``init_params``' rule, mu ~ N(0, 1e-3), nu ~ |N(0, 1e-6)|,
    step CKPT_STEP, data_seed CKPT_SEED and rng their ``rebuild_rng``.
    The same generator seed gives the same state again."""
    import torch
    from repro_torch.core.policy import tree_map
    from repro_torch.core.reconstruct import rebuild_rng
    from repro_torch.models.backbone import init_params
    from repro_torch.train.state import new_state
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = init_params(cfg, g, device)

    def draw(std):
        return lambda p: torch.randn(p.shape, generator=g,
                                     device=device).mul_(std)
    mu = tree_map(draw(1e-3), params)
    nu = tree_map(lambda t: t.abs_(), tree_map(draw(1e-6), params))
    st = new_state(params, mu, nu, seed=CKPT_SEED, device=device)
    return st._replace(
        step=torch.tensor(CKPT_STEP, dtype=torch.int32, device=device),
        rng=rebuild_rng(CKPT_SEED, CKPT_STEP).to(device))


def ckpt_files(state, policy, directory: Path) -> dict:
    """Save ``state`` under ``policy`` into a fresh ``directory``; the
    sha256 of every file written."""
    from repro_torch.ckpt.manager import CheckpointManager
    shutil.rmtree(directory, ignore_errors=True)
    CheckpointManager(str(directory), policy).save(state)
    return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(directory.iterdir())}


def save_breakdown(state) -> dict:
    """Where a PARTLY_Q8 save's time goes, measured apart on the same
    state: the quantize kernels (with ``_as_rows``' padding copy), the
    device-to-host copies, md5 of the host bytes (the manifest digests)
    and zlib's crc32 over them (what ``np.savez``'s zip adds)."""
    import zlib
    import torch
    from repro_torch.core import policy as pol
    from repro_torch.kernels import ops
    sd = state.as_dict()
    leaves = dict(pol.tree_flatten_with_path(sd))
    tensors, quant_s = [], 0.0
    for p in pol.plan(sd, pol.PARTLY_Q8):
        if not p.persisted:
            continue
        leaf = leaves[tuple(p.path.split("/"))]
        if p.quantized:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q, s = ops.quantize_leaf(leaf)
            torch.cuda.synchronize()
            quant_s += time.perf_counter() - t0
            tensors += [q, s]
        else:
            tensors.append(leaf)
    t0 = time.perf_counter()
    host = [t.to("cpu", copy=True).numpy() for t in tensors]
    d2h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a in host:
        hashlib.md5(a).hexdigest()
    md5_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a in host:
        zlib.crc32(a)
    crc_s = time.perf_counter() - t0
    return {"bytes": sum(a.nbytes for a in host), "quantize_s": quant_s,
            "d2h_s": d2h_s, "md5_s": md5_s, "crc32_s": crc_s}


def checkpoint_phase(dev) -> dict:
    """Phase 6: save, save unchanged, crash, restore (inline and
    background) a llama3.2-3b-width state under PARTLY_Q8; check what
    comes back.  Returns the phase's numbers and its launch counts."""
    import numpy as np
    import torch
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core import policy as pol
    from repro_torch.core.reconstruct import rebuild_rng
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.quant_pack import dequantize_blockwise_plain

    cfg = ckpt_config()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    st = ckpt_state(cfg, dev)
    spec = pol.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), st)
    flat = pol.tree_flatten_with_path(st.as_dict())
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": sum(t.numel() for p, t in flat if p[0] == "params"),
           "state_bytes": sum(t.numel() * t.element_size()
                              for _, t in flat)}
    torch.cuda.synchronize()
    out["breakdown"] = save_breakdown(st)
    del flat
    # ---- the main path: save, save again, crash, restore twice
    reset_launch_counts()
    mgr = CheckpointManager(str(CKPT_DIR), pol.PARTLY_Q8, incremental=True)
    r1 = mgr.save(st)
    r2 = mgr.save(st)
    del mgr, st                              # crash: the card's state is gone
    torch.cuda.empty_cache()
    mgr = CheckpointManager(str(CKPT_DIR), pol.PARTLY_Q8, incremental=True)
    t0 = time.perf_counter()
    got = mgr.restore(spec, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    inline = mgr.last_recovery
    t0 = time.perf_counter()
    bg = mgr.finish_warmup(mgr.restore(spec, device=dev,
                                       warmup="background"))
    torch.cuda.synchronize()
    restore_bg_s = time.perf_counter() - t0
    launches = launch_counts()
    # ---- checks
    for r in (r1, r2):
        out.setdefault("saves", []).append(dataclasses.asdict(r))
    if r2.bytes_written or r2.n_leaves_written or \
            r2.bytes_skipped_unchanged != r1.bytes_written:
        raise AssertionError(f"second incremental save wrote {r2}")
    manifest = json.loads((CKPT_DIR / "manifest.json").read_text())
    orig = ckpt_state(cfg, dev)              # the same seed: the same state
    gl = dict(pol.tree_flatten_with_path(got.as_dict()))
    bl = dict(pol.tree_flatten_with_path(bg.as_dict()))
    ol = dict(pol.tree_flatten_with_path(orig.as_dict()))
    worst = 0.0
    for path, t in gl.items():
        name = pol.path_str(path)
        if name == "rng":
            continue
        if not torch.equal(t, bl[path]):
            raise AssertionError(f"{name}: background restore differs")
        ent = manifest["leaves"][name]
        if not ent["quantized"]:
            if hashlib.md5(t.cpu().numpy()).hexdigest() != ent["digest"] \
                    or not torch.equal(t, ol[path]):
                raise AssertionError(f"{name}: not restored bit-exact")
            continue
        with np.load(CKPT_DIR / ent["file"]) as z:
            q = torch.from_numpy(z["q"]).to(dev)
            s = torch.from_numpy(z["s"]).to(dev)
        plain = dequantize_blockwise_plain(q, s).reshape(-1)[:t.numel()]
        if not torch.equal(t, plain.reshape(t.shape)):
            raise AssertionError(f"{name}: differs from the plain "
                                 f"dequantization of its file")
        err = float((t - ol[path]).abs().max())
        amax = float(ol[path].abs().max())
        if err > amax / 127:
            raise AssertionError(f"{name}: error {err} above amax/127 "
                                 f"({amax / 127})")
        worst = max(worst, err / amax if amax else 0.0)
        del q, s, plain
    want_rng = rebuild_rng(CKPT_SEED, CKPT_STEP)
    if not (torch.equal(got.rng.cpu(), want_rng)
            and torch.equal(bg.rng.cpu(), want_rng)):
        raise AssertionError("rng not rebuilt as fold_in(seed, step)")
    if (int(got.step), int(got.data_seed)) != (CKPT_STEP, CKPT_SEED):
        raise AssertionError("step or data_seed not restored")
    out.update({
        "restore_s": restore_s, "restore_background_s": restore_bg_s,
        "stages": {st.name: st.seconds for st in inline.stages},
        "stages_background": {st.name: st.seconds
                              for st in mgr.last_recovery.stages},
        "moment_err_over_amax": worst, "launches": launches,
        "files_bytes": sum(f.stat().st_size for f in CKPT_DIR.iterdir())})
    del got, bg, orig, gl, bl, ol
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out


# ------------------------------------------------------------------- timing

def time_ms(fn, reps: int = 20, flush=None) -> float:
    """Median CUDA-event time of ``fn`` in ms, after warm-up; ``flush``
    runs between reps, outside the timed region."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(got, want) -> float:
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def require_equal(name: str, pairs) -> float:
    import torch
    err = 0.0
    for got, want in pairs:
        e = max_abs_err(got, want)
        if e != 0.0 or not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {e})")
        err = max(err, e)
    return err


def kernel_parity(dev, probe_inp: dict, n: int = 1 << 22) -> dict:
    """Phase 2: every kernel against its plain version at main-path shapes
    (``n``-row sources and chains; the probe at phase 8's table and
    queries, ``probe_inp``); returns the rows of the kernels line (all keys
    but ``launches``) and the pack_rows timings per row width."""
    import torch
    from repro_torch.core import recovery as TR
    from repro_torch.kernels import chain_order as K
    from repro_torch.kernels import pack_flush as P
    from repro_torch.kernels import quant_pack as Q

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    l2 = torch.ones(1 << 25, dtype=torch.int32, device=dev)   # 128 MB

    def flush():
        # evict the 50 MB L2 by READING a larger buffer: a write would
        # leave dirty lines whose write-back the next launch would pay
        l2.sum()

    rows = {}
    # ---- pack_rows: M = 8192 rows out of a 2**22-row source
    n_src, m = n, BATCH
    pack = {}
    for rowbytes in (64, 128, 256):
        src = torch.randint(-(1 << 62), 1 << 62, (n_src, rowbytes // 8),
                            dtype=torch.int64, device=dev, generator=g)
        idx = torch.randint(0, n_src, (m,), dtype=torch.int32, device=dev,
                            generator=g)
        idx_pad = idx.clone()
        idx_pad[::97] = -1
        err = require_equal("pack_rows", [
            (P.pack_rows(src, idx_pad), P.pack_rows_plain(src, idx_pad))])
        lidx = idx.long()
        pack[rowbytes] = {
            "ms": time_ms(lambda: P.pack_rows(src, idx_pad), flush=flush),
            "plain_ms": time_ms(lambda: P.pack_rows_plain(src, idx_pad),
                                flush=flush),
            "library_ms": time_ms(lambda: torch.index_select(src, 0, lidx),
                                  flush=flush),
            "bound_ms": bound_ms(2 * m * rowbytes + 4 * m),
            "max_abs_err": err}
        del src
    rows["pack_rows"] = dict(pack[64], shape=f"M={m} rows of 64 B from "
                             f"{n_src}; 128 B and 256 B in the report",
                             source="src/repro_torch/csrc/pack_flush.cu",
                             replaces="src/repro/kernels/pack_flush.py:66")
    # ---- jump_double: n nodes with NULL, out-of-range values, a cycle
    perm = torch.randperm(n, device=dev, generator=g)
    nxt = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nxt[perm[:-1]] = perm[1:]
    nxt[perm[n // 3]] = -1
    nxt[perm[n // 2]] = n + 11
    nxt[perm[-2]] = perm[-5]                     # cycle
    jump = K.sanitize32(nxt)
    jump[perm[n // 4]] = (1 << 31) - 1           # out of range at int32
    cnt = torch.randint(1, 9, (n,), dtype=torch.int64, device=dev,
                        generator=g)
    err = require_equal("jump_double", zip(K.jump_double(jump, cnt),
                                           K.jump_double_plain(jump, cnt)))
    rows["jump_double"] = {
        "ms": time_ms(lambda: K.jump_double(jump, cnt), flush=flush),
        "plain_ms": time_ms(lambda: K.jump_double_plain(jump, cnt),
                            flush=flush),
        "library_ms": None, "bound_ms": bound_ms(24 * n),
        "sector_bound_ms": bound_ms(n * (2 * SECTOR + 24)),
        "max_abs_err": err, "shape": f"n={n}, int32 jump, int64 cnt",
        "source": "src/repro_torch/csrc/chain_order.cu",
        "replaces": "src/repro/kernels/chain_order.py:133"}
    # ---- contraction of a 2**22-node random-permutation chain: the walk
    # and the expand in their new and old forms, the whole contraction on
    # the host clock, the checkpoint stride, and once at 2**24 nodes
    nxt = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nxt[perm[:-1]] = perm[1:]
    contraction = {"random": contraction_case(dev, nxt, int(perm[0]), n, perm,
                                              flush),
                   "strides": stride_sweep(dev, nxt, int(perm[0]), perm,
                                           flush),
                   "edges": contraction_edges(dev)}
    src = {"library_ms": None, "source": "src/repro_torch/csrc/chain_order.cu"}
    case = contraction["random"]
    rows["walk_segments"] = dict(
        case["walk"], **src, replaces="src/repro/kernels/chain_order.py:282",
        shape=f"{case['lanes']} lanes, one launch of the whole budget, "
              f"{case['walk']['hops']} hops, checkpoints (a random 2**22 "
              f"chain, k = 32); the first round of 64 hops and the DLL "
              f"chain in the report")
    rows["expand_segments"] = dict(
        case["expand"], **src, replaces="src/repro/kernels/chain_order.py:357",
        shape=f"{case['expand']['runs']} runs of at most "
              f"{case['expand']['longest_run']} ids (the split plan), "
              f"count={n}; the unsplit plan in the report")
    del nxt
    torch.cuda.empty_cache()
    g24 = torch.Generator(device=dev)
    g24.manual_seed(24)
    big = 1 << 24
    perm24 = torch.randperm(big, device=dev, generator=g24)
    nxt = torch.full((big,), -1, dtype=torch.int64, device=dev)
    nxt[perm24[:-1]] = perm24[1:]
    contraction["random_2**24"] = contraction_case(
        dev, nxt, int(perm24[0]), big, perm24, flush, light=True)
    del nxt, perm24
    torch.cuda.empty_cache()
    # ---- gather_next: the DLL snapshot verify (L = the recovered count of
    # phase 5, int64 ids) and a chain_walk round (L = 2**23 bucket heads)
    nxt_g = torch.randint(-1, n, (n,), dtype=torch.int32, device=dev,
                          generator=g)
    nxt_g[::101] = n + 9                     # stored out of range: passed
    gather = {}
    for lanes in (n - n // 8, 2 * n):
        ids = torch.randint(0, n, (lanes,), dtype=torch.int64, device=dev,
                            generator=g)
        if lanes != 2 * n:
            ids[::97] = -1
            ids[1::89] = -5
            ids[2::83] = 2 ** 32 + 3
            ids[3::79] = n
        valid = (ids >= 0) & (ids < n)
        n_valid = int(valid.sum())
        distinct = int(torch.unique(ids[valid]).numel())
        err = require_equal("gather_next", [
            (K.gather_next(nxt_g, ids), K.gather_next_plain(nxt_g, ids))])
        lib_ids = torch.randint(0, n, (lanes,), dtype=torch.int64,
                                device=dev, generator=g)
        gather[lanes] = {
            "ms": time_ms(lambda: K.gather_next(nxt_g, ids), flush=flush),
            "plain_ms": time_ms(lambda: K.gather_next_plain(nxt_g, ids),
                                flush=flush),
            "library_ms": time_ms(
                lambda: torch.index_select(nxt_g, 0, lib_ids), flush=flush),
            "bound_ms": bound_ms(12 * lanes + 4 * distinct),
            "sector_bound_ms": bound_ms(12 * lanes + SECTOR * n_valid),
            "max_abs_err": err, "valid_ids": n_valid,
            "distinct_ids": distinct}
    first = min(gather)
    rows["gather_next"] = dict(
        gather[first], shape=f"L={first} int64 ids (NULL, negatives, "
        f"2**32+3) over n={n}; L={2 * n} in the report",
        source="src/repro_torch/csrc/chain_order.cu",
        replaces="src/repro/kernels/chain_order.py:189")
    # ---- quantize/dequantize_blockwise: the rows of phase 6's largest
    # leaf, an embed-shaped moment, with per-row magnitudes from 1e-8 to
    # 1e2 and zero groups
    qrows = quant_rows_shape()
    el = qrows[0] * qrows[1]
    mag = torch.pow(10.0, torch.rand((qrows[0], 1), generator=g,
                                     device=dev) * 10 - 8)
    x = torch.randn(qrows, generator=g, device=dev).mul_(mag)
    x[::97, :256] = 0
    x[1::89, 256:512] = 0
    del mag
    q, s = Q.quantize_blockwise(x)
    err = require_equal("quantize_blockwise",
                        zip((q, s), Q.quantize_blockwise_plain(x)))
    shape = f"({qrows[0]}, {qrows[1]}) f32, the embed moment of phase 6"
    qbytes = 5 * el + 4 * (el // 256)     # f32 in, int8 + scales out
    rows["quantize_blockwise"] = {
        "ms": time_ms(lambda: Q.quantize_blockwise(x), flush=flush),
        "plain_ms": time_ms(lambda: Q.quantize_blockwise_plain(x), reps=5),
        "library_ms": None, "bound_ms": bound_ms(qbytes),
        "max_abs_err": err, "shape": shape,
        "source": "src/repro_torch/csrc/quant_pack.cu",
        "replaces": "src/repro/kernels/quant_pack.py:44"}
    del x
    err = require_equal("dequantize_blockwise", [
        (Q.dequantize_blockwise(q, s), Q.dequantize_blockwise_plain(q, s))])
    # one library call for the same function: int8 times the broadcast f32
    # scales, promoted to f32 (the result stays grouped, a view away)
    qg, sg = q.view(q.shape[0], -1, 256), s[..., None]
    rows["dequantize_blockwise"] = {
        "ms": time_ms(lambda: Q.dequantize_blockwise(q, s), flush=flush),
        "plain_ms": time_ms(lambda: Q.dequantize_blockwise_plain(q, s),
                            reps=5),
        "library_ms": time_ms(lambda: torch.mul(qg, sg), flush=flush),
        "bound_ms": bound_ms(qbytes),
        "max_abs_err": err, "shape": shape,
        "source": "src/repro_torch/csrc/quant_pack.cu",
        "replaces": "src/repro/kernels/quant_pack.py:74"}
    # the bf16 output: the f32 product rounded to nearest even in
    # the store, bitwise against the plain version; one library call that
    # computes it: torch.mul into a bf16 out= tensor
    xb = Q.dequantize_blockwise(q, s, torch.bfloat16)
    want = Q.dequantize_blockwise_plain(q, s, torch.bfloat16)
    if not torch.equal(xb.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("dequantize_blockwise(dtype=bf16) differs from "
                             "its plain version")
    outb = torch.empty(qg.shape, dtype=torch.bfloat16, device=dev)
    rows["dequantize_blockwise"]["bf16"] = {
        "ms": time_ms(lambda: Q.dequantize_blockwise(q, s, torch.bfloat16),
                      flush=flush),
        "plain_ms": time_ms(lambda: Q.dequantize_blockwise_plain(
            q, s, torch.bfloat16), reps=5),
        "library_ms": time_ms(lambda: torch.mul(qg, sg, out=outb),
                              flush=flush),
        "bound_ms": bound_ms(3 * el + 4 * (el // 256)),
        "max_abs_err": 0.0, "bitwise": True,
        "shape": f"({qrows[0]}, {qrows[1]}) int8 + scales -> bf16"}
    del q, s, qg, sg, xb, want, outb
    quant_non_finite = quantize_non_finite(dev, g)
    # ---- scatter_rows: one re-prefill group (2 slots) seated into the
    # phase-7 cache leaf viewed as rows: (28 * 8, 2048 * 8 * 128) f32
    cfg = serve_config()
    row = SERVE_S_MAX * cfg.n_kv_heads * cfg.resolved_head_dim
    n_rows = cfg.n_layers * 8
    dst = torch.randn((n_rows, row), generator=g, device=dev)
    packed = torch.randn((cfg.n_layers * 2, row), generator=g, device=dev)
    idx = (torch.arange(cfg.n_layers, device=dev)[:, None] * 8
           + torch.tensor([2, 5], device=dev)[None]).reshape(-1).to(
        torch.int32)
    err = require_equal("scatter_rows", [
        (P.scatter_rows(dst, packed, idx),
         P.scatter_rows_plain(dst.clone(), packed, idx))])
    lidx = idx.long()
    m_bytes = packed.numel() * 4
    rows["scatter_rows"] = {
        "ms": time_ms(lambda: P.scatter_rows_(dst, packed, idx),
                      flush=flush),
        "plain_ms": time_ms(lambda: P.scatter_rows_plain(dst, packed, idx),
                            flush=flush),
        "library_ms": time_ms(lambda: dst.index_copy_(0, lidx, packed),
                              flush=flush),
        "bound_ms": bound_ms(2 * m_bytes + 4 * idx.numel()),
        "max_abs_err": err,
        "shape": f"{idx.numel()} rows of {row * 4} B into ({n_rows}, "
                 f"{row}) f32, one phase-7 group",
        "source": "src/repro_torch/csrc/pack_flush.cu",
        "replaces": "src/repro/kernels/pack_flush.py:116"}
    del dst, packed
    # ---- flash_attention: a phase-7 layer's shape class (24 heads over 8
    # KV heads, D = 128) at 4 sequences of 1024, causal; then the shapes
    # phase 7 gives it: re-prefill groups of two slots at 1040 tokens and
    # of one slot at 1552 (ragged; 1552 is the longest S of the run), two
    # slots at 1552, and an admission of 1536; each in f32 (phase 7's
    # dtype) and bf16 (the model's default)
    flash = {}
    for name, h, hk, seq in (("", 96, 32, 1024), ("_p7_1040", 48, 16, 1040),
                             ("_p7_2x1552", 48, 16, 1552),
                             ("_p7_1552", 24, 8, 1552),
                             ("_p7_1536", 24, 8, 1536)):
        for dt in (torch.float32, torch.bfloat16):
            flash[str(dt).split(".")[-1] + name] = flash_case(
                dev, g, dt, h, hk, seq, 128, flush)
    flash["float32_ragged"] = flash_case(dev, g, torch.float32, 96, 32, 1000,
                                         128, flush)
    # gemma's layers: gemma3-27b's local layer (32 query heads
    # over 16, D = 128, window 1024) and gemma2-9b's (16 over 8, D = 256,
    # window 4096, softcap 50) at the prefill lengths phase 15 gives them
    for name, (h, hk, seq, d, window, cap) in GEMMA_FLASH.items():
        for dt in (torch.float32, torch.bfloat16):
            flash[f"{str(dt).split('.')[-1]}_{name}"] = flash_band_case(
                dev, g, dt, h, hk, seq, d, window, cap, flush)
    flash_edges = flash_band_edges(dev, g)
    flash_widths = flash_width_parity(dev, g)
    flash_prefill = flash_prefill_bf16(dev)
    flash_bwd_widths = flash_bwd_parity(dev, g)
    flash_grad = flash_grad_on_card(dev, g)
    flash_bwd = flash_bwd_timing(dev, g, flush)
    # gemma's training layers (phase 16): gemma3-27b's local layer and
    # gemma2-9b's local and global ones, window, softcap and D = 256
    flash_bwd_edges = flash_bwd_band_edges(dev, g)
    for name, (h, hk, seq, d, window, cap) in GEMMA_BWD.items():
        for dt in (torch.float32, torch.bfloat16):
            flash_bwd[f"{str(dt).split('.')[-1]}_{name}"] = \
                flash_bwd_band_case(dev, g, dt, h, hk, seq, d, window, cap,
                                    flush)
    # phase 18's cross and encoder layers, non-causal, forward and
    # backward: vision's cross layer (64 query heads over 8, 4096 tokens
    # over 1600 patches), whisper's encoder (20 over 20, 1500 x 1500
    # frames) and its decoder's cross layer (448 tokens over 1500 frames)
    for name, (h, hk, sq, skv, d) in CROSS_FLASH.items():
        for dt in (torch.float32, torch.bfloat16):
            key = f"{str(dt).split('.')[-1]}_{name}"
            flash[key], flash_bwd[key] = flash_cross_case(
                dev, g, dt, h, hk, sq, skv, d, flush)
    # phase 19's hybrid layers: hymba's local and full attention halves
    # (25 query heads over 5, D = 64, 4096 tokens), forward and backward
    for name, (h, hk, seq, d, window) in HYMBA_FLASH.items():
        for dt in (torch.float32, torch.bfloat16):
            key = f"{str(dt).split('.')[-1]}_{name}"
            flash[key] = flash_band_case(dev, g, dt, h, hk, seq, d, window,
                                         0.0, flush)
            flash_bwd[key] = flash_bwd_band_case(dev, g, dt, h, hk, seq, d,
                                                 window, 0.0, flush)
    rows["flash_attention_bwd"] = dict(
        flash_bwd["float32"], bound_by="operations",
        shape="q, o, dO (96, 1024, 128), k, v (32, 1024, 128) f32, causal "
              "(phase 10's layer); bf16 in the report; gemma3 and gemma2 "
              "(window, softcap, D = 256), the cross and encoder "
              "layers (non-causal) and hymba's (G = 5, D = 64) below",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none: no Pallas kernel; the reference takes this "
                 "gradient by XLA autodiff of "
                 "src/repro/models/layers.py:200",
        **{f"{dt}_{name}": flash_bwd[f"{dt}_{name}"]
           for name in list(GEMMA_BWD) + list(CROSS_FLASH)
           + list(HYMBA_FLASH) for dt in ("float32", "bfloat16")})
    rows["flash_attention"] = dict(
        flash["float32"], bound_by="operations",
        shape="q (96, 1024, 128) over k, v (32, 1024, 128) f32, causal; "
              "bf16, the phase-7 shapes and S = 1000 in the report; "
              "gemma3 and gemma2 (window, softcap, D = 256), the cross "
              "and encoder layers (non-causal) and hymba's (G = 5, D = 64) "
              "below",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:91",
        **{f"{dt}_{name}": flash[f"{dt}_{name}"]
           for name in list(GEMMA_FLASH) + list(CROSS_FLASH)
           + list(HYMBA_FLASH) for dt in ("float32", "bfloat16")})
    # ---- probe: phase 8's 512 MiB table at uniform, Zipf, one-bucket,
    # out-of-range and small inputs, both kernels, beside the bounds
    probe = probe_parity(dev, probe_inp, flush)
    rows["probe"] = probe.pop("row")
    return {"rows": rows, "pack_rowbytes": pack, "gather_next": gather,
            "flash_attention": flash, "flash_widths": flash_widths,
            "flash_edges": flash_edges,
            "flash_prefill_bf16": flash_prefill,
            "flash_bwd": flash_bwd, "flash_bwd_widths": flash_bwd_widths,
            "flash_bwd_edges": flash_bwd_edges,
            "flash_grad_on_card": flash_grad,
            "quantize_non_finite": quant_non_finite,
            "contraction": contraction, "probe": probe}


# ------------------------------------------------------------- drains

def l2_flusher(dev):
    """A function that evicts the 50 MB L2 by READING 128 MB: a write
    would leave dirty lines whose write-back the next launch would pay."""
    import torch
    l2 = torch.ones(1 << 25, dtype=torch.int32, device=dev)

    def flush():
        l2.sum()
    return flush


def pinned_d2h(dev) -> dict:
    """Phase 1: the pinned device-to-host rate, copies of LINK_BYTES into
    pinned host memory (CUDA events, after one warm-up copy); the link
    bound of every drain below."""
    import torch
    src = torch.ones(LINK_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if not bool((dst[:: 1 << 20] == 1).all()):
        raise AssertionError("pinned copy: wrong bytes on the host")
    ms = statistics.median(times)
    del src, dst
    return {"bytes": LINK_BYTES, "ms": ms, "all_ms": times,
            "bytes_per_s": LINK_BYTES / ms * 1e3}


def capture_drain(kind: str, dev):
    """One epoch drain of a real structure: ``kind`` at SNAP_N, partly,
    order snapshots on, filled with DRAIN_FILL batches of 8192 (a commit
    after each, as phase 5), then the next batch's drain, captured as the
    write set hands it to its gather.  Returns (write set, plan)."""
    _, keys, vals, _ = _inputs(kind, SNAP_N, 0)
    a, s = build_structure(kind, "partly", SNAP_N, dev, snapshot=True)
    _fill(kind, a, s, keys[:DRAIN_FILL * BATCH], vals[:DRAIN_FILL * BATCH],
          commit_each=True)
    ws, plans = a.writeset, []
    real = ws.gather

    def record(plan):
        plans.append([(r, rows.copy()) for r, rows in plan])
        return real(plan)
    ws.gather = record
    lo = DRAIN_FILL * BATCH
    _fill(kind, a, s, keys[lo:lo + BATCH], vals[lo:lo + BATCH])
    ws.gather = real
    if len(plans) != 1:
        raise AssertionError(f"{kind}: one epoch made {len(plans)} gathers")
    return ws, plans[0]


def time_host_ms(fns: dict, flush, reps: int = 30) -> dict:
    """{name: (host clock, CUDA events)} medians in ms of each of ``fns``,
    each of which ends in a synchronize; the L2 evicted and the card idle
    before each call.  Every rep calls all of them, in an order rotated
    by one each rep, so no path always runs first or after another."""
    import torch
    names = list(fns)
    for name in names:
        for _ in range(3):
            fns[name]()
    host = {name: [] for name in names}
    dev_ms = {name: [] for name in names}
    for r in range(reps):
        for name in names[r % len(names):] + names[:r % len(names)]:
            flush()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fns[name]()
            host[name].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            dev_ms[name].append(start.elapsed_time(end))
    return {name: (statistics.median(host[name]),
                   statistics.median(dev_ms[name])) for name in names}


def drain_case(dev, ws, plan, link: float, flush) -> dict:
    """The device half of one captured drain: the grouped kernel against
    its plain version (exact) and the write set's gather against the
    per-region gather drains used before (exact); then the kernel alone,
    and three whole device halves (indices up, gather, rows to the host,
    synchronize): the write set's grouped gather (the kernel writing
    pinned host memory), ``gather_rows`` per region (the drains' earlier
    path), and ``index_select`` per region with one ``torch.cat`` and one
    pinned download; and, to split the write set's cost, the kernel into
    a device buffer plus one pinned download and the kernel writing
    pinned memory (the same host code around each: the A/B of the write
    set's choice), the wrapper's call alone (indices already on the card),
    the write set's form (``pack_rows_grouped_host``: indices read from
    pinned memory, exact against the plain version) with its synchronize,
    and a bare synchronize."""
    import numpy as np
    import torch
    from repro_torch.core.writeset import gather_rows
    from repro_torch.kernels import pack_flush as P
    srcs = [r.vol.reshape(r.shape[0], -1) for r, _ in plan]
    counts = [int(rows.size) for _, rows in plan]
    flat = np.concatenate([rows for _, rows in plan]).astype(np.int32)
    idx = torch.from_numpy(flat).to(dev)
    err = require_equal("pack_rows_grouped", [
        (P.pack_rows_grouped(srcs, idx, counts),
         P.pack_rows_grouped_plain(srcs, idx, counts))])
    for (r, rows), got in zip(plan, ws.gather(plan)):
        if not np.array_equal(got, gather_rows(r, rows)):
            raise AssertionError(f"{r.name}: the grouped gather differs "
                                 f"from the per-region gather")
    staged = P.group_layout(srcs, counts)[1]
    moved = sum(m * (2 * r.rowbytes + 4) for (r, _), m in zip(plan, counts))
    hidx = torch.empty(flat.size, dtype=torch.int32, pin_memory=True)
    hout = torch.empty(staged, dtype=torch.uint8, pin_memory=True)

    def index_select_cat():
        hidx.numpy()[:] = np.concatenate([rows for _, rows in plan])
        d = hidx.to(dev, non_blocking=True)
        parts, pos = [], 0
        for src, m in zip(srcs, counts):
            parts.append(torch.index_select(src, 0, d[pos:pos + m])
                         .reshape(-1).view(torch.uint8))
            pos += m
        cat = torch.cat(parts)
        hout[:cat.numel()].copy_(cat, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()

    out = {"regions": [(r.name, r.rowbytes, m) for (r, _), m in
                       zip(plan, counts)],
           "rows": int(flat.size), "staged_bytes": staged,
           "moved_bytes": moved, "max_abs_err": err,
           "kernel_ms": time_ms(lambda: P.pack_rows_grouped(srcs, idx,
                                                            counts),
                                flush=flush),
           "kernel_to_host_ms": time_ms(lambda: P.pack_rows_grouped(
               srcs, idx, counts, out=hout), flush=flush),
           "plain_ms": time_ms(lambda: P.pack_rows_grouped_plain(
               srcs, idx, counts), flush=flush),
           "bound_hbm_ms": bound_ms(moved),
           "bound_link_ms": staged / link * 1e3}
    out["bound_ms"] = max(out["bound_hbm_ms"], out["bound_link_ms"])
    def staged_copy():
        # the A/B variant: the kernel into a device staging buffer, then
        # one pinned download (the write set's gather writes host memory
        # directly)
        hidx.numpy()[:] = np.concatenate([rows for _, rows in plan])
        d = hidx.to(dev, non_blocking=True)
        buf = P.pack_rows_grouped(srcs, d, counts)
        hout.copy_(buf, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        return hout
    def zero_copy():
        # the same host code, the kernel writing pinned memory directly
        hidx.numpy()[:] = np.concatenate([rows for _, rows in plan])
        d = hidx.to(dev, non_blocking=True)
        P.pack_rows_grouped(srcs, d, counts, out=hout)
        torch.cuda.current_stream(dev).synchronize()
        return hout

    def wrapper_only():
        P.pack_rows_grouped(srcs, idx, counts)
        torch.cuda.current_stream(dev).synchronize()

    want = P.pack_rows_grouped_plain(srcs, idx, counts).cpu()
    require_equal("pack_rows_grouped staged", [(staged_copy(), want)])
    require_equal("pack_rows_grouped zero-copy", [(zero_copy(), want)])
    hbuf = torch.empty(4 * flat.size, dtype=torch.uint8, pin_memory=True)
    hbuf.numpy().view(np.int32)[:] = flat

    def host_index():
        # the write set's form: indices read from pinned memory, rows
        # written to pinned memory, no upload
        stream = torch.cuda.current_stream(dev)
        P.pack_rows_grouped_host(srcs, counts, hbuf, hout, stream)
        stream.synchronize()
        return hout

    require_equal("pack_rows_grouped_host", [(host_index(), want)])
    paths = time_host_ms({
        "grouped": lambda: ws.gather(plan), "staged_copy": staged_copy,
        "zero_copy": zero_copy,
        "per_region": lambda: [gather_rows(r, rows)
                                    for r, rows in plan],
        "index_select_cat": index_select_cat, "wrapper_only": wrapper_only,
        "host_index": host_index,
        "sync_only": torch.cuda.current_stream(dev).synchronize}, flush)
    for name, (host, event) in paths.items():
        out[f"{name}_host_ms"], out[f"{name}_event_ms"] = host, event
    return out


def grouped_edge_cases(dev, g) -> dict:
    """The grouped kernel against its plain version, exact, on the cases
    the drains do not reach: -1 and out-of-range indices, empty regions,
    4 B rows, and more than MAX_GROUPS regions (two launches); each also
    through the drain's host-index form (``pack_rows_grouped_host``)."""
    import torch
    from repro_torch.kernels import pack_flush as P

    def region(rowbytes: int, m: int, bad: bool = False):
        dt = torch.int64 if rowbytes % 8 == 0 else torch.int32
        n = int(torch.randint(50, 3000, (1,), generator=g, device=dev))
        src = torch.randint(-(1 << 30), 1 << 30,
                            (n, rowbytes // (8 if dt == torch.int64 else 4)),
                            generator=g, device=dev).to(dt)
        idx = torch.randint(0, n, (m,), generator=g, device=dev,
                            dtype=torch.int32)
        if bad:
            idx[::5] = -1
            idx[1::7] = n
            idx[2::11] = 2 ** 31 - 1
            idx[3::13] = -(2 ** 31)
        return src, idx

    cases = {
        "bad_indices": [region(64, 300, True), region(8, 777, True),
                        region(4, 129, True), region(256, 65, True)],
        "empty_regions": [region(8, 0), region(64, 1000), region(4, 0),
                          region(128, 33), region(64, 0)],
        "rows_4_12_20_B": [region(4, 4097), region(12, 100), region(20, 31)],
        "more_than_64": [region((64, 8, 4, 128, 2048)[i % 5],
                                (3, 0, 170, 32, 1)[i % 5])
                         for i in range(P.MAX_GROUPS + 6)],
    }
    out = {}
    for name, regs in cases.items():
        srcs = [s for s, _ in regs]
        counts = [int(i.numel()) for _, i in regs]
        idx = torch.cat([i for _, i in regs])
        before = P.pack_rows.launches
        got = P.pack_rows_grouped(srcs, idx, counts)
        launches = P.pack_rows.launches - before
        plain = P.pack_rows_grouped_plain(srcs, idx, counts)
        require_equal(f"pack_rows_grouped {name}", [(got, plain)])
        want = -(-len(regs) // P.MAX_GROUPS)
        if launches != want:
            raise AssertionError(f"pack_rows_grouped {name}: {launches} "
                                 f"launches for {len(regs)} regions")
        # the drain's host-index form on the same inputs
        hidx = torch.empty(4 * max(1, idx.numel()), dtype=torch.uint8,
                           pin_memory=True)
        hidx[:4 * idx.numel()].view(torch.int32).copy_(idx.cpu())
        hout = torch.zeros(max(16, plain.numel()), dtype=torch.uint8,
                           pin_memory=True)
        stream = torch.cuda.current_stream(dev)
        P.pack_rows_grouped_host(srcs, counts, hidx, hout, stream)
        stream.synchronize()
        require_equal(f"pack_rows_grouped_host {name}", [
            (hout[:plain.numel()].clone(), plain.cpu())])
        out[name] = {"regions": len(regs), "rows": int(idx.numel()),
                     "launches": launches}
    return out


def drain_parity(dev, link: float) -> dict:
    """Phase 2's drain half: the grouped kernel at two captured drain
    shapes (the DLL's and the hashmap's, partly, snapshots on, 2**22) and
    at its edge cases, exact; each drain's device half timed."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    flush = l2_flusher(dev)
    out = {"edge_cases": grouped_edge_cases(dev, g)}
    for kind in SNAP_KINDS:
        ws, plan = capture_drain(kind, dev)
        out[kind] = drain_case(dev, ws, plan, link, flush)
        del ws, plan
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- chain steps

def faulty_jump(n: int, g, dev):
    """int32 pointers over n nodes: a random permutation chain with a NULL
    cut, values out of range at 64 and at 32 bits, and a cycle."""
    import torch
    from repro_torch.kernels import chain_order as K
    perm = torch.randperm(n, device=dev, generator=g)
    nxt = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nxt[perm[:-1]] = perm[1:]
    nxt[perm[n // 3]] = -1
    nxt[perm[n // 2]] = n + 11
    nxt[perm[-2]] = perm[-5]                     # cycle
    jump = K.sanitize32(nxt)
    jump[perm[n // 4]] = (1 << 31) - 1           # out of range at int32
    return jump


def bucket_chains(dev, g, n: int):
    """The hashmap's chain table at n entries: every slot hashed to one of
    2n buckets (load 0.5, as the port's Hashmap sizes it at 2**22), each
    bucket's chain in ascending slot order.  Returns (chain int64 (n,),
    the head of every bucket, the bucket of every slot), int64."""
    import torch
    buckets = 2 * n
    b = torch.randint(0, buckets, (n,), device=dev, generator=g)
    bs, slots = torch.sort(b, stable=True)
    chain = torch.full((n,), -1, dtype=torch.int64, device=dev)
    same = bs[1:] == bs[:-1]
    chain[slots[:-1][same]] = slots[1:][same]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = ~same
    heads = torch.full((buckets,), -1, dtype=torch.int64, device=dev)
    heads[bs[first]] = slots[first]
    return chain, heads, b


def raw_walk(nxt, ids, hops: int):
    """One launch of gather_next's walk kernel, as the wrapper makes it but
    without its synchronize: CUDA events then time the kernel alone."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import chain_order as K
    lib = _build.load("chain_order")
    out = torch.empty((hops, ids.shape[0]), dtype=torch.int32,
                      device=nxt.device)
    walk, host = K._walk_words(nxt.device)
    stream = torch.cuda.current_stream(nxt.device).cuda_stream

    def launch():
        rc = lib.gather_next_launch(nxt.data_ptr(), ids.data_ptr(),
                                    ids.element_size(), out.data_ptr(),
                                    nxt.shape[0], ids.shape[0], hops,
                                    walk.data_ptr(), host.data_ptr(), 0, 0,
                                    None, stream)
        if rc:
            raise RuntimeError(f"gather_next walk: CUDA error {rc}")
    return launch


def walk_bytes(nxt, ids, walk) -> dict:
    """Bytes of a walk: once for the call (ids read, each node it loads
    read once, the columns written) and once per hop (each hop's ids
    read, one load per live lane, its column written)."""
    import torch
    n, lanes = nxt.shape[0], ids.shape[0]
    cols = [ids] + list(walk[:-1])
    live = [((c >= 0) & (c < n)) for c in cols]
    loaded = torch.cat([c[v].long() for c, v in zip(cols, live)])
    distinct = int(torch.unique(loaded).numel())
    per_hop = sum(c.element_size() * lanes + 4 * int(v.sum()) + 4 * lanes
                  for c, v in zip(cols, live))
    return {"bound_ms": bound_ms(ids.element_size() * lanes + 4 * distinct
                                 + 4 * walk.numel()),
            "round_bound_ms": bound_ms(per_hop), "nodes_read": distinct,
            "loads": int(loaded.numel())}


def walk_per_column(nxt, heads):
    """chain_walk as the port ran it before the walks were hop-blocked
    (one one-hop gather_next launch and one blocking read per column): the
    yardstick of the delete batch's walk."""
    import torch
    from repro_torch.kernels import chain_order as K
    n = nxt.shape[0]
    cols = []
    cur = torch.where((heads >= 0) & (heads < n), heads, -1)
    nxt32 = K.sanitize32(nxt)
    while bool((cur != -1).any()):
        cols.append(cur)
        cur = K.gather_next(nxt32, cur).long()
        if len(cols) > n:
            raise RuntimeError("cycle in chain")
    return torch.stack(cols, dim=1)


def rounds_parity(dev, g, flush) -> dict:
    """jump_double's three forms on the main path (the tables of
    _contract_tables: bits - 1 rounds kept; chain_order's tables with
    counts: n.bit_length() rounds kept; _absorb: n.bit_length() rounds,
    the last level only) at ROUND_SIZES (2**16, the contracted 131,073,
    2**18 and 2**22 nodes), exact against the plain version; each timed
    as one launch and as one launch per round."""
    import torch
    from repro_torch.kernels import chain_order as K
    out = {}
    for n in ROUND_SIZES:
        jump = faulty_jump(n, g, dev)
        cnt = torch.randint(1, 9, (n,), dtype=torch.int64, device=dev,
                            generator=g)
        bits = max(1, (n - 1).bit_length())
        forms = {"tables": (None, bits - 1, True),
                 "tables_cnt": (cnt, n.bit_length(), True),
                 "absorb": (cnt, n.bit_length(), False)}
        for form, (c, r, keep) in forms.items():
            kw = dict(rounds=r, keep=keep)
            got = K.jump_double(jump, c, **kw)
            want = K.jump_double_plain(jump, c, **kw)
            pairs = [(got[0], want[0])]
            if c is not None:
                pairs.append((got[1], want[1]))
            err = require_equal(f"jump_double rounds={r} keep={keep}",
                                pairs)
            del got, want

            def per_round(c=c, r=r):
                j = jump
                cc = c
                for _ in range(r):
                    j, cc = K.jump_double(j, cc)
            cb = 8 if c is not None else 0
            out[f"{form}_{n}"] = {
                "n": n, "rounds": r, "keep": keep, "counts": c is not None,
                "ms": time_ms(lambda: K.jump_double(jump, c, **kw),
                              flush=flush),
                "per_round_launches_ms": time_ms(per_round, flush=flush),
                "plain_ms": time_ms(lambda: K.jump_double_plain(jump, c,
                                                                **kw),
                                    reps=5, flush=flush),
                "library_ms": None,
                "bound_ms": bound_ms((4 + cb) * n + (
                    4 * (r + 1) if keep else 4) * n + cb * n),
                "round_bound_ms": bound_ms(r * 2 * (4 + cb) * n),
                "max_abs_err": err}
        del jump, cnt
        torch.cuda.empty_cache()
    return out


def hops_parity(dev, g, flush, n: int, lanes: int = BATCH) -> dict:
    """gather_next(hops=) at a chain_walk's 8192 lanes over 2**22 pointers,
    exact against the plain version, walk and length: unsanitized pointers
    (NULL, stored values out of range) and int64 ids with NULL, negatives,
    n and 2**32 + 3, int32 ids, and the hashmap's bucket chains from the
    heads of a delete batch's buckets.  Timed at 8 hops (the first launch
    of every walk); then that batch's whole chain_walk against the
    per-column walk."""
    import torch
    from repro_torch.kernels import chain_order as K
    nxt = torch.randint(-1, n, (n,), dtype=torch.int32, device=dev,
                        generator=g)
    nxt[::101] = n + 9
    nxt[1::103] = -7
    ids = torch.randint(0, n, (lanes,), dtype=torch.int64, device=dev,
                        generator=g)
    ids[::97] = -1
    ids[1::89] = -5
    ids[2::83] = 2 ** 32 + 3
    ids[3::79] = n
    # a delete batch's walk: the buckets of 8192 random slots
    chain, heads, bucket = bucket_chains(dev, g, n)
    chain32 = K.sanitize32(chain)
    bids = heads[torch.unique(bucket[torch.randint(
        0, n, (lanes,), device=dev, generator=g)])].contiguous()
    cases = {"unsanitized_int64": (nxt, ids), "unsanitized_int32":
             (nxt, ids.to(torch.int32)), "buckets": (chain32, bids)}
    out, lengths = {}, {}
    for name, (table, lane_ids) in cases.items():
        for hops in (2, 8, 16):
            got, length = K.gather_next(table, lane_ids, hops=hops)
            want, want_len = K.gather_next_plain(table, lane_ids, hops=hops)
            err = require_equal(f"gather_next hops={hops} {name}",
                                [(got, want)])
            if length != want_len:
                raise AssertionError(f"gather_next hops={hops} {name}: "
                                     f"length {length} != {want_len}")
            lengths[f"{name}_{hops}"] = length
    for name, (table, lane_ids) in (("unsanitized_int64", cases[
            "unsanitized_int64"]), ("buckets", cases["buckets"])):
        hops = 8
        walk, _ = K.gather_next(table, lane_ids, hops=hops)

        def per_hop(table=table, lane_ids=lane_ids, hops=hops):
            cur = lane_ids
            for _ in range(hops):
                cur = K.gather_next(table, cur)
        host = time_host_ms({"call": lambda: K.gather_next(
            table, lane_ids, hops=hops)}, flush)["call"]
        out[name] = {
            "lanes": lane_ids.shape[0], "hops": hops,
            "ms": time_ms(raw_walk(table, lane_ids, hops), flush=flush),
            "call_host_ms": host[0],
            "per_hop_launches_ms": time_ms(per_hop, flush=flush),
            "plain_ms": time_ms(lambda: K.gather_next_plain(
                table, lane_ids, hops=hops), reps=5, flush=flush),
            "library_ms": None, "max_abs_err": err,
            **walk_bytes(table, lane_ids, walk)}
    out["lengths"] = lengths
    # the delete batch's walk: the hop-blocked chain_walk against the
    # per-column loop, on the host clock, in rotating order
    from repro_torch.core import recovery as TR
    want = walk_per_column(chain, bids)
    got = TR.chain_walk(chain, bids, method="double")
    if not torch.equal(got, want):
        raise AssertionError("chain_walk differs from the per-column walk")
    def synced(fn):
        def call():
            fn()
            torch.cuda.synchronize()
        return call
    # the walk's own pieces: the sanitize pass over the whole table, and
    # the first hop-blocked launch with its synchronize
    times = time_host_ms({
        "hop_blocked": synced(lambda: TR.chain_walk(chain, bids,
                                                    method="double")),
        "per_column": synced(lambda: walk_per_column(chain, bids)),
        "sanitize32": synced(lambda: K.sanitize32(chain)),
        "first_launch": synced(lambda: K.gather_next(chain32, bids,
                                                     hops=8))}, flush)
    out["walk"] = {"heads": bids.shape[0], "columns": got.shape[1],
                   **{f"{k}_host_ms": v[0] for k, v in times.items()},
                   **{f"{k}_events_ms": v[1] for k, v in times.items()}}
    del nxt, ids, chain, chain32, heads, bucket
    torch.cuda.empty_cache()
    return out


def chain_steps_parity(dev) -> dict:
    """Phase 2's checks of the two multi-step chain kernels; ``rows`` are
    their lines of the kernels summary at the main path's sizes (the
    contracted 131,073-node absorb, a walk's first 8-hop launch)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    flush = l2_flusher(dev)
    rounds = rounds_parity(dev, g, flush)
    hops = hops_parity(dev, g, flush, SNAP_N)
    src = {"source": "src/repro_torch/csrc/chain_order.cu"}
    rows = {
        "jump_double": dict(
            rounds[f"absorb_{CONTRACTED_N}"],
            shape=f"n={CONTRACTED_N} (a 2**22 chain contracted by 32), "
                  f"{CONTRACTED_N.bit_length()} rounds in one launch, int32 "
                  f"jump, int64 cnt (_absorb); every form and size in the "
                  f"report",
            replaces="src/repro/kernels/chain_order.py:133", **src),
        "gather_next": dict(
            hops["buckets"],
            shape=f"{hops['buckets']['lanes']} int64 bucket heads of a "
                  f"delete batch, 8 hops over the 2**22-slot chain table (a "
                  f"walk's first launch); unsanitized pointers and ids in "
                  f"the report",
            replaces="src/repro/kernels/chain_order.py:189", **src)}
    return {"rows": rows, "rounds": rounds, "hops": hops}


def contract_rounds(nxt32, spine, *, k, head, n_mult, promoted,
                    spine_pos=None):
    """contract_walk as the port ran it before it was one launch (PRs
    11-18): walk_segments rounds of budget0 = max(2k, 64) hops, the lanes
    that arrived or ended retired between rounds (a compaction and a host
    sync each), until every segment closed or n hops proved a spine-free
    cycle.  The yardstick of the one-launch walk; it records no
    checkpoints, so the plan after it is the unsplit one."""
    import torch
    from repro_torch.kernels import chain_order as K
    n = nxt32.shape[0]
    dev = nxt32.device
    S = spine.shape[0]
    cnext = torch.full((S,), -1, dtype=torch.int32, device=dev)
    w = torch.zeros(S, dtype=torch.int64, device=dev)
    lanes = torch.arange(S, device=dev)
    cur = spine.to(torch.int32)
    budget = max(2 * k, 64)
    hops = 0
    while lanes.numel() and hops <= n:
        c2, sp, wd = K.walk_segments(nxt32, cur.contiguous(), k=k, head=head,
                                     n_mult=n_mult, promoted=promoted,
                                     budget=budget, spine_pos=spine_pos)
        w[lanes] += wd.long()
        arrived = sp >= 0
        cnext[lanes[arrived]] = sp[arrived]
        alive = (c2 >= 0) & ~arrived
        lanes = lanes[alive]
        cur = c2[alive]
        hops += budget
    if lanes.numel():
        w[lanes] = n + 1
    return cnext, torch.clamp(w, min=1), None


@contextlib.contextmanager
def round_driver():
    """Recovery's contractions as before: the round driver, and so the
    unsplit expand plan (one run per segment)."""
    from repro_torch.kernels import chain_order as K
    real = K.contract_walk
    K.contract_walk = contract_rounds
    try:
        yield
    finally:
        K.contract_walk = real


def same_records(a, b) -> bool:
    """Two (3, r) checkpoint record sets (lane, hop, node) are equal, in
    whatever order each was appended."""
    import torch
    if a.shape != b.shape:
        return False
    order = [torch.argsort(r[0].long() * (1 << 32) + r[1].long())
             for r in (a, b)]
    return torch.equal(a[:, order[0]], b[:, order[1]])


def contraction_case(dev, nxt, head: int, count: int, want, flush,
                     light: bool = False) -> dict:
    """The contraction kernels on one chain (int64 NEXT ``nxt``, order
    ``want`` from ``head``): chain_order's order, with and without the
    round driver; the walk in its new form (one launch of the whole
    budget, checkpoints) and its old one (the first round of budget0
    hops, as PR 11 timed it), each exact against its plain version, the
    checkpoints as a set; the expand on the split plan (runs of at most
    MARK_STRIDE) and on the unsplit one, exact, equal to ``want``; each
    timed with CUDA events with the L2 evicted and, the new forms, with
    nxt resident; the old driver's rounds back to back; and (unless
    ``light``) the plain versions, contract_walk and _order_contract
    against the round driver on the host clock, L2 evicted and warm."""
    import torch
    from repro_torch.core import recovery as TR
    from repro_torch.kernels import chain_order as K
    n, k = nxt.shape[0], TR.CONTRACT_K
    for label, ctx in (("one launch", contextlib.nullcontext()),
                       ("round driver", round_driver())):
        with ctx:
            order = TR.chain_order(nxt, head, count, method="contract")
        if not torch.equal(order, want):
            raise AssertionError(f"contraction ({label}) order differs from "
                                 f"the chain")
    nxt32 = K.sanitize32(nxt)
    heads = torch.tensor([head], dtype=torch.int64, device=dev)
    spine, hpos, cnext, w, marks = TR._contract(nxt32, heads, k)
    budget, cap = marks.walk["budget"], marks.rec.shape[1]
    kw = {key: v for key, v in marks.walk.items()
          if key not in ("nxt", "budget")}
    starts = spine.to(torch.int32)
    b0 = max(2 * k, 64)
    lanes = starts.shape[0]

    def walk():
        return K.walk_segments(nxt32, starts, budget=budget, marks=cap, **kw)

    def plain():
        return K.walk_segments_plain(nxt32, starts, budget=budget,
                                     marks=cap, **kw)
    got, ref = walk(), plain()
    err = require_equal("walk_segments", zip(got[:3], ref[:3]))
    total = int(got[3][1][0])
    if total != int(ref[3][1][0]) or total > cap or not same_records(
            got[3][0][:, :total], ref[3][0][:, :total]):
        raise AssertionError(f"walk_segments: checkpoints differ from the "
                             f"plain version ({total} of {cap})")
    first = K.walk_segments(nxt32, starts, budget=b0, **kw)
    require_equal("walk_segments budget0", zip(
        first, K.walk_segments_plain(nxt32, starts, budget=b0, **kw)))
    hops = int(got[2].long().sum())
    first_hops = int(first[2].long().sum())
    # the old driver's rounds: the lanes still walking after each round
    rounds, cur = [], starts
    while cur.numel():
        rounds.append(cur)
        c2, sp, _ = K.walk_segments(nxt32, cur, budget=b0, **kw)
        cur = c2[(c2 >= 0) & (sp < 0)].contiguous()
    cjump = TR._contract_tables(cnext, min(count, spine.shape[0]))
    hp = int(hpos[0])
    plans = {"split": TR._expand_plan(spine, cjump, w, hp, count, marks),
             "whole": TR._expand_plan(spine, cjump, w, hp, count)}
    longest = int(plans["split"][2].max())
    if longest > K.MARK_STRIDE:
        raise AssertionError(f"expand plan: a run of {longest} ids")
    e_err = 0.0
    for name, plan in plans.items():
        got_e = K.expand_segments(nxt32, *plan, count)
        e_err = max(e_err, require_equal(f"expand_segments {name}", [
            (got_e, K.expand_segments_plain(nxt32, *plan, count)),
            (got_e, want)]))
        del got_e

    def resident():
        flush()
        nxt32.sum()                   # nxt32 read once: in the L2

    def expand_bytes(plan, per_hop):
        runs = int((plan[2] > 0).sum())
        ehops = int(torch.clamp(plan[2].long() - 1, min=0).sum())
        return bound_ms(per_hop * ehops + 12 * plan[0].shape[0]
                        + 8 * count), runs, ehops
    ws = {"ms": time_ms(walk, flush=flush),
          "resident_ms": time_ms(walk, flush=resident),
          "no_checkpoints_ms": time_ms(lambda: K.walk_segments(
              nxt32, starts, budget=budget, **kw), flush=flush),
          "first_round_ms": time_ms(lambda: K.walk_segments(
              nxt32, starts, budget=b0, **kw), flush=flush),
          "rounds": len(rounds),
          "rounds_back_to_back_ms": time_ms(lambda: [K.walk_segments(
              nxt32, c, budget=b0, **kw) for c in rounds], flush=flush),
          "bound_ms": bound_ms(4 * hops + 16 * lanes + 12 * total),
          "sector_bound_ms": bound_ms(SECTOR * hops + 16 * lanes
                                      + 12 * total),
          "first_round_bound_ms": bound_ms(4 * first_hops + 16 * lanes),
          "max_abs_err": err, "hops": hops, "first_round_hops": first_hops,
          "longest_segment": int(got[2].max()), "checkpoints": total,
          "capacity": cap}
    split, whole = plans["split"], plans["whole"]
    b_split, runs, ehops = expand_bytes(split, 4)
    b_whole, runs_whole, _ = expand_bytes(whole, 4)
    es = {"ms": time_ms(lambda: K.expand_segments(nxt32, *split, count),
                        flush=flush),
          "resident_ms": time_ms(lambda: K.expand_segments(
              nxt32, *split, count), flush=resident),
          "unsplit_ms": time_ms(lambda: K.expand_segments(
              nxt32, *whole, count), flush=flush),
          "bound_ms": b_split, "sector_bound_ms": expand_bytes(split,
                                                               SECTOR)[0],
          "unsplit_bound_ms": b_whole, "max_abs_err": e_err,
          "runs": runs, "lanes": split[0].shape[0], "hops": ehops,
          "longest_run": longest, "unsplit_runs": runs_whole,
          "unsplit_longest_run": int(whole[2].max())}
    out = {"n": n, "count": count, "lanes": lanes, "walk": ws, "expand": es}
    if not light:
        ws["plain_ms"] = time_ms(plain, reps=3)
        es["plain_ms"] = time_ms(lambda: K.expand_segments_plain(
            nxt32, *split, count), reps=3)

        def synced(fn):
            def call():
                fn()
                torch.cuda.synchronize()
            return call

        def order_rounds():
            with round_driver():
                TR._order_contract(nxt, head, count, k)
        fns = {"contract_walk": synced(lambda: K.contract_walk(
                   nxt32, spine, **kw)),
               "contract_rounds": synced(lambda: contract_rounds(
                   nxt32, spine, **kw)),
               "order_contract": synced(lambda: TR._order_contract(
                   nxt, head, count, k)),
               "order_contract_rounds": synced(order_rounds)}
        for state, fl in (("evicted", flush), ("warm", lambda: None)):
            times = time_host_ms(fns, fl, reps=15)
            out[f"host_{state}"] = {
                **{f"{key}_host_ms": v[0] for key, v in times.items()},
                **{f"{key}_events_ms": v[1] for key, v in times.items()}}
        out["stages"] = contraction_stages(dev, nxt, head, count, flush)
    del nxt32, got, ref, first, plans, rounds
    torch.cuda.empty_cache()
    return out


def contraction_edges(dev) -> dict:
    """The contraction's other paths, on the card against the same driver
    on the CPU (the plain versions), exact, or the same exception: several
    heads (spine membership through ``spine_pos``: ``chain_lengths`` and
    ``chain_walk``), a k that is not a power of two, torn 2**32 + 3
    pointers, and the plan's second walk: segments merged by torn
    pointers (the checkpoints overflow), a spine-free cycle (POISON) and
    a cycle through spine nodes under explicit counts (a segment used
    twice).  Returns {case: outcome}."""
    import numpy as np
    import torch
    from repro_torch.core import recovery as TR
    rng = np.random.default_rng(19)

    def chain(n, live=None):
        perm = rng.permutation(n)[:live or n]
        nxt = np.full(n, -1, np.int64)
        nxt[perm[:-1]] = perm[1:]
        return nxt, perm

    cases = {}
    nxt, perm = chain(50000)
    heads = [int(seg[0]) for seg in np.split(perm, [7, 8000, 8001, 31000])]
    hs = np.asarray(heads + [-1, 10 ** 6], np.int64)
    cases["several_heads_lengths"] = (nxt, lambda t: TR.chain_lengths(
        t, hs, method="contract"))
    cases["several_heads_walk"] = (nxt, lambda t: TR.chain_walk(
        t, hs, method="contract"))
    for count in (None, 33333):
        cases[f"k7_{count}"] = (nxt, lambda t, c=count: TR.chain_order(
            t, int(perm[0]), c, method="contract", k=7))
    torn = nxt.copy()
    torn[perm[20000]] = 2 ** 32 + 3
    cases["torn"] = (torn, lambda t: TR.chain_order(t, int(perm[0]),
                                                    method="contract"))
    merged, _ = chain(4096)
    path = np.array([i for i in range(1, 4096) if i % 32][:300])
    merged[np.arange(0, 4096, 32)] = path[0]
    merged[path[:-1]] = path[1:]
    merged[path[-1]] = -1
    free = np.full(4096, -1, np.int64)
    free[0], free[1], free[2], free[3] = 1, 2, 3, 1
    cyc, cperm = chain(4000, 1000)
    cyc[cperm[-1]] = cperm[400]
    for count in (None, 5, 37, 301, 1300):
        cases[f"merged_{count}"] = (merged, lambda t, c=count: TR.chain_order(
            t, 0, c, method="contract"))
        cases[f"spine_free_{count}"] = (free, lambda t, c=count:
                                        TR.chain_order(t, 0, c,
                                                       method="contract"))
        cases[f"cycle_{count}"] = (cyc, lambda t, c=count: TR.chain_order(
            t, int(cperm[0]), c, method="contract"))
    out = {}
    for name, (nx, fn) in cases.items():
        got = []
        for d in (dev, torch.device("cpu")):
            try:
                got.append(fn(torch.from_numpy(nx).to(d)).cpu())
            except (RuntimeError, ValueError) as e:
                got.append(type(e).__name__)
        if isinstance(got[0], str) or isinstance(got[1], str):
            same = got[0] == got[1]
        else:
            same = torch.equal(got[0], got[1])
        if not same:
            raise AssertionError(f"contraction {name}: card and CPU differ")
        out[name] = got[0] if isinstance(got[0], str) else \
            f"equal, {tuple(got[0].shape)}"
    return out


def contraction_stages(dev, nxt, head: int, count: int, flush,
                       reps: int = 10) -> dict:
    """_order_contract's stages on the host clock, each ended by a
    synchronize (so their sum exceeds the call, whose host work overlaps
    the card's): sanitize32, _contract (the walk launch included), the
    contracted tables, the position walk alone, the plan (the position
    walk again) and the expand; medians in ms, L2 evicted before each
    call."""
    import torch
    from repro_torch.core import recovery as TR
    from repro_torch.kernels import chain_order as K
    n, k = nxt.shape[0], TR.CONTRACT_K
    hp = head // k if head % k == 0 else (n + k - 1) // k
    names = ("sanitize32", "contract", "tables", "positions", "plan",
             "expand")
    times = {name: [] for name in names}
    for rep in range(reps + 2):
        flush()
        torch.cuda.synchronize()
        t = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        nxt32 = K.sanitize32(nxt)
        mark()
        spine, _, cnext, w, marks = TR._contract(
            nxt32, torch.tensor([head], device=dev), k)
        mark()
        cjump = TR._contract_tables(cnext, min(count, spine.shape[0]))
        mark()
        K.walk_positions(cjump, hp, min(count, spine.shape[0]))
        mark()
        plan = TR._expand_plan(spine, cjump, w, hp, count, marks)
        mark()
        K.expand_segments(nxt32, *plan, count)
        mark()
        if rep >= 2:
            for i, name in enumerate(names):
                times[name].append((t[i + 1] - t[i]) * 1e3)
    return {f"{name}_host_ms": statistics.median(v)
            for name, v in times.items()}


def stride_sweep(dev, nxt, head: int, want, flush) -> dict:
    """The checkpoint stride (MARK_STRIDE) at 8, 16 and 32 on one chain:
    the order exact, no run longer than the stride, the walk and the
    split expand with CUDA events (L2 evicted), _order_contract on the
    host clock; the module's constant is restored after."""
    import torch
    from repro_torch.core import recovery as TR
    from repro_torch.kernels import chain_order as K
    n, k = nxt.shape[0], TR.CONTRACT_K
    real = K.MARK_STRIDE
    out = {}
    try:
        for stride in (8, 16, 32):
            K.MARK_STRIDE = stride
            if not torch.equal(TR._order_contract(nxt, head, n, k), want):
                raise AssertionError(f"stride {stride}: order differs")
            nxt32 = K.sanitize32(nxt)
            spine, hpos, cnext, w, marks = TR._contract(
                nxt32, torch.tensor([head], device=dev), k)
            kw = {key: v for key, v in marks.walk.items() if key != "nxt"}
            cjump = TR._contract_tables(cnext, min(n, spine.shape[0]))
            plan = TR._expand_plan(spine, cjump, w, int(hpos[0]), n, marks)
            if int(plan[2].max()) > stride:
                raise AssertionError(f"stride {stride}: a run too long")
            starts = spine.to(torch.int32)
            cap = marks.rec.shape[1]

            def order():
                TR._order_contract(nxt, head, n, k)
                torch.cuda.synchronize()
            out[stride] = {
                "walk_ms": time_ms(lambda: K.walk_segments(
                    nxt32, starts, marks=cap, **kw), flush=flush),
                "expand_ms": time_ms(lambda: K.expand_segments(
                    nxt32, *plan, n), flush=flush),
                "order_contract_host_ms": time_host_ms(
                    {"o": order}, flush, reps=10)["o"][0],
                "checkpoints": int(marks.total[0]),
                "runs": int((plan[2] > 0).sum())}
            del nxt32, plan, marks, cjump
    finally:
        K.MARK_STRIDE = real
    torch.cuda.empty_cache()
    return out


def contraction_ranking(dev, contractions: list, flush) -> dict:
    """walk_segments and expand_segments priced at the chain sizes phases
    3 and 5 contracted (each size's random permutation chain, k = 32):
    one walk launch and the split plan's expand per contraction, beside
    the round driver's launches (PRs 11-18: one per round of 64 hops) and
    the unsplit plan's expand (one lane per segment, PR 11's launch);
    gap = contractions x (ms - bound)."""
    import torch
    sizes = {}
    for c in contractions:
        sizes[c["n"]] = sizes.get(c["n"], 0) + 1
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    rows = []
    for n, calls in sorted(sizes.items()):
        perm = torch.randperm(n, device=dev, generator=g)
        nxt = torch.full((n,), -1, dtype=torch.int64, device=dev)
        nxt[perm[:-1]] = perm[1:]
        case = contraction_case(dev, nxt, int(perm[0]), n, perm, flush,
                                light=True)
        ws, es = case["walk"], case["expand"]
        rows.append({"n": n, "contractions": calls, "lanes": case["lanes"],
                     "walk_ms": ws["ms"], "walk_bound_ms": ws["bound_ms"],
                     "rounds": ws["rounds"],
                     "rounds_ms": ws["rounds_back_to_back_ms"],
                     "expand_ms": es["ms"], "expand_bound_ms": es["bound_ms"],
                     "expand_unsplit_ms": es["unsplit_ms"]})
        del nxt, perm
        torch.cuda.empty_cache()
    return {
        "walk_segments": {
            "launches": sum(r["contractions"] for r in rows),
            "gap_ms": sum(r["contractions"] * (r["walk_ms"]
                                               - r["walk_bound_ms"])
                          for r in rows),
            "per_step_launches": sum(r["contractions"] * r["rounds"]
                                     for r in rows),
            "per_step_gap_ms": sum(r["contractions"] * (r["rounds_ms"]
                                                        - r["walk_bound_ms"])
                                   for r in rows),
            "by_size": rows},
        "expand_segments": {
            "launches": sum(r["contractions"] for r in rows),
            "gap_ms": sum(r["contractions"] * (r["expand_ms"]
                                               - r["expand_bound_ms"])
                          for r in rows),
            "unsplit_gap_ms": sum(r["contractions"] * (
                r["expand_unsplit_ms"] - r["expand_bound_ms"])
                for r in rows)}}


class ChainCalls:
    """Calls of the chain primitives at their call sites during a phase:
    ``tables``/``absorbs`` count the ``chain_tables``/``_absorb`` calls
    that launch (one ``jump_double`` launch each), ``walks`` holds one
    record per hashmap ``chain_walk``: lanes, columns, its ``gather_next``
    launches, whether it escalated or raised; ``contractions`` one record
    per ``contract_walk`` that launches (chain size n, lanes), ``runs``
    the longest run of every split expand plan (device scalars, read at
    the check), ``chain`` the first ``_order_contract``'s chain (a copy of
    NEXT, head, count)."""

    def __init__(self):
        self.tables = 0
        self.absorbs = 0
        self.walks = []
        self.contractions = []
        self.runs = []
        self.chain = None


@contextlib.contextmanager
def chain_call_sites():
    from repro_torch.core import recovery as TR
    from repro_torch.kernels import chain_order as K
    from repro_torch.pstruct import hashmap as HM
    rec = ChainCalls()
    real = (K.chain_tables, TR._absorb, HM.chain_walk, TR._walk_contract,
            K.contract_walk, TR._expand_plan, TR._order_contract)
    escalations = []

    def tables(jump0, bits, cnt=None):
        if jump0.shape[0] and bits - 1 + (cnt is not None) >= 1:
            rec.tables += 1
        return real[0](jump0, bits, cnt)

    def absorb(jump, cnt, heads):
        if jump.shape[0]:
            rec.absorbs += 1
        return real[1](jump, cnt, heads)

    def walk_contract(*a, **kw):
        escalations.append(1)
        return real[3](*a, **kw)

    def walk(nxt, heads, **kw):
        before, esc = K.gather_next.launches, len(escalations)
        row = {"lanes": int(heads.numel())}
        rec.walks.append(row)
        try:
            out = real[2](nxt, heads, **kw)
        except RuntimeError:
            row["raised"] = True
            raise
        finally:
            row["launches"] = K.gather_next.launches - before
            row["escalated"] = len(escalations) > esc
        row["columns"] = int(out.shape[1])
        return out

    def contract(nxt32, spine, **kw):
        if spine.numel():
            rec.contractions.append({"n": int(nxt32.shape[0]),
                                     "lanes": int(spine.numel())})
        return real[4](nxt32, spine, **kw)

    def plan(spine, cjump, w, hpos, count, marks=None):
        out = real[5](spine, cjump, w, hpos, count, marks)
        if marks is not None:
            rec.runs.append(out[2].max())
        return out

    def order_contract(nxt, head, count, k):
        if rec.chain is None:
            rec.chain = (nxt.clone(), head, count)
        return real[6](nxt, head, count, k)

    (K.chain_tables, TR._absorb, HM.chain_walk, TR._walk_contract,
     K.contract_walk, TR._expand_plan, TR._order_contract) = (
        tables, absorb, walk, walk_contract, contract, plan, order_contract)
    try:
        yield rec
    finally:
        (K.chain_tables, TR._absorb, HM.chain_walk, TR._walk_contract,
         K.contract_walk, TR._expand_plan, TR._order_contract) = real


def walk_launch_cap(columns: int) -> int:
    """1 + ceil(log2(columns / 8)) launches, at least 1: the most a
    level-synchronous walk of that many columns may take."""
    return 1 + (max(1, -(-columns // 8)) - 1).bit_length()


def chain_calls_check(phase: str, rec: ChainCalls, launches: dict) -> dict:
    """jump_double launched once per chain_tables/_absorb call that
    launches; every level-synchronous chain_walk within its launch cap;
    walk_segments once per contract_walk call; expand_segments once per
    split plan, none of whose runs is longer than MARK_STRIDE."""
    from repro_torch.kernels import chain_order as K
    if launches["jump_double"] != rec.tables + rec.absorbs:
        raise AssertionError(
            f"{phase}: {launches['jump_double']} jump_double launches for "
            f"{rec.tables} chain_tables and {rec.absorbs} _absorb calls")
    level = [w for w in rec.walks
             if not w["escalated"] and not w.get("raised")]
    over = [w for w in level if w["launches"] > walk_launch_cap(
        w["columns"])]
    if over:
        raise AssertionError(f"{phase}: chain_walk over its launch cap: "
                             f"{over[:3]}")
    if launches["walk_segments"] != len(rec.contractions):
        raise AssertionError(
            f"{phase}: {launches['walk_segments']} walk_segments launches "
            f"for {len(rec.contractions)} contract_walk calls")
    longest = max((int(r) for r in rec.runs), default=0)
    if launches["expand_segments"] != len(rec.runs) or \
            longest > K.MARK_STRIDE:
        raise AssertionError(
            f"{phase}: {launches['expand_segments']} expand_segments "
            f"launches for {len(rec.runs)} split plans, longest run "
            f"{longest} (stride {K.MARK_STRIDE})")
    return {"phase": f"{phase}_chain_calls", "chain_tables_calls":
            rec.tables, "absorb_calls": rec.absorbs,
            "jump_double_launches": launches["jump_double"],
            "walks": len(level),
            "walk_gather_launches": sum(w["launches"] for w in level),
            "walk_columns": sum(w["columns"] for w in level),
            "longest_walk": max((w["columns"] for w in level), default=0),
            "escalated": sum(w["escalated"] for w in rec.walks),
            "raised": sum(bool(w.get("raised")) for w in rec.walks),
            "contract_walk_calls": len(rec.contractions),
            "walk_segments_launches": launches["walk_segments"],
            "split_plans": len(rec.runs),
            "expand_segments_launches": launches["expand_segments"],
            "longest_expand_run": longest,
            "contracted_sizes": sorted({c["n"] for c in rec.contractions})}


def per_column_launches(walks) -> dict:
    """{lanes rounded up to a power of two: gather_next launches the
    per-column chain_walk made for these walks} (one per column; 128
    before an escalation)."""
    out = {}
    for w in walks:
        if w.get("raised"):
            continue
        key = 1 << max(0, w["lanes"] - 1).bit_length()
        cols = 128 if w["escalated"] else w["columns"]
        out[key] = out.get(key, 0) + cols
    return out


def size_ranking(dev, launches: dict, sizes: dict, steps: dict,
                 walks: list) -> dict:
    """Each of pack_rows (64 B rows of a 2**22-row source), jump_double
    and gather_next timed at every power of two its histogram of phases 3
    and 5 holds (the bucket's upper end) and, for the two chain kernels,
    at every hop or round count launched there; beside its bound there;
    gap = launches x (ms - bound), summed per kernel.  jump_double runs the
    absorb form (counts, the last level kept) over a random chain;
    gather_next walks from bucket heads over the hashmap's 2**22-slot
    chain table, one hop from random ids over random pointers.  The
    chain kernels' ``per_step_gap_ms`` prices the same work at one launch
    per round or per column, as the kernels ran before they looped: each
    round of a call, each column of the level-synchronous walks counted
    at their call sites (``walks``)."""
    import torch
    from repro_torch.kernels import chain_order as K
    from repro_torch.kernels import pack_flush as P
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    flush = l2_flusher(dev)
    n = SNAP_N
    src = torch.randint(0, 1 << 40, (n, 8), generator=g, device=dev)
    nxt = torch.randint(-1, n, (n,), dtype=torch.int32, generator=g,
                        device=dev)
    chain, heads, _ = bucket_chains(dev, g, n)
    chain32 = K.sanitize32(chain)
    heads = heads[heads >= 0]

    def pack(size, _):
        idx = torch.randint(0, n, (size,), dtype=torch.int32, generator=g,
                            device=dev)
        return (lambda: P.pack_rows(src, idx)), bound_ms(size * (2 * 64 + 4))

    def jump(size, rounds):
        perm = torch.randperm(size, device=dev, generator=g)
        j = torch.full((size,), -1, dtype=torch.int32, device=dev)
        j[perm[:-1]] = perm[1:].to(torch.int32)
        cnt = torch.ones(size, dtype=torch.int64, device=dev)
        return (lambda: K.jump_double(j, cnt, rounds=rounds)), \
            bound_ms(24 * size)

    def gather(size, hops):
        if hops == 1:
            ids = torch.randint(0, n, (size,), dtype=torch.int64,
                                generator=g, device=dev)
            distinct = int(torch.unique(ids).numel())
            return (lambda: K.gather_next(nxt, ids)), \
                bound_ms(12 * size + 4 * distinct)
        ids = heads[torch.randint(0, heads.shape[0], (size,), generator=g,
                                  device=dev)].contiguous()
        walk, _ = K.gather_next(chain32, ids, hops=hops)
        return raw_walk(chain32, ids, hops), walk_bytes(
            chain32, ids, walk)["bound_ms"]

    # the launches of the same work at one per round, one per column
    per_step = {"jump_double": {}, "gather_next": {}}
    for size, by in steps["jump_double"].items():
        per_step["jump_double"][size] = sum(r * c for r, c in by.items())
    for size, by in steps["gather_next"].items():
        if 1 in by:
            per_step["gather_next"][size] = by[1]
    for size, cols in per_column_launches(walks).items():
        per_step["gather_next"][size] = (
            per_step["gather_next"].get(size, 0) + cols)
    out = {}
    for name, make in (("pack_rows", pack), ("jump_double", jump),
                       ("gather_next", gather)):
        if name == "pack_rows":
            points = {(size, 1): c for size, c in sizes[name].items()}
        else:
            points = {(size, k): c for size, by in steps[name].items()
                      for k, c in by.items()}
            for size in per_step[name]:
                points.setdefault((size, 1), 0)
        if name == "jump_double":               # the contracted chain
            points.setdefault((CONTRACTED_N, CONTRACTED_N.bit_length()), 0)
        rows, gap, one = [], 0.0, {}
        for (size, k), count in sorted(points.items()):
            fn, bnd = make(size, k)
            ms = time_ms(fn, flush=flush)
            gap += count * (ms - bnd)
            if k == 1:
                one[size] = ms - bnd
            rows.append({"size": size, "steps": k, "launches": count,
                         "ms": ms, "bound_ms": bnd})
        out[name] = {"launches": launches[name], "gap_ms": gap,
                     "by_size": rows}
        if name != "pack_rows":
            out[name]["per_step_launches"] = sum(per_step[name].values())
            out[name]["per_step_gap_ms"] = sum(
                c * one[size] for size, c in per_step[name].items())
    del src, nxt, chain, chain32, heads
    torch.cuda.empty_cache()
    return out


def gathers_check(phase: str, launches: dict, gathers: int) -> dict:
    """pack_rows must have launched once per non-empty grouped gather (no
    drain of these phases holds more than MAX_GROUPS regions)."""
    if launches["pack_rows"] != gathers:
        raise AssertionError(f"{phase}: {launches['pack_rows']} pack_rows "
                             f"launches for {gathers} grouped gathers")
    return {"phase": f"{phase}_gathers", "pack_rows_launches": gathers,
            "grouped_gathers": gathers,
            "per_region_pack_rows_launches":
                PER_REGION_PACK_LAUNCHES.get(phase)}


def band_pairs(sq: int, skv: int, causal: bool = True,
               window: int = 0) -> int:
    """The (query, key) pairs the mask keeps: key kpos < Skv, kpos <= qpos
    when causal, qpos - kpos < window when window > 0."""
    import numpy as np
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_bound_ms(h: int, hk: int, sq: int, skv: int, d: int, itemsize: int,
                   causal: bool = True, window: int = 0) -> float:
    """The larger of the kept pairs' flops (4 per pair and width; a window
    keeps only its band) over the peak for the input type and q, k, v, o
    once over the HBM rate."""
    flops = 4 * h * d * band_pairs(sq, skv, causal, window)
    peak = F32_FLOPS if itemsize == 4 else BF16_FLOPS
    nbytes = itemsize * d * (2 * h * sq + 2 * hk * skv)
    return max(flops / peak * 1e3, bound_ms(nbytes))


def flash_case(dev, g, dt, h: int, hk: int, seq: int, d: int, flush) -> dict:
    """flash_attention vs its plain version at (h, seq, d) over (hk, seq,
    d), causal, in ``dt``, timed beside its bound and the library's
    scaled_dot_product_attention (grouped, causal)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    q = torch.randn((h, seq, d), generator=g, device=dev).to(dt)
    k = torch.randn((hk, seq, d), generator=g, device=dev).to(dt)
    v = torch.randn((hk, seq, d), generator=g, device=dev).to(dt)
    err = max_abs_err(FA.flash_attention(q, k, v),
                      FA.flash_attention_plain(q, k, v))
    tol = FLASH_TOL[str(dt).split(".")[-1]]
    if not err <= tol:
        raise AssertionError(f"flash_attention {dt} S={seq}: max abs err "
                             f"{err} above {tol}")
    return {
        "ms": time_ms(lambda: FA.flash_attention(q, k, v), flush=flush),
        "plain_ms": time_ms(lambda: FA.flash_attention_plain(q, k, v),
                            reps=5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, enable_gqa=True),
            flush=flush),
        "bound_ms": flash_bound_ms(h, hk, seq, seq, d, q.element_size()),
        "max_abs_err": err, "tolerance": tol}


def flash_band_case(dev, g, dt, h: int, hk: int, seq: int, d: int,
                    window: int, softcap: float, flush) -> dict:
    """flash_attention with a sliding window (and a softcap) against its
    plain version at a gemma or hymba layer's shape, causal, in ``dt``;
    timed beside its band-counted bound, the same call with no window (the
    band's skipped tiles) and, where no cap bends the scores,
    scaled_dot_product_attention with the boolean band mask.  Window 0 is
    a causal layer with no window: no band, ``sdpa`` causal."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    q = torch.randn((h, seq, d), generator=g, device=dev).to(dt)
    k = torch.randn((hk, seq, d), generator=g, device=dev).to(dt)
    v = torch.randn((hk, seq, d), generator=g, device=dev).to(dt)
    kw = dict(window=window, softcap=softcap)
    err = max_abs_err(FA.flash_attention(q, k, v, **kw),
                      FA.flash_attention_plain(q, k, v, **kw))
    tol = FLASH_TOL[str(dt).split(".")[-1]]
    if not err <= tol:
        raise AssertionError(f"flash_attention {dt} S={seq} D={d} window="
                             f"{window} softcap={softcap}: max abs err {err} "
                             f"above {tol}")
    size = q.element_size()
    out = {
        "ms": time_ms(lambda: FA.flash_attention(q, k, v, **kw), flush=flush),
        "plain_ms": time_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                            reps=3),
        "bound_ms": flash_bound_ms(h, hk, seq, seq, d, size, window=window),
        "band_pairs_per_head": band_pairs(seq, seq, True, window),
        "max_abs_err": err, "tolerance": tol,
        "shape": f"q ({h}, {seq}, {d}) over k, v ({hk}, {seq}, {d}), causal, "
                 f"window {window}, softcap {softcap}"}
    if window:
        out["no_window_ms"] = time_ms(lambda: FA.flash_attention(
            q, k, v, softcap=softcap), flush=flush)
        out["no_window_bound_ms"] = flash_bound_ms(h, hk, seq, seq, d, size)
    if softcap:
        out["library_ms"] = None
        out["library_note"] = ("no PyTorch call caps the scores: sdpa "
                               "takes a mask, not a tanh of the scores")
    elif window:
        ahead = (torch.arange(seq, device=dev)[:, None]
                 - torch.arange(seq, device=dev)[None, :])
        band = (ahead >= 0) & (ahead < window)
        out["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=band, enable_gqa=True),
            flush=flush)
        del band, ahead
    else:
        out["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, enable_gqa=True),
            flush=flush)
    del q, k, v
    torch.cuda.empty_cache()
    return out


def flash_band_edges(dev, g, seq: int = 1000) -> dict:
    """flash_attention against its plain version, untimed, at the band's
    edge cases in both dtypes, 6 query heads over 2 KV heads: window 1, a
    window at and past S, windows that are no multiple of a tile (100,
    129), causal and not; a softcap alone at D = 64 and 128 (2, every
    score bent, and gemma2's 50); the two together at D = 256.  Returns
    {case: max abs err}."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    cases = [(128, w, 0.0, c) for w in (1, seq, 5 * seq, 100, 129)
             for c in (True, False)]
    cases += [(d, 0, cap, c) for d in (64, 128) for cap in (2.0, 50.0)
              for c in (True, False)]
    cases += [(256, 129, 50.0, c) for c in (True, False)]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[str(dt).split(".")[-1]]
        for d, window, cap, causal in cases:
            q = torch.randn((6, seq, d), generator=g, device=dev).to(dt)
            k = torch.randn((2, seq, d), generator=g, device=dev).to(dt)
            v = torch.randn((2, seq, d), generator=g, device=dev).to(dt)
            kw = dict(causal=causal, window=window, softcap=cap)
            err = max_abs_err(FA.flash_attention(q, k, v, **kw),
                              FA.flash_attention_plain(q, k, v, **kw))
            name = (f"{str(dt).split('.')[-1]} D={d} window={window} "
                    f"softcap={cap} causal={causal}")
            if not err <= tol:
                raise AssertionError(f"flash_attention {name} S={seq}: max "
                                     f"abs err {err} above {tol}")
            errs[name] = err
    return errs


def flash_width_parity(dev, g, seq: int = 1000) -> dict:
    """flash_attention vs its plain version, untimed, at every head width
    of ``HEAD_DIMS`` (256 included) in both dtypes, causal and not: 6
    query heads over 2 KV heads at a ragged S.  Returns {case: max abs
    err}."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    errs = {}
    for d in FA.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn((6, seq, d), generator=g, device=dev).to(dt)
            k = torch.randn((2, seq, d), generator=g, device=dev).to(dt)
            v = torch.randn((2, seq, d), generator=g, device=dev).to(dt)
            tol = FLASH_TOL[str(dt).split(".")[-1]]
            for causal in (True, False):
                err = max_abs_err(FA.flash_attention(q, k, v, causal=causal),
                                  FA.flash_attention_plain(q, k, v,
                                                           causal=causal))
                name = f"{str(dt).split('.')[-1]} D={d} causal={causal}"
                if not err <= tol:
                    raise AssertionError(f"flash_attention {name} S={seq}: "
                                         f"max abs err {err} above {tol}")
                errs[name] = err
    return errs


def flash_prefill_bf16(dev, batch: int = 2, tokens: int = 1536) -> dict:
    """A llama3.2-3b prefill at full width and depth in bf16 (the models'
    default compute dtype) through flash_attention (48 query heads over 16
    KV heads per layer, phase 7's shape), against the same prefill with
    flash_attention_plain substituted.  The two differ only in how
    attention rounds: the kernel rounds P to bf16 before P.V and sums in
    another order, so an attention output may differ by a bf16 rounding
    (2**-8 of its size) in any of 28 layers, and bf16 matmuls and residual
    adds carry that into the logits.  Tolerance: FLASH_PREFILL_TOL of the
    largest |logit|, room for about a dozen such roundings.  For scale,
    both are also held (untested) against the f32 prefill of the same
    parameters."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers
    from repro_torch.models.backbone import init_params
    from repro_torch.models.model import Model
    cfg = serve_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    params = init_params(cfg, gen, dev)
    toks = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
        1, cfg.vocab, (batch, tokens))).to(dev)

    def prefill(dtype, attention):
        layers.flash_attention = attention
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = Model(cfg, compute_dtype=dtype).prefill(
                params, {"tokens": toks})[0]
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        finally:
            layers.flash_attention = FA.flash_attention
    prefill(torch.bfloat16, FA.flash_attention_plain)   # first-use set-up
    before = FA.flash_attention.launches
    got, kernel_s = prefill(torch.bfloat16, FA.flash_attention)
    launches = FA.flash_attention.launches - before
    want, plain_s = prefill(torch.bfloat16, FA.flash_attention_plain)
    ref, _ = prefill(torch.float32, FA.flash_attention)
    del params
    torch.cuda.empty_cache()
    if launches != cfg.n_layers:
        raise AssertionError(f"bf16 prefill launched flash_attention "
                             f"{launches} times, not {cfg.n_layers}")
    if not (bool(torch.isfinite(got).all()) and got.shape == want.shape):
        raise AssertionError("bf16 prefill: logits not finite or misshapen")
    amax = float(want.abs().max())
    err = float((got - want).abs().max()) / amax
    if not err <= FLASH_PREFILL_TOL:
        raise AssertionError(f"bf16 prefill: logits differ from the plain "
                             f"attention's by {err} of the largest |logit| "
                             f"(tolerance {FLASH_PREFILL_TOL})")
    ref_amax = float(ref.abs().max())
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch,
            "tokens": tokens, "launches": launches, "logit_rel_err": err,
            "tolerance": FLASH_PREFILL_TOL, "max_abs_logit": amax,
            "kernel_vs_f32": float((got - ref).abs().max()) / ref_amax,
            "plain_vs_f32": float((want - ref).abs().max()) / ref_amax,
            "same_argmax": bool(torch.equal(got.argmax(-1),
                                            want.argmax(-1))),
            "kernel_s": kernel_s, "plain_s": plain_s}


def flash_build_report() -> dict:
    """Registers, spills and stack of each flash kernel, forward and
    backward (the dK/dV and dQ kernels and the Di pass), read from the
    build's ptxas report, and the dynamic shared memory each launches with
    (ptxas reports static shared memory only; the Di pass has none); the
    bf16 backward's kernels twice, with and without the softcap.  A
    kernel with setmaxnreg reports its registers at entry: the bf16
    backward's consumers run with 240, its producer with 24."""
    import re
    from repro_torch.kernels import _build
    fwd, bwd = _build.load("flash_attention"), _build.load(
        "flash_attention_bwd")
    kinds = {
        "flash_attention": [(
            r"flash_(bf16|f32)ILi(\d+)E",
            lambda m: (f"{m.group(1)} D={m.group(2)}",
                       fwd.flash_attention_smem_bytes(
                           int(m.group(2)), int(m.group(1) == "bf16"))))],
        "flash_attention_bwd": [(
            r"flash_bwd_(dkdv|dq)_(f32|bf16)ILi(\d+)E(Lb1E)?",
            lambda m: (f"bwd_{m.group(1)} {m.group(2)} D={m.group(3)}"
                       f"{' softcap' if m.group(4) else ''}",
                       bwd.flash_attention_bwd_smem_bytes(
                           int(m.group(3)), int(m.group(2) == "bf16"),
                           int(m.group(1) == "dq")))), (
            r"flash_bwd_deltaI(f|13__nv_bfloat16)Li(\d+)E",
            lambda m: (f"bwd_delta {'f32' if m.group(1) == 'f' else 'bf16'} "
                       f"D={m.group(2)}", 0))]}
    out = {}
    for source, forms in kinds.items():
        name = None
        for ln in _build.library_path(source).with_suffix(
                ".log").read_text().splitlines():
            if "entry function" in ln:
                name = None
                for pattern, describe in forms:
                    m = re.search(r"entry function '\S*" + pattern, ln)
                    if m:
                        name, smem = describe(m)
                        out[name] = {"smem_bytes": smem}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m and name:
                out[name].update(stack_bytes=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and name:
                out[name]["registers"] = int(m.group(1))
    # forward: 2 types x 5 widths; backward: the dK/dV and dQ kernels (bf16
    # with and without the softcap) and the Di pass, each 2 types x 5
    # widths
    if len(out) != 10 + 40 or any("registers" not in v for v in out.values()):
        raise AssertionError(f"ptxas report of the flash kernels "
                             f"incomplete: {out}")
    return out


def flash_bwd_bound_ms(h: int, hk: int, sq: int, skv: int, d: int,
                      itemsize: int, causal: bool = True,
                      flops_per_pair: int = 10, window: int = 0) -> float:
    """The larger of the backward's flops (10 per kept pair and width: S
    and dP, dV, dK and dQ; the kernels' two-launch design does 14, S and
    dP twice, 22 at D = 256; a window keeps only its band) over the peak
    for the input type and q, k, v, o, dO and lse read once, dq, dk, dv
    written once, over the HBM rate."""
    pairs = band_pairs(sq, skv, causal, window)
    peak = F32_FLOPS if itemsize == 4 else BF16_FLOPS
    nbytes = itemsize * d * (4 * h * sq + 4 * hk * skv) + 4 * h * sq
    return max(flops_per_pair * h * d * pairs / peak * 1e3, bound_ms(nbytes))


def bwd_launch(q, k, v, o, do, lse, causal: bool, parts: int, out=None,
               window: int = 0, softcap: float = 0.0):
    """One direct call of ``flash_attention_bwd_launch`` running the
    kernels in ``parts`` (``FA.BWD_DELTA | BWD_DKDV | BWD_DQ``), outside the
    wrapper, whose count does not move: Di's check and each kernel's time.
    Returns the buffers (di, dq, dk, dv), ``out`` when given."""
    import torch
    from repro_torch.kernels import _build
    h, sq, d = q.shape
    di, dq, dk, dv = out or (
        torch.empty((h, sq), dtype=torch.float32, device=q.device),
        torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    rc = _build.load("flash_attention_bwd").flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), h, sq, k.shape[1], d, h // k.shape[0], int(causal),
        1.0 / math.sqrt(d), window, softcap, int(q.dtype == torch.bfloat16),
        parts,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise AssertionError(f"flash_attention_bwd_launch parts={parts}: "
                             f"error {rc}")
    return di, dq, dk, dv


def flash_bwd_inputs(dev, g, dt, h: int, hk: int, sq: int, skv: int,
                     d: int):
    import torch
    q = torch.randn((h, sq, d), generator=g, device=dev).to(dt)
    k = torch.randn((hk, skv, d), generator=g, device=dev).to(dt)
    v = torch.randn((hk, skv, d), generator=g, device=dev).to(dt)
    do = torch.randn((h, sq, d), generator=g, device=dev).to(dt)
    return q, k, v, do


def flash_bwd_check(q, k, v, do, causal: bool, window: int = 0,
                    softcap: float = 0.0) -> dict:
    """The forward kernel's lse against the plain forward's (LSE_TOL,
    absolute: the kernels' exp and sums round differently, lse is O(10)),
    the backward's Di pass against its plain version (DI_TOL of the largest
    |Di|: f32 sums in another order), then the backward kernels on the
    kernel forward's o and lse against flash_attention_bwd_plain on the
    same inputs, within FLASH_TOL of the largest |grad| (f32: summation
    order; bf16: also the rounding of P, dS and each output to bf16), and
    a second backward run equal bit for bit (no atomics: the order of
    every sum is fixed); ``window`` and ``softcap`` as the forward's."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    band = dict(window=window, softcap=softcap)
    o, lse = FA._forward(q, k, v, causal, None, True, window, softcap)
    _, lse_plain = FA.flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True, **band)
    # a row that sees no key (a window past Skv) has lse +inf in both
    seen = torch.isfinite(lse_plain)
    if not torch.equal(seen, torch.isfinite(lse)):
        raise AssertionError("flash_attention lse: the kernel's rows with "
                             "no visible key differ from the plain one's")
    lse_err = max_abs_err(lse[seen], lse_plain[seen])
    del lse_plain, seen
    di = bwd_launch(q, k, v, o, do, lse, causal, FA.BWD_DELTA, **band)[0]
    di_plain = FA.flash_attention_bwd_delta_plain(o, do)
    di_err = max_abs_err(di, di_plain) / float(di_plain.abs().max())
    got = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, **band)
    again = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                   **band)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = FA.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                        **band)
    top = max(float(w.float().abs().max()) for w in want)
    err = max(max_abs_err(a, b) for a, b in zip(got, want)) / top
    del got, want
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    name = (f"{str(q.dtype).split('.')[-1]} q {tuple(q.shape)} k "
            f"{tuple(k.shape)} causal={causal} window={window} "
            f"softcap={softcap}")
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_attention lse {name}: max abs err "
                             f"{lse_err} above {LSE_TOL}")
    if not di_err <= DI_TOL:
        raise AssertionError(f"flash_attention_bwd Di {name}: max abs err "
                             f"{di_err} of the largest |Di| above {DI_TOL}")
    if not err <= tol:
        raise AssertionError(f"flash_attention_bwd {name}: max abs err "
                             f"{err} of the largest |grad| above {tol}")
    if not same:
        raise AssertionError(f"flash_attention_bwd {name}: two runs differ")
    return {"lse_err": lse_err, "di_rel_err": di_err, "rel_err": err,
            "max_abs_grad": top}


def flash_bwd_parity(dev, g) -> dict:
    """flash_attention_bwd against its plain version, untimed, at every
    head width (256 included) in both dtypes, causal and not, 6 query heads
    over 6 (G = 1) and over 2 (G = 3) KV heads, at a ragged S = 1000 and at
    Sq = 77 over Skv = 333.  Returns {case: errors}."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    out = {}
    for d in FA.BWD_HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            for group in (1, 3):
                for sq, skv in ((1000, 1000), (77, 333)):
                    q, k, v, do = flash_bwd_inputs(dev, g, dt, 6, 6 // group,
                                                   sq, skv, d)
                    for causal in (True, False):
                        name = (f"{str(dt).split('.')[-1]} D={d} G={group} "
                                f"{sq}x{skv} causal={causal}")
                        out[name] = flash_bwd_check(q, k, v, do, causal)
    return out


def flash_grad_on_card(dev, g) -> dict:
    """On CUDA tensors that require grad, flash_attention's autograd runs
    the backward kernel once (its counter moves by one) and gives q, k and
    v non-zero grads within FLASH_TOL of torch autograd through the plain
    forward."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    q, k, v, do = flash_bwd_inputs(dev, g, torch.float32, 24, 8, 300, 300,
                                   128)
    mine = [t.clone().requires_grad_() for t in (q, k, v)]
    before = FA.flash_attention_bwd.launches
    grads = torch.autograd.grad(FA.flash_attention(*mine), mine, do)
    launched = FA.flash_attention_bwd.launches - before
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(FA.flash_attention_plain(*ref), ref, do)
    top = max(float(w.abs().max()) for w in want)
    err = max(max_abs_err(a, b) for a, b in zip(grads, want)) / top
    smallest = min(float(a.abs().max()) for a in grads)
    if launched != 1 or not smallest > 0 or not err <= FLASH_TOL["float32"]:
        raise AssertionError(f"flash_attention autograd on the card: "
                             f"{launched} backward launches, smallest "
                             f"max |grad| {smallest}, error {err}")
    return {"bwd_launches": launched, "rel_err": err,
            "min_max_abs_grad": smallest}


def flash_bwd_timing(dev, g, flush) -> dict:
    """The backward at phase 10's shape (a train step's layer: 4 sequences
    of 1024 tokens, 24 query heads over 8 KV heads of width 128, causal)
    in f32 (phase 10's dtype) and bf16, checked as flash_bwd_check does,
    timed beside its bound, its design's floor (14 flops per pair and
    width) and the backward of scaled_dot_product_attention (grouped,
    causal) on the same inputs (a yardstick, never on the path); then each
    of its three kernels alone: the Di pass beside its bytes (o and dO read
    once, Di written once), the dK/dV and dQ kernels."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    h, hk, s, d = 96, 32, 1024, 128
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = flash_bwd_inputs(dev, g, dt, h, hk, s, s, d)
        errs = flash_bwd_check(q, k, v, do, True)
        o, lse = FA._forward(q, k, v, True, None, with_lse=True)
        lib = [t[None].clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*lib, is_causal=True,
                                             enable_gqa=True)
        bufs = bwd_launch(q, k, v, o, do, lse, True, FA.BWD_DELTA)
        size = q.element_size()
        rows[str(dt).split(".")[-1]] = {
            "ms": time_ms(lambda: FA.flash_attention_bwd(q, k, v, o, do,
                                                         lse), flush=flush),
            "plain_ms": time_ms(lambda: FA.flash_attention_bwd_plain(
                q, k, v, o, do, lse), reps=5),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                out, lib, do[None], retain_graph=True), flush=flush),
            "bound_ms": flash_bwd_bound_ms(h, hk, s, s, d, size),
            "floor_ms": flash_bwd_bound_ms(h, hk, s, s, d, size,
                                           flops_per_pair=14),
            "di_ms": time_ms(lambda: bwd_launch(
                q, k, v, o, do, lse, True, FA.BWD_DELTA, bufs), flush=flush),
            "di_bound_ms": bound_ms(2 * h * s * d * size + 4 * h * s),
            "dkdv_ms": time_ms(lambda: bwd_launch(
                q, k, v, o, do, lse, True, FA.BWD_DKDV, bufs), flush=flush),
            "dq_ms": time_ms(lambda: bwd_launch(
                q, k, v, o, do, lse, True, FA.BWD_DQ, bufs), flush=flush),
            "max_abs_err": errs["rel_err"] * errs["max_abs_grad"],
            "rel_err": errs["rel_err"], "lse_err": errs["lse_err"],
            "di_rel_err": errs["di_rel_err"],
            "tolerance": FLASH_TOL[str(dt).split(".")[-1]]}
        del q, k, v, do, o, lse, lib, out, bufs
    torch.cuda.empty_cache()
    return rows


def flash_bwd_band_edges(dev, g, seq: int = 1000) -> dict:
    """flash_attention_bwd against its plain version, untimed, at the
    band's edge cases in both dtypes, 6 query heads over 2 KV heads, each
    run twice bit for bit (flash_bwd_check): window 1, a window at and past
    S, windows that are no multiple of a tile (100, 129), causal and not; a
    softcap alone at D = 64 and 128 (2, every score bent, and gemma2's
    50); the two together at D = 256, also at Sq = 77 over Skv = 333 and
    Sq = 333 over Skv = 77 (rows that see no key).  Returns {case:
    errors}."""
    import torch
    cases = [(128, seq, seq, w, 0.0, c) for w in (1, seq, 5 * seq, 100, 129)
             for c in (True, False)]
    cases += [(d, seq, seq, 0, cap, c) for d in (64, 128)
              for cap in (2.0, 50.0) for c in (True, False)]
    cases += [(256, sq, skv, 129, 50.0, c)
              for sq, skv in ((seq, seq), (77, 333), (333, 77))
              for c in (True, False)]
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for d, sq, skv, window, cap, causal in cases:
            q, k, v, do = flash_bwd_inputs(dev, g, dt, 6, 2, sq, skv, d)
            name = (f"{str(dt).split('.')[-1]} D={d} {sq}x{skv} window="
                    f"{window} softcap={cap} causal={causal}")
            out[name] = flash_bwd_check(q, k, v, do, causal, window, cap)
    return out


def flash_bwd_band_case(dev, g, dt, h: int, hk: int, seq: int, d: int,
                        window: int, softcap: float, flush) -> dict:
    """flash_attention_bwd with a gemma layer's window and softcap against
    its plain version at phase 16's training shape, causal, in ``dt``
    (flash_bwd_check: lse, Di, grads, two runs bit for bit); timed with
    CUDA events under the L2 eviction beside its band-counted bound (10
    flops per kept pair and width) and its design's floor (14, 22 at D =
    256), the same call with no window (the band's skipped tiles) and,
    where no cap bends the scores, the backward of
    scaled_dot_product_attention with the boolean band mask (a yardstick,
    never on the path); ``null`` under a cap (no PyTorch call caps the
    scores)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    q, k, v, do = flash_bwd_inputs(dev, g, dt, h, hk, seq, seq, d)
    errs = flash_bwd_check(q, k, v, do, True, window, softcap)
    band = dict(window=window, softcap=softcap)
    o, lse = FA._forward(q, k, v, True, None, True, window, softcap)
    size = q.element_size()
    floor = 22 if d > 128 else 14
    reps = 5 if d > 128 else 20      # gemma2's launches take tens of ms
    out = {
        "ms": time_ms(lambda: FA.flash_attention_bwd(q, k, v, o, do, lse,
                                                     **band), reps=reps,
                      flush=flush),
        "plain_ms": time_ms(lambda: FA.flash_attention_bwd_plain(
            q, k, v, o, do, lse, **band), reps=2),
        "bound_ms": flash_bwd_bound_ms(h, hk, seq, seq, d, size,
                                       window=window),
        "floor_ms": flash_bwd_bound_ms(h, hk, seq, seq, d, size,
                                       flops_per_pair=floor, window=window),
        "band_pairs_per_head": band_pairs(seq, seq, True, window),
        "max_abs_err": errs["rel_err"] * errs["max_abs_grad"],
        "rel_err": errs["rel_err"], "lse_err": errs["lse_err"],
        "di_rel_err": errs["di_rel_err"],
        "tolerance": FLASH_TOL[str(dt).split(".")[-1]],
        "shape": f"q, o, dO ({h}, {seq}, {d}) over k, v ({hk}, {seq}, {d}), "
                 f"causal, window {window}, softcap {softcap}"}
    if window:
        out["no_window_ms"] = time_ms(lambda: FA.flash_attention_bwd(
            q, k, v, o, do, lse, softcap=softcap), reps=reps, flush=flush)
        out["no_window_bound_ms"] = flash_bwd_bound_ms(h, hk, seq, seq, d,
                                                       size)
    if softcap:
        out["library_ms"] = None
        out["library_note"] = ("no PyTorch call caps the scores: sdpa "
                               "takes a mask, not a tanh of the scores")
    else:
        ahead = (torch.arange(seq, device=dev)[:, None]
                 - torch.arange(seq, device=dev)[None, :])
        mask = (ahead >= 0) & (ahead < window) if window else ahead >= 0
        lib = [t[None].clone().requires_grad_() for t in (q, k, v)]
        res = F.scaled_dot_product_attention(*lib, attn_mask=mask,
                                             enable_gqa=True)
        out["library_ms"] = time_ms(lambda: torch.autograd.grad(
            res, lib, do[None], retain_graph=True), flush=flush)
        del ahead, mask, lib, res
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return out


def flash_cross_case(dev, g, dt, h: int, hk: int, sq: int, skv: int,
                     d: int, flush) -> tuple:
    """flash_attention and flash_attention_bwd, non-causal, at a cross or
    encoder layer's shape (Sq queries over Skv keys of a context) in
    ``dt``: the forward against its plain version (FLASH_TOL), the
    backward as flash_bwd_check holds it (lse, Di, grads, two runs bit for
    bit); each timed beside its flop bound (4, then 10 flops a pair and
    width; the backward's design floor 14), its plain version and
    scaled_dot_product_attention (grouped, no mask) forward and backward.
    Returns (forward row, backward row)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    q, k, v, do = flash_bwd_inputs(dev, g, dt, h, hk, sq, skv, d)
    err = max_abs_err(FA.flash_attention(q, k, v, causal=False),
                      FA.flash_attention_plain(q, k, v, causal=False))
    tol = FLASH_TOL[str(dt).split(".")[-1]]
    shape = f"q ({h}, {sq}, {d}) over k, v ({hk}, {skv}, {d}), non-causal"
    if not err <= tol:
        raise AssertionError(f"flash_attention {dt} {shape}: max abs err "
                             f"{err} above {tol}")
    size = q.element_size()
    fwd = {
        "ms": time_ms(lambda: FA.flash_attention(q, k, v, causal=False),
                      flush=flush),
        "plain_ms": time_ms(lambda: FA.flash_attention_plain(
            q, k, v, causal=False), reps=3),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], enable_gqa=True), flush=flush),
        "bound_ms": flash_bound_ms(h, hk, sq, skv, d, size, causal=False),
        "max_abs_err": err, "tolerance": tol, "shape": shape}
    errs = flash_bwd_check(q, k, v, do, False)
    o, lse = FA._forward(q, k, v, False, None, True)
    lib = [t[None].clone().requires_grad_() for t in (q, k, v)]
    res = F.scaled_dot_product_attention(*lib, enable_gqa=True)
    bwd = {
        "ms": time_ms(lambda: FA.flash_attention_bwd(q, k, v, o, do, lse,
                                                     causal=False),
                      flush=flush),
        "plain_ms": time_ms(lambda: FA.flash_attention_bwd_plain(
            q, k, v, o, do, lse, causal=False), reps=3),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            res, lib, do[None], retain_graph=True), flush=flush),
        "bound_ms": flash_bwd_bound_ms(h, hk, sq, skv, d, size,
                                       causal=False),
        "floor_ms": flash_bwd_bound_ms(h, hk, sq, skv, d, size,
                                       causal=False, flops_per_pair=14),
        "max_abs_err": errs["rel_err"] * errs["max_abs_grad"],
        "rel_err": errs["rel_err"], "lse_err": errs["lse_err"],
        "di_rel_err": errs["di_rel_err"], "tolerance": tol,
        "shape": shape}
    del q, k, v, do, o, lse, lib, res
    torch.cuda.empty_cache()
    return fwd, bwd


def quantize_non_finite(dev, g) -> dict:
    """quantize_blockwise against its plain version, exactly (scales
    compared as bits: NaN != NaN), on groups holding NaN, +inf and -inf
    beside finite groups: the plain version gives the reference's bits
    (scale NaN or inf, every NaN quotient 0)."""
    import torch
    from repro_torch.kernels import quant_pack as Q
    x = torch.randn((64, 1024), generator=g, device=dev)
    for row, bad in ((0, float("nan")), (1, float("inf")),
                     (2, -float("inf")), (3, float("nan"))):
        x[row, 256 * (row % 4) + 7] = bad
    x[3, 256 * 3 + 8] = float("inf")    # NaN and inf in one group
    q, s = Q.quantize_blockwise(x)
    qp, sp = Q.quantize_blockwise_plain(x)
    if not (torch.equal(q, qp) and torch.equal(s.view(torch.int32),
                                               sp.view(torch.int32))):
        raise AssertionError("quantize_blockwise differs from its plain "
                             "version on non-finite groups")
    return {"groups_nan": int(torch.isnan(s).sum()),
            "groups_inf": int(torch.isinf(s).sum()),
            "zero_payload_groups": int((q.view(64, 4, 256) == 0).all(-1)
                                       .sum())}


# -------------------------------------------------------------- serving

def serve_config(layers: int = 0):
    """llama3.2-3b at its published widths; ``layers`` cuts the depth."""
    from repro_torch.configs import registry
    cfg = registry.get(SERVE_ARCH)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def serve_once(cfg, params, device, prompts, steps: int, path: Path) -> dict:
    """One engine on ``device`` serving ``prompts`` for ``steps`` greedy
    steps (max_batch 2, s_max 64); the prefill logits of each prompt, the
    tokens and logits of every step, and the engine arena file's bytes."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import EngineConfig, ServingEngine
    model = Model(cfg, compute_dtype=torch.float32)
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    eng = ServingEngine(model, params, EngineConfig(max_batch=2, s_max=64),
                        arena_path=str(path / "engine"), device=device)
    pre = [model.prefill(params, {"tokens": torch.as_tensor(p[None]).to(
        device)}, s_max=64)[0][0].cpu() for p in prompts]
    for rid, p in enumerate(prompts):
        eng.add_request(rid, p)
    toks, logits = [], []
    for _ in range(steps):
        toks.append(eng.step())
        logits.append({r: lg.cpu() for r, lg in eng.step_logits.items()})
    return {"prefill": pre, "tokens": toks, "logits": logits,
            "stats": dataclasses.asdict(eng.arena.stats),
            "file": (path / "engine").read_bytes()}


# the f32 results of bf16 products (layers.f32_product): on the card
# torch.mm/bmm with an f32 output, on the CPU the operands upcast
BF16_DECODE_SEEDS = range(5)
BF16_PRODUCT_TOL = 5e-5        # f32 product, of the largest |result|
BF16_ULP_TOL = 2.0 ** -7       # a bf16 result, of the largest |result|


def bf16_products_card_vs_cpu(dev) -> dict:
    """Phase 4's bf16 products, the card's branch of ``f32_product``
    against the CPU's upcast on the same bf16 values.  ``decode_attention``
    at ROADMAP Queue 3 item 19's smallest input (q (1, 1, 2, 2, 64), k and
    v caches (1, 64, 2, 64), q and k from N(0, 16), pos 63), softcap 0
    and 50, five seeds: within BF16_ULP_TOL of the largest |output|,
    which the scores rounded to bf16 before the cap (the repaired fault,
    run on the card) exceed at some seed.  ``f32_product`` at model
    widths, llama3.2-3b's gate (512 x 3072 by 3072 x 8192) and dbrx-132b's
    experts (4 of its 16: 4 x 64 x 6144 by 4 x 6144 x 10752): within
    BF16_PRODUCT_TOL of the largest |result|, which the product rounded to
    bf16 exceeds; ``gate_up`` on the same values within BF16_ULP_TOL, and
    the 2-D product's gradients (bf16 products) within BF16_ULP_TOL of
    the largest |grad|."""
    import torch
    from repro_torch.models import layers as TL
    out = {"decode": [], "products": []}

    def rel(a, b):
        return float((a.float().cpu() - b.float()).abs().max()
                     / b.float().abs().max())
    for softcap in (0.0, 50.0):
        worst = old_worst = 0.0
        for seed in BF16_DECODE_SEEDS:
            g = torch.Generator().manual_seed(seed)
            q, k = (torch.randn(s, generator=g) * 4.0 for s in
                    ((1, 1, 2, 2, 64), (1, 64, 2, 64)))
            v = torch.randn((1, 64, 2, 64), generator=g)
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            want = TL.decode_attention(q, k, v, torch.arange(64), 63,
                                       softcap=softcap)
            qd, kd, vd = (t.to(dev) for t in (q, k, v))
            got = TL.decode_attention(qd, kd, vd,
                                      torch.arange(64, device=dev), 63,
                                      softcap=softcap)
            s = torch.einsum("bkgd,bjkd->bkgj", qd[:, 0] * 0.125,
                             kd).float()          # scores rounded to bf16
            pr = torch.softmax(TL._softcap(s, softcap), dim=-1)
            old = torch.einsum("bkgj,bjkd->bkgd", pr.to(torch.bfloat16),
                               vd)[:, None]
            worst = max(worst, rel(got, want))
            old_worst = max(old_worst, rel(old, want))
        out["decode"].append({"softcap": softcap, "rel_err": worst,
                              "bf16_scores_rel_err": old_worst})
        if worst > BF16_ULP_TOL or old_worst <= BF16_ULP_TOL:
            raise AssertionError(f"bf16 decode_attention softcap {softcap}: "
                                 f"card vs CPU {worst}, scores rounded to "
                                 f"bf16 {old_worst} (tolerance "
                                 f"{BF16_ULP_TOL})")
    g = torch.Generator().manual_seed(19)
    for name, sa, sb in (("llama3.2-3b gate", (512, 3072), (3072, 8192)),
                         ("dbrx-132b experts", (4, 64, 6144),
                          (4, 6144, 10752))):
        a = torch.randn(sa, generator=g).to(torch.bfloat16)
        w_g, w_u = ((torch.randn(sb, generator=g) * 0.02).to(torch.bfloat16)
                    for _ in range(2))
        want = TL.f32_product(a, w_g)
        ad, wgd, wud = (t.to(dev) for t in (a, w_g, w_u))
        if len(sa) == 2:
            ad.requires_grad_()
            wgd.requires_grad_()
        got = TL.f32_product(ad, wgd)
        row = {"case": name, "a": list(sa), "b": list(sb),
               "dtype": str(got.dtype), "rel_err": rel(got.detach(), want),
               "bf16_rel_err": rel(got.detach().to(torch.bfloat16), want)}
        h = TL.gate_up(ad.detach(), wgd.detach(), wud, "silu")
        row["gate_up_rel_err"] = rel(h, TL.gate_up(a, w_g, w_u, "silu"))
        if len(sa) == 2:
            r = torch.randn(got.shape, generator=g)
            ga, gb = torch.autograd.grad(got, (ad, wgd), r.to(dev))
            ac, bc = (t.clone().requires_grad_() for t in (a, w_g))
            wa, wb = torch.autograd.grad(TL.f32_product(ac, bc), (ac, bc), r)
            row["grad_rel_err"] = max(rel(ga, wa), rel(gb, wb))
        out["products"].append(row)
        if (got.dtype != torch.float32 or row["rel_err"] > BF16_PRODUCT_TOL
                or row["bf16_rel_err"] <= BF16_PRODUCT_TOL
                or row["gate_up_rel_err"] > BF16_ULP_TOL
                or row.get("grad_rel_err", 0.0) > BF16_ULP_TOL):
            raise AssertionError(f"bf16 f32_product/gate_up card vs CPU: "
                                 f"{row}")
        del a, w_g, w_u, ad, wgd, wud, got, want, h
    torch.cuda.empty_cache()
    return out


def serve_card_vs_cpu(dev, cfg=None) -> dict:
    """Phase 4's serving check: ``cfg`` (llama3.2-3b at full width, 2
    layers, unless given), f32, parameters drawn once on the CPU and
    copied to the card."""
    import torch
    from repro_torch.core.policy import tree_map
    from repro_torch.models.backbone import init_params
    from repro_torch.serve_recover import LOGIT_TOL, prompts_for
    cfg = cfg or serve_config(layers=2)
    gen = torch.Generator()
    gen.manual_seed(SERVE_SEED)
    cpu_params = init_params(cfg, gen, "cpu")
    card_params = tree_map(lambda t: t.to(dev), cpu_params)
    prompts = prompts_for((12, 7), cfg.vocab, SERVE_SEED)
    out = {d: serve_once(cfg, prm, d, prompts, 8,
                         ROOT / "build" / "chip_smoke_serve" / str(d))
           for d, prm in ((dev, card_params), (torch.device("cpu"),
                                               cpu_params))}
    card, cpu = out[dev], out[torch.device("cpu")]
    worst, gaps, same_tokens = 0.0, [], True
    for a, b in zip(card["prefill"], cpu["prefill"]):
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    for st, (ta, tb) in enumerate(zip(card["tokens"], cpu["tokens"])):
        for rid in tb:
            a, b = card["logits"][st][rid], cpu["logits"][st][rid]
            worst = max(worst, float((a - b).abs().max() / b.abs().max()))
            top2 = torch.topk(b, 2).values
            gap = float((top2[0] - top2[1]) / b.abs().max())
            gaps.append(gap)
            if ta[rid] != tb[rid]:
                same_tokens = False
                if gap >= LOGIT_TOL:
                    raise AssertionError(f"serve step {st} request {rid}: "
                                         f"card token {ta[rid]} != CPU "
                                         f"{tb[rid]} with top-2 gap {gap}")
    if worst > LOGIT_TOL:
        raise AssertionError(f"serve: card and CPU logits differ by {worst} "
                             f"of the largest |logit|")
    if same_tokens and (card["file"] != cpu["file"]
                        or card["stats"] != cpu["stats"]):
        raise AssertionError("serve: same tokens but different engine "
                             "arena files or FlushStats")
    shutil.rmtree(ROOT / "build" / "chip_smoke_serve")
    return {"arch": cfg.name, "logit_rel_err": worst,
            "same_tokens": same_tokens,
            "min_top2_gap": min(gaps),
            "tokens": [list(t.values()) for t in cpu["tokens"]],
            "file_sha256": hashlib.sha256(card["file"]).hexdigest()[:12]}


def context_card_vs_cpu(dev, arch: str, steps: int = 6) -> dict:
    """Phase 4's context check: ``arch`` at its reduced config, f32,
    parameters drawn once on the CPU (every xgate 1) and copied to the
    card; two prompts of 12 tokens with the pipeline's seeded context or
    frames, a prefill, then ``steps`` greedy decode steps on each device
    from its own tokens: tokens equal, logits within LOGIT_TOL of the
    largest |logit|."""
    import torch
    from repro_torch.configs import base as cbase, registry as creg
    from repro_torch.core.policy import tree_map
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.models.backbone import init_params
    from repro_torch.models.model import Model
    from repro_torch.serve_recover import LOGIT_TOL
    cfg = cbase.reduced(creg.get(arch))
    gen = torch.Generator()
    gen.manual_seed(SERVE_SEED)
    cpu_params = init_params(cfg, gen, "cpu")
    open_gates(cpu_params)
    batch = Pipeline(cfg, 2, 12, seed=SERVE_SEED).batch_at(0)
    key = "frames" if cfg.family == "audio" else "context"
    model = Model(cfg, compute_dtype=torch.float32)
    runs = []
    for d in (dev, torch.device("cpu")):
        prm = tree_map(lambda t: t.to(d), cpu_params)
        lg, kv = model.prefill(prm, {"tokens": torch.from_numpy(
            batch["tokens"]).to(d), key: torch.from_numpy(batch[key]).to(
            d)}, s_max=12 + steps)
        logits, toks = [lg.cpu()], []
        for pos in range(12, 12 + steps):
            toks.append(lg.argmax(-1))
            lg, kv = model.decode_step(prm, kv, toks[-1], pos)
            logits.append(lg.cpu())
        runs.append((logits, [t.cpu().tolist() for t in toks]))
    (card, card_toks), (cpu, cpu_toks) = runs
    v = cfg.vocab
    err = max(float((a[:, :v] - b[:, :v]).abs().max())
              / float(b[:, :v].abs().max()) for a, b in zip(card, cpu))
    if card_toks != cpu_toks or not err <= LOGIT_TOL:
        raise AssertionError(f"{arch} card vs CPU: tokens {card_toks} / "
                             f"{cpu_toks}, logits {err} of the largest")
    return {"arch": cfg.name, "logit_rel_err": err, "tokens": cpu_toks,
            "context_key": key}


def model_decode_ms(cfg, params, dev) -> float:
    """Median host time of one ``Model.decode_step`` at batch 1 against a
    2048-slot cache at position 1600, ending in a sync: the model's share
    of a slot-step, without the engine's table and token-log work."""
    import torch
    from repro_torch.models.model import Model
    model = Model(cfg, compute_dtype=torch.float32)
    cache = model.init_cache(1, SERVE_S_MAX, dev)
    tok = torch.tensor([11], device=dev)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step(params, cache, tok, 1600)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times[1:])


def serving_phase(dev) -> dict:
    """Phase 7: the twin protocol at llama3.2-3b full width and depth;
    returns its numbers with the launch counts of its run."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.backbone import init_params
    from repro_torch.serve_recover import run
    cfg = serve_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run(cfg, dev, prompt_lens=SERVE_PROMPTS, max_batch=8,
              s_max=SERVE_S_MAX, steps=SERVE_STEPS, max_requests=64,
              seed=SERVE_SEED, params=params,
              workdir=str(ROOT / "build"))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    out["init_params_s"] = init_s
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # a group's re-prefill time: from the previous admission (the first:
    # from the engine stage's start, which also holds the slab scan)
    prev = 0.0
    for grp in sorted(out["groups"], key=lambda x: x["admitted_s"]):
        grp["seconds"] = grp["admitted_s"] - prev
        grp["tokens_per_s"] = len(grp["slots"]) * grp["prefilled"] \
            / grp["seconds"]
        prev = grp["admitted_s"]
    for p in out["prefill"]:
        p["tokens_per_s"] = p["prefilled"] / p["seconds"]
    out["model_decode_ms"] = model_decode_ms(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- gemma

# phase 15: each arch at its published widths, depth cut for time
# (layers), two prompts longer than the window, steps before the crash
# (finishing the first request halfway), steps after it, the cache span
GEMMA_SERVE = {
    "gemma3-27b": {"layers": 6, "prompts": (3072, 3072), "steps": 16,
                   "steps_after": 32, "s_max": 3200},
    "gemma2-9b": {"layers": 4, "prompts": (4608, 4608), "steps": 8,
                  "steps_after": 16, "s_max": 4672},
}
PACK_FLUSH_ROWS = (0, 1, 10 ** 6)


class FlashCalls:
    """Counts the model's attention calls by layer kind (a window: local)
    and query length, delegating to the real wrapper, whose own launch
    counter still counts (the spy sits on ``models.layers``' name, never
    on the kernel module's)."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.models import layers
        self._layers, self._real = layers, FA.flash_attention

        def spy(q, k, v, **kw):
            key = ("local" if kw.get("window") else "global", q.shape[1])
            self.calls[key] = self.calls.get(key, 0) + 1
            return self._real(q, k, v, **kw)
        layers.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self._layers.flash_attention = self._real


def counted_twin_run(dev, cfg, params, **run_kw) -> tuple:
    """``serve_recover.run`` at ``cfg`` over ``params`` (SERVE_SEED, the
    build directory for its arenas) under ``FlashCalls``; its pack_rows
    launches must equal its grouped gathers.  Returns (its numbers with
    the run's seconds, gathers, launches and peak memory, each prefill's
    tokens/s and each re-prefill group's seconds since the previous
    admission; the attention calls by (layer kind, query length))."""
    import torch
    from repro_torch.core.writeset import WriteSet
    from repro_torch.kernels import launch_counts
    from repro_torch.serve_recover import run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before, gathers0 = launch_counts(), WriteSet.gathers
    t0 = time.perf_counter()
    with FlashCalls() as spy:
        out = run(cfg, dev, seed=SERVE_SEED, params=params,
                  workdir=str(ROOT / "build"), **run_kw)
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    out["gathers"] = WriteSet.gathers - gathers0
    if out["launches"]["pack_rows"] != out["gathers"]:
        raise AssertionError(f"{cfg.name}: {out['launches']['pack_rows']} "
                             f"pack_rows launches for {out['gathers']} "
                             f"grouped gathers")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    for p in out["prefill"]:
        p["tokens_per_s"] = p["prefilled"] / p["seconds"]
    prev = 0.0
    for grp in sorted(out["groups"], key=lambda x: x["admitted_s"]):
        grp["seconds"] = grp["admitted_s"] - prev
        prev = grp["admitted_s"]
    out.pop("stats", None)
    out.pop("paging_stats", None)
    out["flash_calls"] = {f"{k[0]}:{k[1]}": v
                          for k, v in sorted(spy.calls.items())}
    return out, spy.calls


def check_flash_calls(cfg, out: dict, calls: dict, want: dict) -> None:
    """The attention calls by (layer kind, query length) must be ``want``,
    and the flash kernel launched once for each."""
    if calls != want:
        raise AssertionError(f"{cfg.name}: attention calls by (layer kind, "
                             f"length) {calls}, expected {want}")
    if out["launches"]["flash_attention"] != sum(want.values()):
        raise AssertionError(f"{cfg.name}: "
                             f"{out['launches']['flash_attention']} "
                             f"flash_attention launches for "
                             f"{sum(want.values())} attention calls")


def gemma_serve_one(dev, arch: str) -> dict:
    """Phase 15 for one arch: the twin protocol (``serve_recover.run``) at
    its published widths, f32, depth cut to GEMMA_SERVE's layers; every
    prefill (admissions and each re-prefill group) must launch the flash
    kernel once per layer, local and global alike."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.backbone import init_params, parse_tag
    spec = GEMMA_SERVE[arch]
    cfg = dataclasses.replace(registry.get(arch), n_layers=spec["layers"])
    pattern, n_super, rem = cfg.pattern_plan()
    tags = list(pattern) * n_super + list(rem)
    local = sum(parse_tag(t)[1] == "local" for t in tags)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out, calls = counted_twin_run(
        dev, cfg, params, prompt_lens=spec["prompts"], max_batch=2,
        s_max=spec["s_max"], steps=spec["steps"],
        steps_after=spec["steps_after"], max_requests=16)
    # admissions, on the engine and on its twin: each prompt and the new
    # request after recovery; then one prefill per re-prefill group; each
    # of every logged token but the last
    prefills = {}
    for n in list(spec["prompts"]) + [spec["prompts"][-1]]:
        prefills[n - 1] = prefills.get(n - 1, 0) + 2
    for grp in out["groups"]:
        prefills[grp["prefilled"]] = prefills.get(grp["prefilled"], 0) + 1
        grp["flash_launches"] = len(tags)
    want = {}
    for n, times in prefills.items():
        want[("local", n)] = local * times
        want[("global", n)] = (len(tags) - local) * times
    check_flash_calls(cfg, out, calls, {k: v for k, v in want.items() if v})
    del params
    torch.cuda.empty_cache()
    out.update({"init_params_s": init_s,
                "local_layers": local, "global_layers": len(tags) - local,
                "window": cfg.window, "attn_softcap": cfg.attn_softcap,
                "final_softcap": cfg.final_softcap,
                "head_dim": cfg.resolved_head_dim,
                "steps_before_crash": 2 * spec["steps"],
                "steps_after_crash": spec["steps_after"]})
    return out


def gemma_phase(dev) -> dict:
    """Phase 15: gemma3-27b and gemma2-9b served at full width through the
    twin protocol."""
    t0 = time.perf_counter()
    out = {arch: gemma_serve_one(dev, arch) for arch in GEMMA_SERVE}
    out["phase_s"] = time.perf_counter() - t0
    return out


def launch_serve(arch: str) -> dict:
    """``repro_torch.launch.serve --arch <arch> --crash`` on the card (its
    default device); rc 0 and a recovery required."""
    from repro_torch.launch import serve as tserve
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        rc = tserve.main(["--arch", arch, "--crash"])
    if rc != 0 or "[serve] recovered" not in said.getvalue():
        raise AssertionError(f"launch.serve --arch {arch} --crash on the "
                             f"card: rc {rc}")
    return {"arch": arch, "rc": rc, "seconds": time.perf_counter() - t0,
            "lines": len(said.getvalue().splitlines())}


def bf16_ckpt_card_vs_cpu(dev) -> list:
    """A TrainState whose moments are bf16 (``AdamWConfig(moment_dtype=
    "bfloat16")``), phase 4's small config, saved on the card and on the
    CPU under each policy: identical files (the reference's bf16 format:
    raw words, never quantized), and each restored on the card equal to
    what was saved."""
    import torch
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core import policy as pol
    small = ckpt_state(ckpt_config(small=True), torch.device("cpu"), seed=5)
    small = small._replace(
        mu=pol.tree_map(lambda t: t.to(torch.bfloat16), small.mu),
        nu=pol.tree_map(lambda t: t.to(torch.bfloat16), small.nu))
    small_dev = pol.tree_map(lambda t: t.to(dev), small)
    same = []
    for name in ("FULLY_PERSISTENT", "PARTLY_PERSISTENT", "PARTLY_Q8",
                 "PARTLY_DROP"):
        root = ROOT / "build" / "chip_smoke_bf16"
        out = {d: ckpt_files(st, getattr(pol, name), root / d)
               for d, st in (("cuda", small_dev), ("cpu", small))}
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"bf16 checkpoint {name}: card and CPU "
                                 f"files differ")
        back = CheckpointManager(str(root / "cuda"), getattr(
            pol, name)).restore(small, device=dev)
        for (path, a), (_, b) in zip(
                pol.tree_flatten_with_path(back.as_dict()),
                pol.tree_flatten_with_path(small.as_dict())):
            if a.dtype != b.dtype or (
                    path != ("rng",) and not (name == "PARTLY_DROP"
                                              and path[0] in ("mu", "nu"))
                    and not torch.equal(a.cpu(), b)):
                raise AssertionError(f"bf16 checkpoint {name}: restored "
                                     f"{'/'.join(path)} differs")
        same.append(f"ckpt_bf16.{name}:{len(out['cuda'])} files:"
                    f"{out['cuda']['manifest.json'][:12]}")
    shutil.rmtree(ROOT / "build" / "chip_smoke_bf16")
    return same


def pack_flush_rows_small(dev) -> list:
    """The reference's ``pack_flush_rows`` thresholds (0: its numpy
    gather; 1: every region through pack_rows; 10**6: none) on one arena
    and on four shards, card and CPU: one image and one FlushStats for all
    six runs of a shard count, and on the card one ``pack_rows`` launch
    per grouped gather at every threshold."""
    from repro_torch.core.writeset import WriteSet
    from repro_torch.interop import image_of
    from repro_torch.kernels import pack_flush
    same = []
    for n_shards in (1, SHARDS):
        seen = set()
        for rows in PACK_FLUSH_ROWS:
            for d in ("cuda", "cpu"):
                before = pack_flush.pack_rows.launches
                g0 = WriteSet.gathers
                r = workload("hashmap", "partly", PARITY_N, d, seed=3,
                             n_shards=n_shards, pack_flush_rows=rows)
                if d == "cuda" and pack_flush.pack_rows.launches - before \
                        != WriteSet.gathers - g0:
                    raise AssertionError(f"pack_flush_rows={rows}: launches "
                                         f"differ from gathers")
                seen.add((hashlib.sha256(image_of(r["arena"])).hexdigest(),
                          json.dumps(r["stats"], sort_keys=True)))
        if len(seen) != 1:
            raise AssertionError(f"pack_flush_rows at {n_shards} shards: "
                                 f"{len(seen)} different images or "
                                 f"FlushStats")
        same.append(f"hashmap.partly.shards_{n_shards}.pack_flush_rows_"
                    f"{'/'.join(map(str, PACK_FLUSH_ROWS))}:"
                    f"{next(iter(seen))[0][:12]}")
    return same


# ------------------------------------------------------------ hash probe

def hash32_np(x):
    """The reference's uint32 hash in numpy (uint32 products wrap)."""
    import numpy as np
    u = np.asarray(x).astype(np.uint32)
    u = (u ^ (u >> np.uint32(16))) * np.uint32(0x7FEB352D)
    u = (u ^ (u >> np.uint32(15))) * np.uint32(0x846CA68B)
    return u ^ (u >> np.uint32(16))


def zipf_ranks(rng, n: int, size: int, a: float = PROBE_ZIPF_A):
    """``size`` Zipf(a) ranks in [0, n): numpy's draws, those above n
    drawn again."""
    r = rng.zipf(a, size)
    while True:
        over = r > n
        if not over.any():
            return r - 1
        r[over] = rng.zipf(a, int(over.sum()))


def probe_inputs(nb: int = PROBE_BUCKETS, n_keys: int = PROBE_KEYS,
                 n_q: int = PROBE_QUERIES, seed: int = PROBE_SEED) -> dict:
    """Phase 8's table, queries and answers, on the host.  ``n_keys``
    distinct int32 keys (an odd multiplier mod 2**32 is a bijection; -1,
    the empty-lane value, left out) placed by ``hash32`` into the first
    free lanes of ``nb`` buckets of 128; ``n_q`` shuffled queries: half
    present keys, a quarter absent keys, a quarter negative ints, one in
    1024 of them -1 (which finds the first empty lane of its bucket).
    ``want`` is the numpy oracle built from the placement.  Also ``n_q``
    Zipf(PROBE_ZIPF_A) queries over the present keys (rank r is the r-th
    key made, so the hot keys land in random buckets), drawn by
    ``numpy.random.default_rng(seed)``, with their answers, and the bucket
    of the hottest key."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mult = np.uint64(2 * int(rng.integers(1 << 30, 1 << 31)) + 1)
    add = np.uint64(int(rng.integers(0, 1 << 32)))

    def images(lo: int, n: int):
        x = ((np.arange(lo, lo + n + 1, dtype=np.uint64) * mult + add)
             & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        return x[x != -1][:n]
    keys = images(0, n_keys)
    bucket = (hash32_np(keys) % np.uint32(nb)).astype(np.int64)
    order = np.argsort(bucket)          # any order within a bucket
    bs = bucket[order]
    fill = np.bincount(bucket, minlength=nb)
    lane = np.arange(n_keys) - (np.cumsum(fill) - fill)[bs]
    if int(fill.max()) > 128:
        raise AssertionError(f"a bucket overflows: {int(fill.max())} keys")
    table = np.full((nb, 128), -1, np.int32)
    placed = keys[order]
    table[bs, lane] = placed
    slot = (bs * 128 + lane).astype(np.int32)
    neg = rng.integers(-(1 << 31), 0, n_q // 4).astype(np.int32)
    neg[::1024] = -1
    queries = np.concatenate([
        keys[rng.integers(0, n_keys, n_q // 2)],
        images(n_keys + 1, n_q // 4), neg])[rng.permutation(n_q)]
    ks = np.argsort(placed)
    sk = placed[ks]
    pos = np.minimum(np.searchsorted(sk, queries), n_keys - 1)
    want = np.where(sk[pos] == queries, slot[ks][pos], -1).astype(np.int32)
    empty = queries == -1
    qb = (hash32_np(queries[empty]) % np.uint32(nb)).astype(np.int64)
    want[empty] = np.where(fill[qb] < 128, qb * 128 + fill[qb], -1)
    slot_of = np.empty(n_keys, np.int32)
    slot_of[order] = slot
    z = zipf_ranks(np.random.default_rng(seed), n_keys, n_q)
    return {"table": table, "queries": queries, "want": want,
            "max_fill": int(fill.max()), "mean_fill": float(fill.mean()),
            "found": int((want >= 0).sum()), "minus_one": int(empty.sum()),
            "zipf_queries": keys[z], "zipf_want": slot_of[z],
            "zipf_top_share": float(np.bincount(z).max() / n_q),
            "hot_bucket": int(bucket[0])}


def probe_bounds(bid, n_q: int, per_query: int = 12) -> dict:
    """Bytes once (each distinct row of ``bid`` read once, ``per_query``
    bytes of ids and answer per query) and the sector bound (one 512 B row
    per query), in ms at 3.35 TB/s."""
    import torch
    rows = int(torch.unique(bid).numel())
    return {"distinct_rows": rows,
            "bound_ms": bound_ms(512 * rows + per_query * n_q),
            "sector_bound_ms": bound_ms(n_q * (512 + per_query))}


def probe_stages(table, q, bid, flush, reps: int = 5) -> dict:
    """The grouped kernel's stages in ms from its %globaltimer stamps
    (block 0, at the start and after each barrier; a last barrier ends
    the gather), medians of ``reps`` launches with the L2 evicted, and
    each stage's share of their sum; ``bid`` None prices the hashed
    form."""
    import torch
    from repro_torch.kernels import hash_probe as H
    stamps = torch.zeros(H.STAMPS, dtype=torch.int64, device=q.device)
    names = ("zero", "count", "scan", "scatter", "probe", "gather")
    got = {name: [] for name in names}
    for _ in range(reps):
        flush()
        H._launch(table, q, bid, grouped=True, stamps=stamps)
        t = stamps.cpu().tolist()
        for k, name in enumerate(names):
            got[name].append((t[k + 1] - t[k]) / 1e6)
    ms = {name: statistics.median(v) for name, v in got.items()}
    total = sum(ms.values())
    return {"ms": ms, "stamped_ms": total,
            "share": {name: v / total for name, v in ms.items()}}


def probe_parity(dev, inp: dict, flush) -> dict:
    """Phase 2's probe.  Both kernels (grouped and query-major, each
    forced) and the dispatch of ``probe`` and ``probe_hashed``, exact
    against their plain versions on phase 8's table: uniform queries (and
    the same with bucket ids out of range in every 101st and 103rd lane),
    Zipf queries over the present keys, PROBE_ONE_BUCKET queries all in
    the hottest key's bucket (its keys, empty-lane -1s and absent ints),
    and the first 1, 31, 33 and 1024 queries (out-of-range ids among them).
    Uniform, Zipf and one-bucket timed with the L2 evicted beside the
    bytes-once and sector bounds, with the grouped kernel's stage shares;
    both kernels swept over PROBE_SWEEP_Q at PROBE_SWEEP_BUCKETS (the
    crossover GROUPED_MIN_QUERIES rests on).  Returns the kernels-line row
    under "row" and the rest."""
    import numpy as np
    import torch
    from repro_torch.kernels import hash_probe as H
    table = torch.from_numpy(inp["table"]).to(dev)
    nb = table.shape[0]

    def bucket(q):
        return (H.hash32(q) % nb).to(torch.int32)
    q = torch.from_numpy(inp["queries"]).to(dev)
    bid = bucket(q)
    bad = bid.clone()
    bad[::101] = nb + 5
    bad[1::103] = -3
    zq = torch.from_numpy(inp["zipf_queries"]).to(dev)
    zbid = bucket(zq)
    hot = inp["hot_bucket"]
    pool = np.concatenate([inp["table"][hot], np.array([-7, 123456789],
                                                       np.int32)])
    pick = np.random.default_rng(PROBE_SEED + 1).integers(
        0, pool.size, PROBE_ONE_BUCKET)
    oq = torch.from_numpy(pool[pick]).to(dev)
    obid = torch.full_like(oq, hot)
    cases = {"uniform": (q, bid), "out_of_range": (q, bad),
             "zipf": (zq, zbid), "one_bucket": (oq, obid)}
    for n in PROBE_SMALL_Q:
        cases[f"q{n}"] = (q[:n], bad[:n])
    hashed = {"uniform": q, "zipf": zq,
              **{f"q{n}": q[:n] for n in PROBE_SMALL_Q}}
    err, checked = 0.0, []
    for name, (cq, cb) in cases.items():
        want = H.probe_plain(table, cq, cb)
        err = max(err, require_equal(f"probe {name}", [
            (H._launch(table, cq, cb, grouped=True), want),
            (H._launch(table, cq, cb, grouped=False), want),
            (H.probe(table, cq, cb), want)]))
        checked.append(f"{name}:{cq.numel()}")
    for name, cq in hashed.items():
        want = H.probe_hashed_plain(table, cq)
        err = max(err, require_equal(f"probe_hashed {name}", [
            (H._launch(table, cq, None, grouped=True), want),
            (H._launch(table, cq, None, grouped=False), want),
            (H.probe_hashed(table, cq), want)]))
        checked.append(f"hashed_{name}:{cq.numel()}")
    timed = {}
    for name in ("uniform", "zipf", "one_bucket"):
        cq, cb = cases[name]
        timed[name] = {
            "ms": time_ms(lambda: H.probe(table, cq, cb), flush=flush),
            "query_major_ms": time_ms(
                lambda: H._launch(table, cq, cb, grouped=False),
                flush=flush),
            **probe_bounds(cb, cq.numel()),
            "stages": probe_stages(table, cq, cb, flush)}
    sweep = []
    gs = torch.Generator(device=dev)
    gs.manual_seed(PROBE_SEED)
    for sb in PROBE_SWEEP_BUCKETS:
        sub = table[:sb]
        for n in PROBE_SWEEP_Q:
            sq = q[:n]
            sbid = torch.randint(0, sb, (n,), dtype=torch.int32, device=dev,
                                 generator=gs)
            sweep.append({
                "buckets": sb, "queries": n,
                "grouped_ms": time_ms(
                    lambda: H._launch(sub, sq, sbid, grouped=True),
                    flush=flush),
                "query_major_ms": time_ms(
                    lambda: H._launch(sub, sq, sbid, grouped=False),
                    flush=flush)})
    u, z = timed["uniform"], timed["zipf"]
    row = {"ms": u["ms"],
           "plain_ms": time_ms(lambda: H.probe_plain(table, q, bid), reps=5),
           "library_ms": None, "bound_ms": u["bound_ms"],
           "sector_bound_ms": u["sector_bound_ms"],
           "distinct_rows": u["distinct_rows"],
           "query_major_ms": u["query_major_ms"], "zipf_ms": z["ms"],
           "zipf_bound_ms": z["bound_ms"], "max_abs_err": err,
           "shape": f"{q.numel()} int32 queries over ({nb}, 128) int32, "
                    f"mean load {inp['mean_fill']:.0f} of 128, uniform; "
                    f"Zipf({PROBE_ZIPF_A}) and one bucket in the report",
           "source": "src/repro_torch/csrc/hash_probe.cu",
           "replaces": "src/repro/kernels/hash_probe.py:55"}
    del table, q, bid, bad, zq, zbid, oq, obid, cases, hashed
    torch.cuda.empty_cache()
    return {"row": row, "checked": checked, "timed": timed, "sweep": sweep,
            "grouped_min_queries": H.GROUPED_MIN_QUERIES,
            "zipf_top_share": inp["zipf_top_share"]}


def probe_phase(dev, inp: dict) -> dict:
    """Phase 8: ``ops.hash_lookup`` over phase-8's table on the card, at
    the uniform and at the Zipf queries, each held against the numpy
    oracle and required to launch ``probe`` exactly once; returns its
    numbers and the launch counts of its run.  ``hash_lookup`` (uniform
    and Zipf), torch's ``hash32`` pass alone (the hashing the kernel took
    over, kept as a yardstick) and ``probe`` on precomputed buckets are
    timed under the same L2 eviction, and the grouped kernel's stages are
    priced in the hashed form."""
    import torch
    from repro_torch.kernels import (hash_probe, launch_counts, ops,
                                     reset_launch_counts)
    table = torch.from_numpy(inp["table"]).to(dev)
    queries = torch.from_numpy(inp["queries"]).to(dev)
    zq = torch.from_numpy(inp["zipf_queries"]).to(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    first_s = {}
    for name, qs, want in (("uniform", queries, inp["want"]),
                           ("zipf", zq, inp["zipf_want"])):
        before = hash_probe.probe.launches
        t0 = time.perf_counter()
        got = ops.hash_lookup(table, qs)
        torch.cuda.synchronize()
        first_s[name] = time.perf_counter() - t0
        bad = int((got.cpu().numpy() != want).sum())
        if bad:
            raise AssertionError(f"hash_lookup {name}: {bad} of "
                                 f"{qs.numel()} answers differ from the "
                                 f"oracle")
        if hash_probe.probe.launches - before != 1:
            raise AssertionError(
                f"hash_lookup {name}: {hash_probe.probe.launches - before} "
                f"probe launches, not 1")
    launches = launch_counts()
    nb = table.shape[0]

    def bucket_ids():
        return (ops.hash32(queries) % nb).to(torch.int32)
    bid = bucket_ids()
    zbid = (ops.hash32(zq) % nb).to(torch.int32)
    flush = l2_flusher(dev)
    n_q = queries.numel()
    out = {"buckets": nb, "table_bytes": table.numel() * 4,
           "keys": PROBE_KEYS, "queries": n_q,
           "mean_fill": inp["mean_fill"], "max_fill": inp["max_fill"],
           "found": inp["found"], "minus_one_queries": inp["minus_one"],
           "first_call_s": first_s,
           "hash_lookup_ms": time_ms(lambda: ops.hash_lookup(table, queries),
                                     flush=flush),
           "hash_lookup_zipf_ms": time_ms(lambda: ops.hash_lookup(table, zq),
                                          flush=flush),
           "hashing_ms": time_ms(bucket_ids, flush=flush),
           "probe_ms": time_ms(lambda: hash_probe.probe(table, queries, bid),
                               flush=flush),
           "hash_lookup_warm_ms": time_ms(lambda: ops.hash_lookup(table,
                                                                  queries)),
           # bytes once: queries read, answers written, each distinct row
           # read once; one row per query is the sector bound
           **probe_bounds(bid, n_q, per_query=8),
           "zipf": probe_bounds(zbid, n_q, per_query=8),
           "stages": probe_stages(table, queries, None, flush),
           "zipf_stages": probe_stages(table, zq, None, flush),
           "launches": launches}
    del table, queries, zq, got, bid, zbid
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------- feature store

def feature_small(mode: str, journal: bool, device) -> tuple:
    """Phase 4's feature-store run: 48 requests of 8 keys (of 256), a torn
    crash in the 49th, recovery, a replay of all 64; the image's sha256,
    the FlushStats and every key's vector."""
    from repro_torch.feature_recover import requests
    from repro_torch.interop import image_of
    from repro_torch.serve.feature_store import FeatureConfig, FeatureStore
    import numpy as np
    fs = FeatureStore(FeatureConfig(n_keys=256, dim=4, n_samples=1024,
                                    mode=mode, journal=journal),
                      device=device)
    ops = requests(64, 8, 256, 4, seed=3)
    for op in ops[:48]:
        fs.apply(*op)
    fs.apply(*ops[48], _torn_crash=True)
    fs.recover()
    for op in ops:
        fs.apply(*op)
    return (hashlib.sha256(image_of(fs.arena)).hexdigest(),
            dataclasses.asdict(fs.arena.stats),
            fs.lookup(np.arange(256)).cpu().numpy().tolist())


def index_small(device) -> tuple:
    """Phase 4's sample-index run: 3 adds of 1000 ids, crash, recover,
    a lookup of every id; the image's sha256, FlushStats and answers."""
    import numpy as np
    from repro_torch.data.index import SampleIndex
    from repro_torch.interop import image_of
    rng = np.random.default_rng(3)
    idx = SampleIndex(None, 4096, device=device)
    for _ in range(3):
        ids = rng.choice(8192, 1000, replace=False).astype(np.int64)
        idx.add(ids, ids % 7, ids * 64, rng.integers(1, 99, 1000))
    idx.arena.crash()
    idx.recover()
    got = [t.cpu().numpy().tolist() for t in idx.lookup(np.arange(8192))]
    return (hashlib.sha256(image_of(idx.arena)).hexdigest(),
            dataclasses.asdict(idx.arena.stats), got)


def ops_small(device) -> list:
    """Phase 4's ``ops.pack_rows``/``scatter_rows`` at D = 100 (padded to
    128) and 256, f32, on ``device``; host copies of the results."""
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator()
    g.manual_seed(3)
    out = []
    for d in (100, 256):
        src = torch.randn((300, d), generator=g).to(device)
        idx = torch.randperm(300, generator=g)[:64].to(torch.int32)
        idx[::9] = -1
        idx = idx.to(device)
        packed = ops.pack_rows(src, idx)
        out += [packed.cpu(), ops.scatter_rows(src, packed * 2, idx).cpu()]
    return out


def feature_phase(dev) -> dict:
    """Phase 9: the feature store at real size, journal on: the twin
    protocol with a torn crash at request FS_CRASH_AT; then a SampleIndex
    of INDEX_N ids, one add, crash, recover, lookups.  Returns its numbers
    and the launch counts of its run."""
    import numpy as np
    import torch
    from repro_torch.data.index import SampleIndex
    from repro_torch.feature_recover import requests, twin
    from repro_torch.core.writeset import WriteSet
    from repro_torch.kernels import (launch_counts, launch_sizes,
                                     reset_launch_counts)
    from repro_torch.serve.feature_store import FeatureConfig
    cfg = FeatureConfig(**FS_CONFIG, mode="partly", journal=True)
    ops = requests(FS_REQUESTS, FS_KEYS_PER_REQUEST, FS_KEY_SPACE, cfg.dim,
                   seed=FS_SEED)
    reset_launch_counts()
    WriteSet.gathers = 0
    t0 = time.perf_counter()
    out = twin(cfg, ops, FS_CRASH_AT, torn=True, device=dev)
    out["twin_protocol_s"] = time.perf_counter() - t0
    st = out["stats"]
    if out["refused"] != FS_CRASH_AT or \
            not 0 < st["journal_lines"] <= st["epochs"]:
        raise AssertionError(f"feature store: refused {out['refused']}, "
                             f"journal lines {st['journal_lines']} over "
                             f"{st['epochs']} epochs")
    ids = np.arange(INDEX_N, dtype=np.int64)
    t0 = time.perf_counter()
    idx = SampleIndex(None, INDEX_N, device=dev)
    idx.add(ids, ids % 7, ids * 64, np.full(INDEX_N, 64, np.int64))
    torch.cuda.synchronize()
    out["index_add_s"] = time.perf_counter() - t0
    idx.arena.crash()
    out["index_recover_s"] = idx.recover()
    ok, shard, off, ln = idx.lookup(ids[::13])
    if not (bool(ok.all())
            and np.array_equal(shard.cpu().numpy(), ids[::13] % 7)
            and np.array_equal(off.cpu().numpy(), ids[::13] * 64)
            and bool((ln == 64).all())):
        raise AssertionError("sample index: recovered lookups differ")
    out["index_stages"] = {s.name: s.seconds
                           for s in idx.last_recovery.stages}
    out["launches"], out["launch_sizes"] = launch_counts(), launch_sizes()
    out["gathers"] = gathers_check("feature_store", out["launches"],
                                   WriteSet.gathers)
    for k in ("pack_rows", "jump_double"):
        if out["launches"][k] == 0:
            raise AssertionError(f"phase 9 never launched {k}")
    out.update(requests=FS_REQUESTS, keys_per_request=FS_KEYS_PER_REQUEST,
               key_space=FS_KEY_SPACE, crash_at=FS_CRASH_AT,
               index_ids=INDEX_N, **FS_CONFIG)
    del idx
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- integrity

INTEG_N = {"dll": 1 << 22, "hashmap": 1 << 22, "bptree": 1 << 17}
MIXED_NAMES = {"dll": "dll", "bptree": "bt", "hashmap": "hm"}  # layout order
MIXED_REGION = {"dll": "dll.nodes", "bptree": "bt.nodes",
                "hashmap": "hm.entries"}
INTEG_GATE = 0.95              # the reference's integrity-overhead gate
GATE_OPS, GATE_EPOCH, GATE_REPEATS = 30000, 1024, 7
FS11_REQUESTS = 64             # phase 11's feature-store requests
# steps recorded: cut from 4096, the catalog's default capacity, when
# phase 20 came (recording took 15.6 s of a 957.6 s run on an NVIDIA H100
# 80GB HBM3 at 700 W)
CATALOG_STEPS = 1024
CHAIN_KERNELS = ("jump_double", "gather_next", "walk_segments",
                 "expand_segments")


@contextlib.contextmanager
def integrity_default():
    """Inside the block ``REPRO_INTEGRITY`` is unset, so integrity resolves
    on, the default of both packages; the pin the other phases keep comes
    back after it."""
    saved = os.environ.pop("REPRO_INTEGRITY", None)
    try:
        yield
    finally:
        if saved is not None:
            os.environ["REPRO_INTEGRITY"] = saved


def no_timing(report) -> dict:
    """A RecoveryReport as a dict without its timing fields."""
    d = report.as_dict()
    return {**{k: v for k, v in d.items() if k not in TIMING},
            "stages": [{k: v for k, v in st.items() if k not in TIMING
                        and not k.endswith("admission_s")}
                       for st in d["stages"]]}


def scrub_rows(a) -> dict:
    return {k: v.tolist() for k, v in a.scrub().items()}


def build_mixed(mode: str, sizes: dict, device, integrity=None,
                n_shards: int = 1, commit_mode: str = "barrier"):
    """The reference's mixed arena (``examples/salvage_recovery.py``): a DLL,
    a B+Tree and a hashmap on ONE arena (of ``n_shards`` shards), order
    snapshots and integrity at their defaults unless ``integrity`` pins
    it."""
    from repro_torch.core.arena import open_arena
    from repro_torch.pstruct.bptree import BPTree
    from repro_torch.pstruct.dll import DoublyLinkedList
    from repro_torch.pstruct.hashmap import Hashmap
    n_d, n_b, n_h = sizes["dll"], sizes["bptree"], sizes["hashmap"]
    layout = {}
    layout.update(DoublyLinkedList.layout(n_d, mode, name="dll"))
    layout.update(BPTree.layout(n_b, 2 * n_b, mode, name="bt"))
    layout.update(Hashmap.layout(n_h, mode, name="hm"))
    a = open_arena(None, layout, device=device, integrity=integrity,
                   n_shards=n_shards, commit_mode=commit_mode)
    return a, {"dll": DoublyLinkedList(a, n_d, mode, name="dll"),
               "bptree": BPTree(a, n_b, 2 * n_b, mode, name="bt"),
               "hashmap": Hashmap(a, n_h, mode, name="hm")}


def mixed_workload(mode: str, sizes: dict, device, integrity=None,
                   seed: int = 0, n_shards: int = 1,
                   commit_mode: str = "barrier") -> dict:
    """Phase 3's operations for each structure of a mixed arena in turn
    (insert in batches of 8192, delete 1/8, the DLL also pops), each
    structure's seconds and FlushStats delta apart, then one commit.
    Returns the arena, the structures and what each must recover to."""
    import numpy as np
    import torch
    a, structs = build_mixed(mode, sizes, device, integrity, n_shards,
                             commit_mode)
    sync = torch.cuda.synchronize if a.device.type == "cuda" else (
        lambda: None)
    runs, want = {}, {}
    for kind in KINDS:
        n, s = sizes[kind], structs[kind]
        _, keys, vals, gone = _inputs(kind, n, seed)
        s0 = a.stats.snapshot()
        t0 = time.perf_counter()
        _fill(kind, a, s, keys, vals)
        sync()
        t_insert = time.perf_counter() - t0
        t0 = time.perf_counter()
        pops = _thin(kind, s, keys, gone)
        sync()
        runs[kind] = {"insert_s": t_insert,
                      "delete_s": time.perf_counter() - t0,
                      "stats": dataclasses.asdict(a.stats.delta(s0))}
        live = np.ones(n, bool)
        live[gone] = False
        want[kind] = {"order": np.flatnonzero(live)[pops:],
                      "keys": keys[live], "vals": vals[live],
                      "gone": keys[gone]}
    a.commit()
    return {"arena": a, "structs": structs, "runs": runs, "want": want}


def fault_rows(structs, want: dict, pos: int, stuck_pos: int) -> dict:
    """The committed rows phase 11 (and phase 4's mixed case) corrupt: the
    DLL node at chain position ``pos`` (flip) and at ``stuck_pos`` (stuck
    line), the hashmap entry of one live key, the B+Tree's second leaf."""
    import torch
    order = want["dll"]["order"]
    h = structs["hashmap"]
    key = int(want["hashmap"]["keys"][len(want["hashmap"]["keys"]) // 3])
    slot = int(h._find_slots(torch.tensor([key], device=h.arena.device))[0])
    return {"dll": int(order[pos]), "dll_stuck": int(order[stuck_pos]),
            "hashmap": slot, "hm_key": key,
            "bptree": int(structs["bptree"].leaves()[1])}


def inject(a, rows: dict, which=("dll", "hashmap", "bptree")) -> dict:
    """Flip one bit in each chosen row (stuck line on ``dll_stuck``);
    returns the scrub the faults must give."""
    from repro_torch.core import faultinject as fi
    bad = {}
    for kind in which:
        fi.flip_bits(a, MIXED_REGION[kind], rows[kind], byte=8, mask=0x40)
        bad.setdefault(MIXED_REGION[kind], set()).add(rows[kind])
    if "dll" in which:
        fi.stuck_line(a, MIXED_REGION["dll"], rows["dll_stuck"], line=0,
                      value=0xA5)
        bad[MIXED_REGION["dll"]].add(rows["dll_stuck"])
    order = list(a.regions)             # scrub's order: the declaration
    return {r: sorted(v) for r, v in sorted(
        bad.items(), key=lambda kv: order.index(kv[0]))}


def salvage_recover(a, structs):
    from repro_torch.core.recovery import RecoveryManager
    mgr = RecoveryManager(a)
    for kind in ("dll", "bptree", "hashmap"):
        mgr.add(MIXED_NAMES[kind], f"pstruct.{kind}", structs[kind])
    t0 = time.perf_counter()
    rep = mgr.recover(salvage=True)
    if a.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    return rep, time.perf_counter() - t0


def check_exact(kind: str, s, want: dict, label: str) -> None:
    _check(kind, label, s, want["order"], want["keys"], want["vals"],
           want["gone"])


def check_salvaged(structs, want: dict, rows: dict, pos: int,
                   bt_keys, label: str, faulted=("dll", "hashmap",
                                                  "bptree")) -> dict:
    """What a salvage recovery must give: the DLL's pre-crash order cut at
    the first bad node, the hashmap missing exactly the flipped entry's
    key (named in ``quarantined``), the B+Tree's survivors a subset of its
    pre-crash keys disjoint from its quarantined keys; an unfaulted
    structure recovers exactly."""
    import numpy as np
    for kind in ("dll", "hashmap", "bptree"):
        if kind not in faulted:
            check_exact(kind, structs[kind], want[kind], label)
    out = {}
    if "dll" in faulted:
        d = structs["dll"]
        got = d.to_list().cpu().numpy()
        if d.count != pos or not np.array_equal(got,
                                                want["dll"]["order"][:pos]):
            raise AssertionError(f"{label}: the DLL is not its pre-crash "
                                 f"order cut at position {pos}")
        out["dll_count"] = d.count
    if "hashmap" in faulted:
        h = structs["hashmap"]
        key = rows["hm_key"]
        if h.quarantined != {key}:
            raise AssertionError(f"{label}: hashmap quarantined "
                                 f"{sorted(h.quarantined)[:8]}, not {key}")
        keys, vals = want["hashmap"]["keys"], want["hashmap"]["vals"]
        other = keys != key
        ok, got = h.find_batch(keys[other])
        if not bool(ok.all()) or not np.array_equal(got.cpu().numpy(),
                                                    vals[other]):
            raise AssertionError(f"{label}: hashmap lost other keys")
        ok, _ = h.find_batch(np.array([key], np.int64))
        if bool(ok.any()):
            raise AssertionError(f"{label}: the quarantined key is found")
        out["hm_quarantined"] = sorted(h.quarantined)
    if "bptree" in faulted:
        t = structs["bptree"]
        got = set(t.keys_in_order().cpu().numpy().tolist())
        if not got <= set(bt_keys) or not got.isdisjoint(t.quarantined):
            raise AssertionError(f"{label}: B+Tree survivors are not a "
                                 f"subset disjoint from quarantined")
        if not t.quarantined:
            raise AssertionError(f"{label}: the B+Tree named no keys")
        out.update(bt_survivors=len(got), bt_quarantined=len(t.quarantined))
    return out


def integrity_small(kind: str, mode: str, device) -> tuple:
    """Phase 4's integrity case for one structure: the quickstart workload
    at PARITY_N with integrity on; then a crash, one flipped committed row
    (DLL: position n/4; hashmap: slab row 7; B+Tree: the second leaf),
    scrub and a salvage recovery.  Returns the image's sha256, the
    FlushStats, the scrub, the salvage report without timing and the
    recovered state's digest."""
    from repro_torch.core import faultinject as fi
    from repro_torch.core.recovery import RecoveryManager
    from repro_torch.interop import image_of
    r = workload(kind, mode, PARITY_N, device, seed=3, integrity=True)
    a, s = r["arena"], r["structure"]
    image = hashlib.sha256(image_of(a)).hexdigest()
    if kind == "dll":
        region, row = s.nodes, int(s.to_list()[PARITY_N // 4])
    elif kind == "hashmap":
        region, row = s.entries, 7
    else:
        region, row = s.nodes, int(s.leaves()[1])
    a.crash()
    fi.flip_bits(a, region, row, byte=8, mask=0x40)
    bad = scrub_rows(a)
    rep = RecoveryManager(a).add(kind, f"pstruct.{kind}", s).recover(
        salvage=True)
    return (image, r["stats"], bad, no_timing(rep), state_digest(kind, s))


def state_digest(kind: str, s) -> str:
    """sha256 of a structure's recovered logical state (and quarantine)."""
    import numpy as np
    h = hashlib.sha256()
    if kind == "dll":
        h.update(s.to_list().cpu().numpy().tobytes())
    elif kind == "bptree":
        h.update(s.keys_in_order().cpu().numpy().tobytes())
    else:
        keys = s.keys.cpu().numpy()
        h.update(np.sort(keys).tobytes())
        h.update(s.values.cpu().numpy()[np.argsort(keys)].tobytes())
    h.update(repr(sorted(getattr(s, "quarantined", ()))).encode())
    return h.hexdigest()


def mixed_small(mode: str, device) -> tuple:
    """Phase 4's mixed case: the three structures on one arena at PARITY_N
    (B+Tree PARITY_N / 4), integrity and snapshots on; crash, faults in
    each (as phase 11), scrub, salvage recovery.  Returns the image's
    sha256, FlushStats, scrub, report without timing and state digests."""
    from repro_torch.interop import image_of
    sizes = {"dll": PARITY_N, "hashmap": PARITY_N, "bptree": PARITY_N >> 2}
    w = mixed_workload(mode, sizes, device, integrity=True, seed=3)
    a, structs = w["arena"], w["structs"]
    image = hashlib.sha256(image_of(a)).hexdigest()
    rows = fault_rows(structs, w["want"], PARITY_N // 4, PARITY_N // 2)
    a.crash()
    inject(a, rows)
    bad = scrub_rows(a)
    rep, _ = salvage_recover(a, structs)
    return (image, dataclasses.asdict(a.stats), bad, no_timing(rep),
            [state_digest(k, structs[k]) for k in KINDS])


def drain_gate(dev) -> dict:
    """The reference's integrity-overhead gate on the card
    (``benchmarks/recovery_bench.py`` ``integrity_overhead_report``):
    GATE_OPS hashmap inserts, partly, in epochs of GATE_EPOCH rows, then a
    commit, integrity off and on interleaved, best of GATE_REPEATS; the
    persisted-line throughput (data + snapshot + journal + sidecar lines
    per second of drain) on over off, beside INTEG_GATE.  No synthetic
    line latency: the card's own drain."""
    import numpy as np
    import torch
    from repro_torch.core.arena import open_arena
    from repro_torch.pstruct.hashmap import Hashmap
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1 << 40, (4096, 7)).astype(np.int64)
    keys = rng.permutation(2 * GATE_OPS).astype(np.int64)

    def one_pass(integ: bool) -> dict:
        a = open_arena(None, Hashmap.layout(GATE_OPS + 1024, "partly"),
                       device=dev, integrity=integ)
        s = Hashmap(a, GATE_OPS + 1024, "partly")
        s0 = a.stats.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, GATE_OPS, GATE_EPOCH):
            m = min(GATE_EPOCH, GATE_OPS - i)
            s.insert_batch(keys[i:i + m], vals[:m])
        a.commit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = a.stats.delta(s0)
        t0 = time.perf_counter()
        if a.scrub():
            raise AssertionError("gate: a clean arena failed its scrub")
        persisted = (d.lines + d.snapshot_lines + d.journal_lines
                     + d.integrity_lines)
        return {"integrity": integ, "flush_wall_s": wall,
                "lines": d.lines, "bytes": d.bytes,
                "integrity_lines": d.integrity_lines,
                "persisted_lines": persisted,
                "lines_per_s": persisted / wall,
                "data_lines_per_s": d.lines / wall,
                "scrub_s": time.perf_counter() - t0}

    best = {}
    for _ in range(GATE_REPEATS):
        for integ in (False, True):
            r = one_pass(integ)
            if integ not in best or \
                    r["flush_wall_s"] < best[integ]["flush_wall_s"]:
                best[integ] = r
    on, off = best[True], best[False]
    if (on["lines"], on["bytes"]) != (off["lines"], off["bytes"]) or \
            not on["integrity_lines"] > 0 == off["integrity_lines"]:
        raise AssertionError(f"gate: data ledgers differ: {on} {off}")
    return {"on": on, "off": off, "gate": INTEG_GATE,
            "lines_per_s_ratio": on["lines_per_s"] / off["lines_per_s"],
            "data_lines_per_s_ratio":
                on["data_lines_per_s"] / off["data_lines_per_s"]}


def integrity_drains(dev, phase3: dict) -> dict:
    """Phase 11's drains: phase 3's workload (DLL and hashmap at 2**22, the
    B+Tree at 2**17), both modes, integrity on and snapshots off, each on
    its own arena.  lines, bytes and calls must equal the integrity-off run
    of the same operations (phase 3's for the DLL and the hashmap; for the
    B+Tree an integrity-off run here), integrity_lines be > 0, and a clean
    scrub of each committed image return {}.  Returns each run's numbers
    beside its integrity-off twin's, and the persisted-line throughput
    ratio, on over off; and ``keep``: the full-mode B+Tree's arena and
    tree, for ``full_mode_and_fatal``."""
    import torch
    rows, keep = [], None
    for kind in KINDS:
        for mode in ("full", "partly"):
            n = INTEG_N[kind]
            r = workload(kind, mode, n, dev, integrity=True)
            a = r.pop("arena")
            t = r.pop("structure")
            if (kind, mode) == ("bptree", "full"):
                keep = (a, t)
            t0 = time.perf_counter()
            bad = a.scrub()
            scrub_s = time.perf_counter() - t0
            if bad:
                raise AssertionError(f"{kind} {mode}: a clean scrub named "
                                     f"{ {k: v[:4] for k, v in bad.items()} }")
            del a, t
            torch.cuda.empty_cache()
            off = phase3.get((kind, mode))
            if off is None or off["n"] != n:
                off = workload(kind, mode, n, dev, integrity=False)
                del off["arena"], off["structure"]
                torch.cuda.empty_cache()
            on_st, off_st = r["stats"], off["stats"]
            if any(on_st[k] != off_st[k] for k in ("lines", "bytes",
                                                   "calls")) or \
                    on_st["integrity_lines"] <= 0:
                raise AssertionError(f"{kind} {mode}: integrity-on ledgers "
                                     f"{on_st} against off {off_st}")
            drain_on = r["insert_s"] + r["delete_s"]
            drain_off = off["insert_s"] + off["delete_s"]
            on_lines = sum(on_st[k] for k in ("lines", "snapshot_lines",
                                              "journal_lines",
                                              "integrity_lines"))
            rows.append({
                "kind": kind, "mode": mode, "n": n,
                "lines": on_st["lines"], "bytes": on_st["bytes"],
                "calls": on_st["calls"],
                "integrity_lines": on_st["integrity_lines"],
                "insert_s": r["insert_s"], "delete_s": r["delete_s"],
                "recover_s": r["recover_s"],
                "off_insert_s": off["insert_s"],
                "off_delete_s": off["delete_s"],
                "off_from": "phase 3" if (kind, mode) in phase3
                and phase3[kind, mode]["n"] == n else "phase 11",
                "scrub_s": scrub_s,
                "lines_per_s_ratio": (on_lines / drain_on)
                / (off_st["lines"] / drain_off),
                "gate": INTEG_GATE})
    return {"rows": rows, "keep": keep}


def full_mode_and_fatal(dev, a, t) -> dict:
    """The full-mode B+Tree of phase 11's drains (arena ``a``, tree ``t``,
    committed) quarantines wholesale, and a stage that depends on it
    reports ``skipped``; then the fatal cases: a corrupt header is
    ``ManifestError`` even under salvage, and a truncated backing file is
    ``ShardLossError`` at open."""
    import numpy as np
    from repro_torch.core import faultinject as fi
    from repro_torch.core.arena import (ManifestError, ShardLossError,
                                        open_arena)
    from repro_torch.core.recovery import RecoveryManager
    from repro_torch.pstruct.dll import DoublyLinkedList
    da, d = build_structure("dll", "full", 4096, dev, integrity=True)
    d.append_batch(np.ones((64, 7), np.int64))
    da.commit()
    leaf = int(t.leaves()[0])
    a.crash()
    da.crash()
    fi.flip_bits(a, t.nodes, leaf, byte=8, mask=0x40)
    mgr = RecoveryManager(a, da)
    mgr.add("bt", "pstruct.bptree", t)
    mgr.add("dll", "pstruct.dll", d, depends=("bt",))
    rep = mgr.recover(salvage=True)
    st = {s.name: s for s in rep.stages}
    if rep.quarantined != ["bt"] or rep.degraded != ["dll"] or \
            st["dll"].detail.get("skipped") != "quarantined dependency" or \
            st["bt"].detail.get("error") != "CorruptLineError":
        raise AssertionError(f"full mode: {no_timing(rep)}")
    out = {"quarantined": rep.quarantined, "degraded": rep.degraded,
           "bt_error": st["bt"].detail["error"],
           "dll_detail": st["dll"].detail}
    fi.corrupt_header(a)
    try:
        RecoveryManager(a).add("bt", "pstruct.bptree", t).recover(
            salvage=True)
        raise AssertionError("a corrupt header recovered")
    except ManifestError as e:
        out["manifest_error"] = str(e)
    path = ROOT / "build" / "chip_smoke_integrity" / "lost.arena"
    shutil.rmtree(path.parent, ignore_errors=True)
    path.parent.mkdir(parents=True)
    layout = DoublyLinkedList.layout(4096, "partly", snapshot=False)
    b = open_arena(str(path), layout, device=dev)
    DoublyLinkedList(b, 4096, "partly", snapshot=False).append_batch(
        np.ones((64, 7), np.int64))
    b.commit()
    b.close()
    fi.truncate_shard(b, 0, 4096)
    try:
        open_arena(str(path), layout, device=dev)
        raise AssertionError("a truncated arena opened")
    except ShardLossError as e:
        out["shard_loss_error"] = str(e)
    shutil.rmtree(path.parent)
    return out


def feature_salvage(dev) -> dict:
    """Phase 9's FeatureConfig (n_keys 2**22), integrity on: FS11_REQUESTS
    requests beside an uninterrupted twin; crash, flip a VALUE word of one
    key's table row, salvage recovery: exactly that key is refused
    (``QuarantinedError``) until ``readmit``, then applies; every other
    key's effects equal the twin's."""
    import numpy as np
    import torch
    from repro_torch.core import faultinject as fi
    from repro_torch.core.arena import QuarantinedError
    from repro_torch.feature_recover import requests, run_twin
    from repro_torch.serve.feature_store import FeatureConfig, FeatureStore
    cfg = FeatureConfig(**FS_CONFIG, mode="partly", journal=True)
    ops = requests(FS11_REQUESTS, FS_KEYS_PER_REQUEST, FS_KEY_SPACE,
                   cfg.dim, seed=FS_SEED)
    want = run_twin(cfg, ops, dev)
    fs = FeatureStore(cfg, device=dev)
    for op in ops:
        fs.apply(*op)
    key = int(ops[0][1][0])
    slot = int(fs.table._find_slots(torch.tensor([key], device=dev))[0])
    fs.crash()
    fi.flip_bits(fs.arena, fs.arena.regions["emb.entries"], slot,
                 byte=16, mask=0x20)          # a VALUE word: key readable
    t0 = time.perf_counter()
    rep = fs.recover(salvage=True)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    if fs.quarantined_keys != {key}:
        raise AssertionError(f"feature store quarantined "
                             f"{sorted(fs.quarantined_keys)[:8]}, not {key}")
    for call in (lambda: fs.lookup(np.array([key], np.int64)),
                 lambda: fs.apply(10 ** 6, np.array([key], np.int64),
                                  np.ones((1, cfg.dim), np.int64))):
        try:
            call()
            raise AssertionError("a quarantined key was served")
        except QuarantinedError:
            pass
    others = np.setdiff1d(np.arange(cfg.n_keys), [key])
    got = fs.lookup(others).cpu().numpy()
    if not np.array_equal(got, want["effects"]["vectors"][others]):
        raise AssertionError("feature store: other keys' vectors differ "
                             "from the twin's")
    counts = fs.counts.cpu().numpy()
    tw = want["effects"]["counts"]
    keep = np.ones(cfg.n_keys, bool)
    keep[slot] = False
    if not np.array_equal(counts[keep], tw[keep]) or \
            fs.next_sample != want["effects"]["next_sample"] or \
            fs.journal.classify() != want["effects"]["classify"]:
        raise AssertionError("feature store: counts, cursor or journal "
                             "differ from the twin's")
    fs.readmit([key])
    if not fs.apply(10 ** 6, np.array([key], np.int64),
                    np.ones((1, cfg.dim), np.int64)):
        raise AssertionError("a readmitted key did not apply")
    return {"key": key, "recover_s": recover_s,
            "stages": {s.name: s.seconds for s in rep.stages},
            "degraded": rep.degraded, "quarantined": rep.quarantined,
            "requests": FS11_REQUESTS,
            "store_detail": {k: v for k, v in rep.stage("store").detail
                             .items() if k != "quarantined_keys"}}


def engine_salvage(dev) -> dict:
    """Phase 4's engine (llama3.2-3b at full width, 2 layers, f32) on the
    card beside an uninterrupted twin, three requests, 4 steps; the
    crashed engine's token-log row of request 0 flipped, salvage recovery:
    rid 0 is refused (``QuarantinedError``) until ``readmit``, the other
    requests' logits stay within 1e-4 of the twin's for 4 more steps."""
    import torch
    from repro_torch.core import faultinject as fi
    from repro_torch.core.arena import QuarantinedError
    from repro_torch.core.policy import tree_map
    from repro_torch.models.backbone import init_params
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import EngineConfig, ServingEngine
    from repro_torch.serve_recover import LOGIT_TOL, prompts_for
    cfg = serve_config(layers=2)
    gen = torch.Generator()
    gen.manual_seed(SERVE_SEED)
    params = tree_map(lambda t: t.to(dev), init_params(cfg, gen, "cpu"))
    model = Model(cfg, compute_dtype=torch.float32)
    base = ROOT / "build" / "chip_smoke_engine_salvage"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    prompts = prompts_for((12, 7, 9), cfg.vocab, SERVE_SEED)
    engs = [ServingEngine(model, params, EngineConfig(max_batch=3, s_max=64),
                          arena_path=str(base / name), device=dev)
            for name in ("crashed", "twin")]
    for e in engs:
        for rid, p in enumerate(prompts):
            e.add_request(rid, p)
        for _ in range(4):
            e.step()
    eng, twin = engs
    eng.crash()
    slot = int(list(twin.slot_rid).index(0))   # the twins seat alike
    fi.flip_bits(eng.arena, eng.arena.regions["tokens"], slot, byte=4,
                 mask=0x10)
    t0 = time.perf_counter()
    eng.recover(salvage=True)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    if eng.quarantined_rids != {0}:
        raise AssertionError(f"engine quarantined {eng.quarantined_rids}")
    try:
        eng.add_request(0, prompts[0])
        raise AssertionError("a quarantined rid was admitted")
    except QuarantinedError:
        pass
    worst = 0.0
    for _ in range(4):
        got, want = eng.step(), twin.step()
        if set(got) != {1, 2} or any(got[r] != want[r] for r in got):
            raise AssertionError(f"engine after salvage served {got}, the "
                                 f"twin {want}")
        for r in got:
            a, b = eng.step_logits[r].cpu(), twin.step_logits[r].cpu()
            worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    if worst > LOGIT_TOL:
        raise AssertionError(f"engine after salvage: logits {worst} from "
                             f"the twin's")
    eng.readmit([0])
    if eng.quarantined_rids or eng.journal.state_of(0) != "completed":
        raise AssertionError("readmit left rid 0 open")
    st = eng.last_recovery.stage("engine")
    shutil.rmtree(base)
    return {"recover_s": recover_s, "logit_rel_err": worst,
            "engine_detail": {k: v for k, v in st.detail.items()
                              if not k.endswith("admission_s")},
            "stages": {s.name: s.seconds for s in eng.last_recovery.stages}}


def catalog_phase(dev) -> dict:
    """``CheckpointCatalog`` at its default capacity (4096) with its
    default integrity: record CATALOG_STEPS steps (1024), crash, reopen;
    ``steps()`` and ``latest()`` must equal the pre-crash values."""
    import numpy as np
    import torch
    from repro_torch.ckpt import CheckpointCatalog
    path = ROOT / "build" / "chip_smoke_catalog" / "cat.arena"
    shutil.rmtree(path.parent, ignore_errors=True)
    path.parent.mkdir(parents=True)
    cat = CheckpointCatalog(str(path), device=dev)
    if not cat.arena.integrity:
        raise AssertionError("the catalog opened without integrity")
    steps = np.arange(1, CATALOG_STEPS + 1) * 10
    t0 = time.perf_counter()
    for s in steps.tolist():
        cat.record(s, s // 10, 1000 * s, 5)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    before = (cat.steps().tolist(), cat.latest())
    cat.arena.crash()
    t0 = time.perf_counter()
    cat2 = CheckpointCatalog(str(path), device=dev)
    reopen_s = time.perf_counter() - t0
    after = (cat2.steps().tolist(), cat2.latest())
    if after != before or before[0] != steps.tolist():
        raise AssertionError("catalog: steps()/latest() differ after the "
                             "crash")
    out = {"steps": CATALOG_STEPS, "record_s": record_s,
           "reopen_s": reopen_s, "latest": list(after[1]),
           "integrity_lines": cat.arena.stats.integrity_lines,
           "scrub": scrub_rows(cat2.arena)}
    shutil.rmtree(path.parent)
    if out["scrub"]:
        raise AssertionError(f"catalog: scrub named {out['scrub']}")
    return out


def integrity_phase(dev, phase3: dict) -> dict:
    """Phase 11: integrity and salvage at the main path's size, with
    integrity resolved on by default.  The drains against phase 3's
    ledgers, the reference's gate, clean scrubs, then on a mixed arena
    (DLL and hashmap 2**22, B+Tree 2**17, partly, snapshots on) a clean
    recovery, a B+Tree-only fault and faults in all three, each named
    exactly by scrub and salvaged; full mode and the fatal cases; the
    feature store, the engine and the catalog."""
    import torch
    from repro_torch.core import faultinject as fi
    from repro_torch.core.writeset import WriteSet
    from repro_torch.kernels import launch_counts, reset_launch_counts
    out = {}
    t_phase = time.perf_counter()
    with integrity_default():
        reset_launch_counts()
        WriteSet.gathers = 0
        out["drains"] = integrity_drains(dev, phase3)
        bt_full = out["drains"].pop("keep")
        out["gate"] = drain_gate(dev)
        # ---- the mixed arena: faults, scrub, salvage
        w = mixed_workload("partly", INTEG_N, dev)
        a, structs, want = w["arena"], w["structs"], w["want"]
        out["mixed_runs"] = {k: {"insert_s": v["insert_s"],
                                 "delete_s": v["delete_s"],
                                 "lines": v["stats"]["lines"],
                                 "integrity_lines":
                                     v["stats"]["integrity_lines"]}
                             for k, v in w["runs"].items()}
        pos = INTEG_N["dll"] >> 1            # chain position 2**21
        rows = fault_rows(structs, want, pos, pos + (pos >> 1))
        bt_keys = structs["bptree"].keys_in_order().cpu().numpy().tolist()
        out["gathers"] = gathers_check("integrity", launch_counts(),
                                       WriteSet.gathers)
        a.crash()
        t0 = time.perf_counter()
        bad = a.scrub()
        out["mixed_scrub_s"] = time.perf_counter() - t0
        if bad:
            raise AssertionError("mixed arena: a clean scrub named rows")
        recoveries = {}
        rep, secs = salvage_recover(a, structs)
        for kind in KINDS:
            check_exact(kind, structs[kind], want[kind], "clean salvage")
        recoveries["clean"] = (rep, secs, {})
        for name, which in (("bptree_only", ("bptree",)),
                            ("all", ("dll", "hashmap", "bptree"))):
            a.crash()
            expect = inject(a, rows, which)
            got = scrub_rows(a)
            if got != expect:
                raise AssertionError(f"{name}: scrub named {got}, the "
                                     f"faults were {expect}")
            reset_launch_counts()
            rep, secs = salvage_recover(a, structs)
            launched = launch_counts()
            res = check_salvaged(structs, want, rows, pos, bt_keys, name,
                                 which)
            recoveries[name] = (rep, secs, {"scrub": got,
                                            "launches": launched, **res})
            if name == "bptree_only":
                # undo the B+Tree flip (an involution) for the next case
                fi.flip_bits(a, MIXED_REGION["bptree"], rows["bptree"],
                             byte=8, mask=0x40)
        moved = {k: sum(recoveries[n][2]["launches"][k]
                        for n in ("bptree_only", "all"))
                 for k in CHAIN_KERNELS}
        if not all(moved.values()):
            raise AssertionError(f"salvage recoveries launched {moved}")
        out["salvage"] = {
            name: {"seconds": secs, "quarantined": rep.quarantined,
                   "degraded": rep.degraded,
                   "stages": {s.name: s.seconds for s in rep.stages},
                   "details": {s.name: {k: v for k, v in s.detail.items()
                                        if k != "quarantined_keys"}
                               for s in rep.stages if s.name != "reopen"},
                   **extra}
            for name, (rep, secs, extra) in recoveries.items()}
        out["salvage_chain_launches"] = moved
        out["fault_rows"] = rows
        del a, structs, w, want
        torch.cuda.empty_cache()
        out["full_mode"] = full_mode_and_fatal(dev, *bt_full)
        del bt_full
        torch.cuda.empty_cache()
        out["feature_store"] = feature_salvage(dev)
        torch.cuda.empty_cache()
        out["engine"] = engine_salvage(dev)
        torch.cuda.empty_cache()
        out["catalog"] = catalog_phase(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -------------------------------------------------------- sharded arenas

SHARDS = 4
PACK_SEG = 64                  # the DLL's SHARD_SEG: ("seg", 64)
PACK_SHARDS = (4, 3)           # phase 2's packed layouts
# phase 12's structures, cut from 2**22 (DLL, hashmap) and 2**17 (B+Tree)
# for the time phase 13's four-shard half and its second crossover take
SHARDED_N = {"dll": 1 << 19, "hashmap": 1 << 19, "bptree": 1 << 15}
# the commit window's mixed arena, its B+Tree cut from 2**17 for time
WINDOW_N = {"dll": 1 << 20, "hashmap": 1 << 20, "bptree": 1 << 15}
# benchmarks/flush_batching.py's sharded_sweep, its quick shape: B+Tree
# mixed 1:1, barrier, the per-line stall that makes the flush wall
# stall-dominated
SWEEP = {"n_init": 4000, "n_ops": 8192, "batch": 256, "group": 16,
         "synth_ns": 4000.0, "repeats": 3}
SWEEP_SHARDS = (1, 2, 4)
FLUSH_GATE = 1.3               # the reference's gate at 4 shards


def pack_chain(nxt, seg_rows: int, n_shards: int, gap: int = 0):
    """A global NEXT column packed shard-major under ("seg", seg_rows):
    (packed column, segments, packed position of each global id).  With
    ``gap``, that many NULL padding rows follow each shard's rows but the
    last's (offsets with gaps, as the reference accepts)."""
    import torch
    n = nxt.shape[0]
    g = torch.arange(n, device=nxt.device)
    shard = g // seg_rows % n_shards
    order = torch.argsort(shard, stable=True)
    pos = torch.empty_like(order)
    pos[order] = g
    segments = [0] + torch.cumsum(torch.bincount(
        shard, minlength=n_shards), 0).tolist()
    if not gap:
        return nxt[order].contiguous(), segments, pos
    pos += gap * shard
    segments = [x + gap * s for s, x in enumerate(segments[:-1])] + \
        [n + gap * (n_shards - 1)]
    packed = torch.full((segments[-1],), -1, dtype=nxt.dtype,
                        device=nxt.device)
    packed[pos] = nxt
    return packed, segments, pos


def packed_case(dev, perm, n_shards: int, flush, gap: int = 0) -> dict:
    """The four chain kernels on the random chain ``perm`` packed over
    ``n_shards`` shards by ("seg", 64), with ``gap`` padding rows after
    each shard's rows but the last's (the gapped launches, whose offsets
    ride in the launch's parameters): each exact against its plain version
    with the same segments and against its launch on the global layout of
    the same chain; timed with CUDA events, L2 evicted, beside that global
    launch, the bound and, for a gapped packing, the closed-form launch
    over the router's partition of the same chain."""
    import torch
    from repro_torch.core import recovery as TR
    from repro_torch.kernels import chain_order as K
    n = perm.numel()
    head = int(perm[0])
    nxt = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nxt[perm[:-1]] = perm[1:]
    packed, segs, pos = pack_chain(nxt, PACK_SEG, n_shards, gap)
    if not torch.equal(K.packed_positions(torch.arange(n, device=dev),
                                          PACK_SEG, segs), pos):
        raise AssertionError("packed_positions is not the packing")
    pk = {"segments": segs, "seg_rows": PACK_SEG}
    g32, p32 = K.sanitize32(nxt), K.sanitize32(packed)
    if gap:
        closed, segs_c, pos_c = pack_chain(nxt, PACK_SEG, n_shards)
        c32, pkc = K.sanitize32(closed), {"segments": segs_c,
                                          "seg_rows": PACK_SEG}
        del closed
    del nxt, packed
    gen = torch.Generator(device=dev)
    gen.manual_seed(n_shards)
    out = {"n": n, "n_shards": n_shards, "gap": gap, "segments": segs}

    def timed(name, packed_fn, global_fn, bound, err, closed_fn=None,
              **extra):
        out[name] = {"ms": time_ms(packed_fn, flush=flush),
                     "global_ms": time_ms(global_fn, flush=flush),
                     "bound_ms": bound, "max_abs_err": err, **extra}
        if closed_fn is not None:
            out[name]["closed_ms"] = time_ms(closed_fn, flush=flush)
    # ---- jump_double: a counted round, and chain_order's doubling tables
    cnt = torch.randint(1, 9, (n,), dtype=torch.int64, device=dev,
                        generator=gen)
    cnt_p = torch.zeros(p32.shape[0], dtype=torch.int64, device=dev)
    cnt_p[pos] = cnt
    if gap:
        cnt_c = torch.empty_like(cnt)
        cnt_c[pos_c] = cnt
    got = K.jump_double(p32, cnt_p, **pk)
    err = require_equal("jump_double packed", zip(
        got, K.jump_double_plain(p32, cnt_p, **pk)))
    glob = K.jump_double(g32, cnt)
    require_equal("jump_double packed vs global",
                  [(got[0][pos], glob[0]), (got[1][pos], glob[1])])
    rounds = n.bit_length() - 1
    lv = K.jump_double(p32, rounds=rounds, keep=True, **pk)[0]
    require_equal("jump_double packed tables", [
        (lv, K.jump_double_plain(p32, rounds=rounds, keep=True, **pk)[0]),
        (lv[:, pos], K.jump_double(g32, rounds=rounds, keep=True)[0])])
    del got, glob, lv
    if gap:
        extra = {"closed_fn": lambda: K.jump_double(c32, cnt_c, **pkc),
                 "tables_closed_ms": time_ms(lambda: K.jump_double(
                     c32, rounds=rounds, keep=True, **pkc), flush=flush,
                     reps=5)}
    else:
        extra = {}
    timed("jump_double", lambda: K.jump_double(p32, cnt_p, **pk),
          lambda: K.jump_double(g32, cnt), bound_ms(24 * n), err,
          tables_ms=time_ms(lambda: K.jump_double(
              p32, rounds=rounds, keep=True, **pk), flush=flush, reps=5),
          tables_global_ms=time_ms(lambda: K.jump_double(
              g32, rounds=rounds, keep=True), flush=flush, reps=5),
          tables_bound_ms=bound_ms(12 * n * rounds), tables_rounds=rounds,
          **extra)
    del cnt, cnt_p, extra
    if gap:
        del cnt_c
    # ---- gather_next: one hop of L = 7n/8 int64 ids (NULL, negatives,
    # 2**32 + 3, n), the snapshot verify's shape
    lanes = n - n // 8
    ids = torch.randint(0, n, (lanes,), dtype=torch.int64, device=dev,
                        generator=gen)
    ids[::97] = -1
    ids[1::89] = -5
    ids[2::83] = 2 ** 32 + 3
    ids[3::79] = n
    got = K.gather_next(p32, ids, **pk)
    err = require_equal("gather_next packed", [
        (got, K.gather_next_plain(p32, ids, **pk)),
        (got, K.gather_next(g32, ids))])
    valid = (ids >= 0) & (ids < n)
    distinct = int(torch.unique(ids[valid]).numel())
    timed("gather_next", lambda: K.gather_next(p32, ids, **pk),
          lambda: K.gather_next(g32, ids),
          bound_ms(12 * lanes + 4 * distinct), err, lanes=lanes,
          closed_fn=(lambda: K.gather_next(c32, ids, **pkc)) if gap
          else None)
    del ids, got, valid
    # ---- walk_segments: the contraction's one walk, checkpoints on
    heads = torch.tensor([head], dtype=torch.int64, device=dev)
    spine, hpos, cnext, w, marks = TR._contract(g32, heads, TR.CONTRACT_K)
    budget, cap = marks.walk["budget"], marks.rec.shape[1]
    kw = {key: v for key, v in marks.walk.items()
          if key not in ("nxt", "budget", "segments", "seg_rows")}
    starts = spine.to(torch.int32)

    def walk_p():
        return K.walk_segments(p32, starts, budget=budget, marks=cap, **kw,
                               **pk)

    def walk_g():
        return K.walk_segments(g32, starts, budget=budget, marks=cap, **kw)
    got, glob = walk_p(), walk_g()
    ref = K.walk_segments_plain(p32, starts, budget=budget, marks=cap, **kw,
                                **pk)
    err = require_equal("walk_segments packed", list(zip(got[:3], ref[:3]))
                        + list(zip(got[:3], glob[:3])))
    total = int(got[3][1][0])
    recs = [r[3][0][:, :total] for r in (got, ref, glob)]
    if total > cap or {int(r[3][1][0]) for r in (ref, glob)} != {total} or \
            not same_records(recs[0], recs[1]) or \
            not same_records(recs[0], recs[2]):
        raise AssertionError("walk_segments packed: checkpoints differ")
    hops = int(got[2].long().sum())
    lanes = starts.shape[0]
    del got, glob, ref, recs
    timed("walk_segments", walk_p, walk_g,
          bound_ms(4 * hops + 16 * lanes + 12 * total), err, lanes=lanes,
          hops=hops, checkpoints=total,
          closed_fn=(lambda: K.walk_segments(
              c32, starts, budget=budget, marks=cap, **kw, **pkc)) if gap
          else None)
    # ---- expand_segments: the split plan of that walk, count = n
    cjump = TR._contract_tables(cnext, min(n, spine.shape[0]))
    plan = TR._expand_plan(spine, cjump, w, int(hpos[0]), n, marks)
    got = K.expand_segments(p32, *plan, n, **pk)
    err = require_equal("expand_segments packed", [
        (got, K.expand_segments_plain(p32, *plan, n, **pk)),
        (got, K.expand_segments(g32, *plan, n)), (got, perm)])
    ehops = int(torch.clamp(plan[2].long() - 1, min=0).sum())
    del got
    timed("expand_segments", lambda: K.expand_segments(p32, *plan, n, **pk),
          lambda: K.expand_segments(g32, *plan, n),
          bound_ms(4 * ehops + 12 * plan[0].shape[0] + 8 * n), err,
          runs=int(plan[0].shape[0]), hops=ehops,
          closed_fn=(lambda: K.expand_segments(c32, *plan, n, **pkc))
          if gap else None)
    for row in out.values():
        if isinstance(row, dict):
            row["ratio"] = row["ms"] / row["global_ms"]
            if "closed_ms" in row:
                row["ratio_closed"] = row["ms"] / row["closed_ms"]
    if gap:
        del c32
    del p32, g32, plan, marks, spine, cjump
    torch.cuda.empty_cache()
    return out


def smallest_gapped(dev) -> dict:
    """The smallest gapped input: the chain 0 -> ... -> 5 over seg_rows 2
    and two shards, packed at [0, 5, 7] (one padding row after shard 0).
    ``gather_next`` must answer the reference's [1, 2, 3, 4, 5, -1], and
    ``chain_order`` rank 0..5 by both methods, on the card."""
    import torch
    from repro_torch.core.recovery import chain_order
    from repro_torch.kernels import chain_order as K
    segs = [0, 5, 7]
    packed = torch.full((7,), -1, dtype=torch.int32, device=dev)
    pos = K.packed_positions(torch.arange(6, device=dev), 2, segs)
    packed[pos] = torch.tensor([1, 2, 3, 4, 5, -1], dtype=torch.int32,
                               device=dev)
    got = K.gather_next(packed, torch.arange(6, device=dev), segments=segs,
                        seg_rows=2).tolist()
    if got != [1, 2, 3, 4, 5, -1]:
        raise AssertionError(f"smallest gapped input: gather_next {got}")
    orders = {m: chain_order(packed.long(), 0, method=m, segments=segs,
                             seg_rows=2).tolist()
              for m in ("double", "contract")}
    if any(o != list(range(6)) for o in orders.values()):
        raise AssertionError(f"smallest gapped input: chain_order {orders}")
    return {"segments": segs, "gather_next": got, "orders": orders}


def packed_parity(dev) -> dict:
    """Phase 2's packed layouts: a random 2**22 chain over 4 and over 3
    shards (``packed_case``), and over 4 shards with one padding row after
    each shard's rows but the last's (the gapped launches, beside the
    closed-form ones)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    perm = torch.randperm(1 << 22, device=dev, generator=g)
    flush = l2_flusher(dev)
    out = {f"shards_{ns}": packed_case(dev, perm, ns, flush)
           for ns in PACK_SHARDS}
    out[f"shards_{SHARDS}_gapped"] = packed_case(dev, perm, SHARDS, flush,
                                                 gap=1)
    del perm
    torch.cuda.empty_cache()
    return out


def sharded_small(kind: str, mode: str, integrity: bool, device) -> tuple:
    """Phase 4's sharded case: the quickstart workload at PARITY_N on a
    four-shard arena.  Returns the sha256 of every shard image and the
    manifest, and the FlushStats, aggregate and per shard."""
    from repro_torch.interop import image_of
    r = workload(kind, mode, PARITY_N, device, seed=3, integrity=integrity,
                 n_shards=SHARDS)
    a = r["arena"]
    return (hashlib.sha256(image_of(a)).hexdigest(), r["stats"],
            [dataclasses.asdict(st) for st in a.shard_stats()])


def packed_api(dev, d) -> dict:
    """The packed API on a committed sharded DLL ``d``: its shards'
    persistent NEXT views concatenated (no gather by global id), ranked
    by ``chain_order(segments=, seg_rows=64)`` by doubling, by
    contraction and through the snapshot verify, each equal to the
    DLL's order; the four chain kernels' launches over those calls, and
    each call's seconds beside the same call on the global volatile
    column."""
    import numpy as np
    import torch
    from repro_torch.core.recovery import ChainSnapshot, chain_order
    from repro_torch.kernels import launch_counts
    from repro_torch.pstruct.dll import DATA_WORDS, SHARD_SEG
    region = d.nodes
    t0 = time.perf_counter()
    views = [sl._pview()[:, DATA_WORDS] for sl in region.slices
             if sl is not None]
    segments = np.cumsum([0] + [v.shape[0] for v in views]).tolist()
    packed = torch.from_numpy(np.concatenate(views)).to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    want = d.to_list()
    glob = d.nodes.vol[:, DATA_WORDS].contiguous()
    out = {"n": int(packed.shape[0]), "count": d.count,
           "segments": segments, "upload_s": upload_s}
    before = launch_counts()
    for method in ("double", "contract"):
        for label, col, kw in (("packed", packed, {"segments": segments,
                                                   "seg_rows": SHARD_SEG}),
                               ("global", glob, {})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = chain_order(col, d.head, d.count, method=method, **kw)
            torch.cuda.synchronize()
            out[f"{method}_{label}_s"] = time.perf_counter() - t0
            if not torch.equal(got, want):
                raise AssertionError(f"packed API: {method} ({label}) "
                                     f"differs from the DLL's order")
    snap = ChainSnapshot(want)
    got = chain_order(packed, d.head, d.count, snapshot=snap,
                      segments=segments, seg_rows=SHARD_SEG)
    if snap.outcome != "snapshot" or not torch.equal(got, want):
        raise AssertionError("packed API: the snapshot verify refused the "
                             "DLL's own order")
    after = launch_counts()
    out["launches"] = {k: after[k] - before[k] for k in CHAIN_KERNELS}
    if not all(out["launches"].values()):
        raise AssertionError(f"packed API launched {out['launches']}")
    return out


def sharded_structures(dev, phase3: dict) -> dict:
    """Phase 12's structures: phase 3's workload on four-shard arenas
    (SHARDED_N), both modes, integrity off, recovered through
    RecoveryManager (concurrency 4, per-region load stages).  The DLL and
    hashmap also run at one shard just before, recovered the same way:
    the aggregate FlushStats at four shards must equal that one-shard
    run's in every field but ``calls`` (a flush call per shard file), with
    no more gathers (phase 3's, where the sizes are phase 3's); the
    shards' lines and bytes must sum to the aggregate, pack_rows launches
    must equal the grouped gathers (one per drain); the packed API runs
    on the partly DLL.  The host-clock seconds compare within one stretch
    of the process, where phase 3's ran minutes earlier (and recovered by
    ``reopen`` plus ``reconstruct``, which loads the regions twice)."""
    import torch
    from repro_torch.core.writeset import WriteSet
    from repro_torch.kernels import launch_counts
    rows, packed = [], None
    for kind in KINDS:
        for mode in ("full", "partly"):
            one = None
            if kind != "bptree":
                o = workload(kind, mode, SHARDED_N[kind], dev,
                             concurrency=SHARDS)
                one = {"insert_s": o["insert_s"], "delete_s": o["delete_s"],
                       "recover_s": o["recover_s"], "stats": o["stats"],
                       "gathers": o["gathers"],
                       "stages": {st.name: st.seconds
                                  for st in o["recovery"].stages}}
                del o
                torch.cuda.empty_cache()
            before = launch_counts()
            WriteSet.gathers = 0
            r = workload(kind, mode, SHARDED_N[kind], dev, n_shards=SHARDS,
                         concurrency=SHARDS)
            label = f"sharded {kind} {mode}"
            after = launch_counts()
            gathers = gathers_check(label, {k: after[k] - before[k]
                                            for k in after},
                                    WriteSet.gathers)
            a, rep = r["arena"], r["recovery"]
            agg, per = r["stats"], [dataclasses.asdict(st)
                                    for st in a.shard_stats()]
            for f in ("lines", "bytes", "snapshot_lines", "journal_lines",
                      "integrity_lines"):
                if agg[f] != sum(p[f] for p in per):
                    raise AssertionError(f"{label}: shard {f} do not sum "
                                         f"to the aggregate")
            row = {"kind": kind, "mode": mode, "n": SHARDED_N[kind],
                   "lines": agg["lines"], "calls": agg["calls"],
                   "shard_lines": [p["lines"] for p in per],
                   "gathers": r["gathers"], "epochs": agg["epochs"],
                   "insert_s": r["insert_s"], "delete_s": r["delete_s"],
                   "recover_s": r["recover_s"],
                   "stages": {st.name: st.seconds for st in rep.stages},
                   "reopen_detail": rep.stage("reopen").detail,
                   "launches": gathers, "one_shard": one}
            # the same workload on one arena: phase 3's run where the sizes
            # are phase 3's, else the one-shard run just before
            base, flat = "phase3", phase3.get((kind, mode))
            if flat is None or flat["n"] != SHARDED_N[kind]:
                base, flat = "one_shard", one
            if flat is not None:
                differ = {f: (agg[f], flat["stats"][f]) for f in agg
                          if f != "calls" and agg[f] != flat["stats"][f]}
                if differ:
                    raise AssertionError(f"{label}: FlushStats differ from "
                                         f"{base}'s: {differ}")
                if r["gathers"] > flat["gathers"]:
                    raise AssertionError(f"{label}: {r['gathers']} gathers, "
                                         f"{base} {flat['gathers']}")
                row.update({f"{base}_calls": flat["stats"]["calls"],
                            f"{base}_gathers": flat["gathers"]})
                if base == "phase3":
                    row.update(phase3_insert_s=flat["insert_s"],
                               phase3_delete_s=flat["delete_s"],
                               phase3_recover_s=flat["recover_s"])
            elif r["gathers"] > agg["epochs"]:
                raise AssertionError(f"{label}: {r['gathers']} gathers "
                                     f"over {agg['epochs']} drains")
            if kind == "dll" and mode == "partly":
                packed = packed_api(dev, r["structure"])
            rows.append(row)
            del r, a
            torch.cuda.empty_cache()
    return {"rows": rows, "packed_api": packed}


def commit_window(dev) -> dict:
    """Phase 12's commit window and integrity cells on one mixed four-shard
    arena (DLL and hashmap 2**20, B+Tree 2**15, partly, snapshots and
    integrity on): for each k of 0..3 an append whose commit crashes
    after shard k, recovered through RecoveryManager (concurrency 4,
    per-region load stages) to the manifest's generation with the append
    (its epoch was flushed) and the other structures exact, then a commit
    that seals the next generation; then a clean scrub, a clean salvage
    recovery, and flips in all three structures (and a stuck line) that
    scrub must name exactly and salvage must cut as phase 11's do."""
    import numpy as np
    import torch
    from repro_torch.core.recovery import RecoveryManager
    with integrity_default():
        t0 = time.perf_counter()
        w = mixed_workload("partly", WINDOW_N, dev, n_shards=SHARDS)
        fill_s = time.perf_counter() - t0
        a, structs, want = w["arena"], w["structs"], w["want"]
        if not a.integrity or a.n_shards != SHARDS:
            raise AssertionError("commit window: not a sharded integrity "
                                 "arena")
        d = structs["dll"]
        windows = []
        for k in range(SHARDS):
            gen0 = a.header_generation()
            ids = d.append_batch(np.full((64, 7), k + 1, np.int64))
            order = d.to_list().clone()
            want["dll"]["order"] = order.cpu().numpy()
            a.commit(_crash_after_shard=k)
            mgr = RecoveryManager(a)
            for kind in KINDS:
                s = structs[kind]
                mgr.add(MIXED_NAMES[kind], f"pstruct.{kind}", s,
                        regions=tuple(n for n in a.regions
                                      if n.startswith(MIXED_NAMES[kind]
                                                      + ".")))
            t0 = time.perf_counter()
            rep = mgr.recover(concurrency=SHARDS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if not rep.valid or rep.generation != gen0:
                raise AssertionError(f"commit window k={k}: generation "
                                     f"{rep.generation}, valid {rep.valid}; "
                                     f"the manifest sealed {gen0}")
            for kind in KINDS:
                check_exact(kind, structs[kind], want[kind],
                            f"commit window k={k}")
            a.commit()
            if a.header_generation() != gen0 + 1 or not a.header_valid():
                raise AssertionError(f"commit window k={k}: the next commit "
                                     f"did not seal {gen0 + 1}")
            windows.append({"k": k, "generation": gen0, "appended":
                            int(ids.numel()), "recover_s": secs,
                            "stages": {st.name: st.seconds
                                       for st in rep.stages}})
        # ---- the ("barrier", 4) integrity cells
        a.crash()
        t0 = time.perf_counter()
        bad = a.scrub()
        scrub_s = time.perf_counter() - t0
        if bad:
            raise AssertionError("sharded mixed arena: a clean scrub named "
                                 "rows")
        rep, clean_s = salvage_recover(a, structs)
        for kind in KINDS:
            check_exact(kind, structs[kind], want[kind], "sharded salvage")
        pos = int(d.count) // 2
        rows = fault_rows(structs, want, pos, pos + pos // 2)
        bt_keys = structs["bptree"].keys_in_order().cpu().numpy().tolist()
        a.crash()
        expect = inject(a, rows)
        got = scrub_rows(a)
        if got != expect:
            raise AssertionError(f"sharded faults: scrub named {got}, the "
                                 f"faults were {expect}")
        rep, faulted_s = salvage_recover(a, structs)
        res = check_salvaged(structs, want, rows, pos, bt_keys,
                             "sharded faults")
    out = {"sizes": WINDOW_N, "fill_s": fill_s, "windows": windows,
           "scrub_s": scrub_s, "clean_salvage_s": clean_s,
           "faulted_salvage_s": faulted_s, "scrub": got,
           "quarantined": rep.quarantined, "degraded": rep.degraded,
           "shard_of_faults": {r: [int(a.regions[r].shard_of[x]) for x in v]
                               for r, v in got.items()}, **res}
    del a, structs, w
    torch.cuda.empty_cache()
    return out


def sharded_fatal(dev) -> dict:
    """A file-backed four-shard arena: a truncated and a removed shard file
    raise ShardLossError at open; a scribbled manifest raises
    ManifestError from verify_header and from a salvage recovery."""
    import numpy as np
    from repro_torch.core import faultinject as fi
    from repro_torch.core.arena import (ManifestError, ShardLossError,
                                        open_arena)
    from repro_torch.core.recovery import RecoveryManager
    from repro_torch.pstruct.dll import DoublyLinkedList
    base = ROOT / "build" / "chip_smoke_sharded"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    path = str(base / "arena")
    layout = DoublyLinkedList.layout(4096, "partly", snapshot=False)
    out = {}

    def committed():
        a = open_arena(path, layout, n_shards=SHARDS, device=dev,
                       integrity=True)
        d = DoublyLinkedList(a, 4096, "partly", snapshot=False)
        d.append_batch(np.ones((300, 7), np.int64))
        a.commit()
        return a, d
    for name, fault in (("truncate", lambda a: fi.truncate_shard(a, 2, 64)),
                        ("remove", lambda a: fi.remove_shard(a, 1))):
        a, _ = committed()
        a.close()
        fault(a)
        try:
            open_arena(path, layout, n_shards=SHARDS, device=dev)
            raise AssertionError(f"{name}: a lost shard opened")
        except ShardLossError as e:
            out[f"{name}_error"] = str(e)
        shutil.rmtree(base)
        base.mkdir(parents=True)
    a, d = committed()
    a.crash()
    fi.corrupt_manifest(a)
    for label, call in (("verify_header", a.verify_header),
                        ("salvage", lambda: RecoveryManager(a).add(
                            "dll", "pstruct.dll", d).recover(salvage=True))):
        try:
            call()
            raise AssertionError(f"a scribbled manifest passed {label}")
        except ManifestError as e:
            out[f"manifest_{label}"] = str(e)
    a.close()
    shutil.rmtree(base)
    return out


def sharded_serving(dev) -> dict:
    """Phase 4's engine (llama3.2-3b full width, 2 layers) on four-shard
    arenas through the twin protocol: the token log stripes slot-per-shard,
    re-prefill runs one group per (shard, prompt length); then the
    feature store at phase 9's config on four shards, FS11_REQUESTS
    requests, a torn crash, replay exactly once beside its twin."""
    import numpy as np
    import torch
    from repro_torch.feature_recover import requests, twin
    from repro_torch.models.backbone import init_params
    from repro_torch.serve.feature_store import FeatureConfig
    from repro_torch.serve_recover import run
    cfg = serve_config(layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    params = init_params(cfg, gen, dev)
    t0 = time.perf_counter()
    eng = run(cfg, dev, prompt_lens=SERVE_PROMPTS, max_batch=8,
              s_max=SERVE_S_MAX, steps=SERVE_STEPS, max_requests=64,
              seed=SERVE_SEED, params=params, workdir=str(ROOT / "build"),
              n_shards=SHARDS, concurrency=SHARDS)
    eng["run_s"] = time.perf_counter() - t0
    det = eng["engine_detail"]
    live = [g for grp in eng["groups"] for g in grp["slots"]]
    lens = {g: grp["tokens"] for grp in eng["groups"] for g in grp["slots"]}
    pairs = {(g % SHARDS, lens[g]) for g in live}
    if det["prefill_groups"] != len(pairs) or \
            det["shard_groups"] != len({g % SHARDS for g in live}):
        raise AssertionError(f"sharded engine: {det['prefill_groups']} "
                             f"groups over {det['shard_groups']} shards, "
                             f"the slots give {len(pairs)}")
    for grp in eng["groups"]:
        if len({g % SHARDS for g in grp["slots"]}) != 1:
            raise AssertionError(f"a re-prefill group spans shards: {grp}")
    del params
    torch.cuda.empty_cache()
    fcfg = FeatureConfig(**FS_CONFIG, mode="partly", journal=True,
                         n_shards=SHARDS)
    ops = requests(FS11_REQUESTS, FS_KEYS_PER_REQUEST, FS_KEY_SPACE,
                   fcfg.dim, seed=FS_SEED)
    boundary = FS11_REQUESTS * 3 // 4
    t0 = time.perf_counter()
    fs = twin(fcfg, ops, boundary, torn=True, device=dev,
              concurrency=SHARDS)
    fs["twin_protocol_s"] = time.perf_counter() - t0
    if fs["refused"] != boundary:
        raise AssertionError(f"sharded feature store refused "
                             f"{fs['refused']}, not {boundary}")
    torch.cuda.empty_cache()
    return {"engine": {k: v for k, v in eng.items()
                       if k not in ("stats", "paging_stats")},
            "engine_stats": eng["stats"],
            "feature_store": {k: v for k, v in fs.items()
                              if k not in ("stats", "twin_stats")},
            "feature_stats": fs["stats"], "requests": FS11_REQUESTS,
            "boundary": boundary}


def sweep_point(n_shards: int, dev, seed: int = 0, shape=None,
                commit_mode: str = "barrier", spans=None) -> dict:
    """One point of the reference's sharded_sweep
    (``benchmarks/flush_batching.py`` ``_sharded_flush``): a B+Tree,
    mixed 1:1 inserts and deletes in epochs of ``shape["group"]``
    batches, synthetic per-line (and, with ``shape["synth_fence_ns"]``,
    per-fence) stalls; the flush wall is the epoch drains and commits
    only.  ``n_shards=1`` is the plain arena.  ``shape`` defaults to
    SWEEP.  Each epoch's drain and commit are profiled on the host clock
    (``EpochClock``); ``spans``, a ``HostSpans``, closes an epoch after
    each commit."""
    import numpy as np
    from repro_torch.core.arena import open_arena
    from repro_torch.pstruct.bptree import BPTree
    shape = shape or SWEEP
    n_init, n_ops, batch = shape["n_init"], shape["n_ops"], shape["batch"]
    rng = np.random.default_rng(seed)
    capacity = n_init + n_ops + 1024
    nodes = max(64, capacity // 4)
    a = open_arena(None, BPTree.layout(nodes, capacity, "partly"),
                   n_shards=n_shards, synth_line_ns=shape["synth_ns"],
                   synth_fence_ns=shape.get("synth_fence_ns", 0.0),
                   commit_mode=commit_mode, device=dev, integrity=False)
    t = BPTree(a, nodes, capacity, "partly")
    keyspace = rng.permutation(capacity * 2).astype(np.int64)
    init_keys = keyspace[:n_init]
    new_keys = keyspace[n_init:n_init + n_ops]
    vals = rng.integers(0, 1 << 40, (max(n_init, n_ops), 7)).astype(np.int64)
    for i in range(0, n_init, 4096):
        t.insert_batch(init_keys[i:i + 4096], vals[i:i + 4096])
    a.commit()
    base = a.stats.snapshot()
    ops, done, ins, rm = [], 0, 0, 0
    while done < n_ops:
        m = min(batch, n_ops - done)
        ops.append(("ins", new_keys[ins:ins + m], vals[:m]))
        ins += m
        done += m
        if done >= n_ops:
            break
        m = min(batch, n_ops - done)
        ops.append(("del", init_keys[rm:rm + m], None))
        rm += m
        done += m
    wall = 0.0
    if spans is not None:
        spans.reset()              # the fill's drains are not an epoch
    with EpochClock() as clock:
        for g in range(0, len(ops), shape["group"]):
            a._epoch_depth += 1        # marks accumulate untimed
            for op, ks, vs in ops[g:g + shape["group"]]:
                if op == "ins":
                    t.insert_batch(ks, vs)
                else:
                    t.delete_batch(ks)
            a._epoch_depth -= 1
            wall += clock.epoch(a)
            if spans is not None:
                spans.epoch()
    d = a.stats.delta(base)
    a.close()
    return {"n_shards": n_shards, "commit_mode": commit_mode,
            "flush_wall_s": wall, "lines": d.lines,
            "saved_lines": d.saved_lines, "dedup_rows": d.dedup_rows,
            "epochs": d.epochs, "fences": d.fences,
            "lines_per_s": d.lines / max(wall, 1e-9),
            "host_profile": clock.profile()}


class EpochClock:
    """Times a sweep point's epochs: each epoch's drain and commit walls,
    and what else the process did inside them: its minor page faults
    (first touches of the arena's in-memory image) and the collector's
    passes with their wall (``gc.callbacks``)."""

    def __init__(self):
        self.drain_ms, self.commit_ms = [], []
        self.faults = self.gc_passes = 0
        self.gc_ms, self._timing, self._gc_t0 = 0.0, False, 0

    def _on_gc(self, phase: str, info: dict) -> None:
        if not self._timing:
            return
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
        else:
            self.gc_ms += (time.perf_counter_ns() - self._gc_t0) / 1e6
            self.gc_passes += 1

    def __enter__(self):
        import gc
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._on_gc)

    def epoch(self, a) -> float:
        """Drain and commit ``a``'s epoch; returns their wall in s."""
        import resource
        f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        self._timing = True
        t0 = time.perf_counter()
        a.writeset.flush()
        t1 = time.perf_counter()
        a.commit()
        t2 = time.perf_counter()
        self._timing = False
        self.faults += resource.getrusage(resource.RUSAGE_SELF).ru_minflt \
            - f0
        self.drain_ms.append((t1 - t0) * 1e3)
        self.commit_ms.append((t2 - t1) * 1e3)
        return t2 - t0

    def profile(self) -> dict:
        """The epochs' walls (ms), their medians and largest, the faults
        and the collector's passes and wall inside them."""
        epoch = [x + y for x, y in zip(self.drain_ms, self.commit_ms)]
        return {"drain_ms": self.drain_ms, "commit_ms": self.commit_ms,
                "drain_median_ms": statistics.median(self.drain_ms),
                "commit_median_ms": statistics.median(self.commit_ms),
                "epoch_max_ms": max(epoch), "minor_faults": self.faults,
                "gc_passes": self.gc_passes, "gc_ms": self.gc_ms}


def flush_gate(dev) -> dict:
    """The reference's sharded flush gate: sweep points interleaved, best
    of SWEEP["repeats"]; equal line, saved-line and dedup counts at every
    shard count, and the 4-shard flush wall at least FLUSH_GATE times
    faster than one shard's."""
    best = {}
    for _ in range(SWEEP["repeats"]):
        for ns in SWEEP_SHARDS:
            r = sweep_point(ns, dev)
            if ns not in best or r["flush_wall_s"] < best[ns]["flush_wall_s"]:
                best[ns] = r
    rows = [best[ns] for ns in SWEEP_SHARDS]
    one = rows[0]
    for r in rows:
        r["x_vs_1shard"] = one["flush_wall_s"] / max(r["flush_wall_s"], 1e-9)
        if (r["lines"], r["saved_lines"], r["dedup_rows"]) != \
                (one["lines"], one["saved_lines"], one["dedup_rows"]):
            raise AssertionError(f"flush gate: {r['n_shards']} shards "
                                 f"account differently: {rows}")
    x4 = best[SHARDS]["x_vs_1shard"]
    if x4 < FLUSH_GATE:
        raise AssertionError(f"flush gate: 4 shards {x4:.2f}x one shard, "
                             f"below {FLUSH_GATE}")
    return {"shape": SWEEP, "rows": rows, "x4": x4, "gate": FLUSH_GATE}


def sharded_phase(dev, phase3: dict) -> dict:
    """Phase 12: sharded arenas (barrier commit) at the main path's size;
    the structures and the packed API, the commit window and the
    integrity cells, the fatal cases, serving and the flush gate."""
    t_phase = time.perf_counter()
    out = {}
    for name, fn in (("structures", lambda: sharded_structures(dev,
                                                              phase3)),
                     ("commit_window", lambda: commit_window(dev)),
                     ("fatal", lambda: sharded_fatal(dev)),
                     ("serving", lambda: sharded_serving(dev)),
                     ("flush_gate", lambda: flush_gate(dev))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[f"{name}_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------- shadow commit, one arena

# phase 13: phase 3's workload (the B+Tree cut to 2**15 for time: each
# run has a barrier twin, and the B+Tree's host per-leaf logic took 29 of
# the phase's 120 s at 2**17; the one-arena DLL and hashmap cut to 2**19
# to make room for the four-shard half at 2**22 and the four-shard
# crossover's second run, after the four-shard serving), the torn flips
# and the commit window on a mixed arena at phase 12's window size (its
# B+Tree cut alike), and the reference's shadow_crossover shape
# (benchmarks/flush_batching.py:218-250) at one and four shards: B+Tree
# mixed 1:1, epochs of 4 x 64, 250 ns a line, 1 ms a fence
SHADOW_N = {"dll": 1 << 19, "hashmap": 1 << 19, "bptree": 1 << 15}
# phase 13's four-shard half: phase 3's widths, the DLL and the hashmap
# cut to 2**20 (from 2**22) and the B+Tree as above, for the time of
# phases 14 and 15
SHADOW4_N = {"dll": 1 << 20, "hashmap": 1 << 20, "bptree": 1 << 15}
CROSSOVER_GATE = 1.3           # the reference's gate, at 4 shards
TORN_N = {"dll": 1 << 20, "hashmap": 1 << 20, "bptree": 1 << 15}
CROSSOVER = {"n_init": 4000, "n_ops": 8192, "batch": 64, "group": 4,
             "synth_ns": 250.0, "synth_fence_ns": 1_000_000.0,
             "repeats": 2}


def remapped_rows(a, regions) -> dict:
    """For each region, the middle row of those the authoritative shadow
    bank remaps (the same on every device for the same operations)."""
    import numpy as np
    bank = a._shadow_masks[a._shadow_auth_bank]
    out = {}
    for name in regions:
        rows = np.flatnonzero(bank.get(name, np.zeros(0, bool)))
        if rows.size == 0:
            raise AssertionError(f"no {name} row in the authoritative bank")
        out[name] = int(rows[rows.size // 2])
    return out


def shadow_small(kind: str, mode: str, device) -> tuple:
    """Phase 4's shadow case for one structure: the quickstart workload at
    PARITY_N on a shadow arena (integrity off), committed after the
    inserts and after the deletes, then a crash and recovery.  Returns the
    image's sha256 (banks and meta line included), the FlushStats and the
    recovered state's digest."""
    from repro_torch.interop import image_of
    r = workload(kind, mode, PARITY_N, device, seed=3,
                 commit_mode="shadow", commit_after_fill=True)
    return (hashlib.sha256(image_of(r["arena"])).hexdigest(), r["stats"],
            state_digest(kind, r["structure"]))


def sharded_shadow_small(kind: str, mode: str, integrity: bool,
                         device) -> tuple:
    """Phase 4's four-shard shadow case: the quickstart workload at
    PARITY_N on a four-shard shadow arena, committed after the inserts and
    after the deletes, then a crash and recovery through the per-region
    load stages.  Returns the sha256 of every shard image and the
    manifest, the FlushStats, aggregate and per shard, and the recovered
    state's digest."""
    from repro_torch.interop import image_of
    r = workload(kind, mode, PARITY_N, device, seed=3, integrity=integrity,
                 n_shards=SHARDS, concurrency=SHARDS, commit_mode="shadow",
                 commit_after_fill=True)
    a = r["arena"]
    return (hashlib.sha256(image_of(a)).hexdigest(), r["stats"],
            [dataclasses.asdict(st) for st in a.shard_stats()],
            state_digest(kind, r["structure"]))


def shadow_mixed_small(mode: str, device) -> tuple:
    """Phase 4's mixed shadow case: the three structures on one shadow
    arena at PARITY_N (B+Tree PARITY_N / 4), integrity and snapshots on;
    crash, a flipped bit in a row of each structure that the
    authoritative bank remaps, reopen, scrub (which must name exactly
    those rows), salvage.  Returns the image's sha256, FlushStats, the
    rows, scrub, report without timing and state digests."""
    from repro_torch.core import faultinject as fi
    from repro_torch.interop import image_of
    sizes = {"dll": PARITY_N, "hashmap": PARITY_N, "bptree": PARITY_N >> 2}
    w = mixed_workload(mode, sizes, device, integrity=True, seed=3,
                       commit_mode="shadow")
    a, structs = w["arena"], w["structs"]
    image = hashlib.sha256(image_of(a)).hexdigest()
    rows = remapped_rows(a, MIXED_REGION.values())
    a.crash()
    for name, row in rows.items():
        fi.flip_bits(a, name, row, byte=8, mask=0x40)
    a.reopen()
    bad = scrub_rows(a)
    if bad != {n: [r] for n, r in sorted(
            rows.items(), key=lambda kv: list(a.regions).index(kv[0]))}:
        raise AssertionError(f"shadow mixed {mode}: scrub named {bad}, the "
                             f"faults were {rows}")
    rep, _ = salvage_recover(a, structs)
    return (image, dataclasses.asdict(a.stats), rows, bad, no_timing(rep),
            [state_digest(k, structs[k]) for k in KINDS])


def remap_meter(meter: dict):
    """An ``on_arena`` hook: counts, on a shadow arena, the lines its
    rewrites put into the target bank (mirror rows and remap entries),
    the entries each seal persists, and the lines its folds write home."""
    for k in ("remap_lines", "remap_rows", "entries", "collapse_lines"):
        meter[k] = 0

    def hook(a):
        write, fold, seal = a._shadow_write, a._shadow_collapse, \
            a._shadow_seal

        def metered_write(region, rows, data):
            before = a.stats.lines
            out = write(region, rows, data)
            meter["remap_lines"] += a.stats.lines - before
            meter["remap_rows"] += int(rows.size)
            return out

        def metered_fold(limit=None):
            before = a.stats.lines
            out = fold(limit)
            meter["collapse_lines"] += a.stats.lines - before
            return out

        def metered_seal():
            meter["entries"] += a._shadow_counts[a._shadow_target_bank()]
            seal()
        a._shadow_write = metered_write
        a._shadow_collapse = metered_fold
        a._shadow_seal = metered_seal
    return hook


def shadow_structures(dev, launches3: dict) -> dict:
    """Phase 13's structures: phase 3's workload (committed after the
    inserts too) on shadow arenas, both modes, integrity off, each beside
    a barrier twin run just before it: the recovered state checked as
    phase 3 checks it, pack_rows launches = grouped gathers, one fence a
    commit, and every chain kernel that phase 3 launched launched here."""
    import torch
    from repro_torch.core.writeset import WriteSet
    from repro_torch.kernels import launch_counts
    rows, chain = [], {k: 0 for k in CHAIN_KERNELS}
    for kind in KINDS:
        for mode in ("full", "partly"):
            n = SHADOW_N[kind]
            tw = workload(kind, mode, n, dev, commit_after_fill=True)
            twin = {k: tw[k] for k in ("insert_s", "delete_s", "recover_s",
                                       "lines", "gathers")}
            twin["fences"] = tw["stats"]["fences"]
            del tw
            torch.cuda.empty_cache()
            meter, label = {}, f"shadow {kind} {mode}"
            before, g0 = launch_counts(), WriteSet.gathers
            r = workload(kind, mode, n, dev, commit_mode="shadow",
                         commit_after_fill=True, on_arena=remap_meter(meter))
            after = launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            gathers = gathers_check(label, delta, WriteSet.gathers - g0)
            for k in CHAIN_KERNELS:
                chain[k] += delta[k]
            st = r["stats"]
            if st["fences"] != r["commits"]:
                raise AssertionError(f"{label}: {st['fences']} fences for "
                                     f"{r['commits']} commits")
            rows.append({"kind": kind, "mode": mode, "n": n,
                         "lines": r["lines"], "epochs": st["epochs"],
                         "fences": st["fences"], "commits": r["commits"],
                         "gathers": r["gathers"], **meter,
                         "insert_s": r["insert_s"],
                         "delete_s": r["delete_s"],
                         "recover_s": r["recover_s"], "twin": twin,
                         "insert_x": r["insert_s"] / twin["insert_s"],
                         "delete_x": r["delete_s"] / twin["delete_s"],
                         "recover_x": r["recover_s"] / twin["recover_s"],
                         "launches": gathers})
            del r
            torch.cuda.empty_cache()
    missing = [k for k in CHAIN_KERNELS if launches3[k] and not chain[k]]
    if missing:
        raise AssertionError(f"phase 13 never launched {missing}, which "
                             f"phase 3 launched")
    return {"rows": rows, "chain_launches": chain}


def shadow_torn(dev) -> dict:
    """Phase 13's torn flips on a mixed shadow arena (TORN_N, partly,
    snapshots and integrity on): an append torn after its drain, an append
    crashed after the seal and before the flip, and a fold of the
    committed bank cut after one region (twice), each recovered through
    RecoveryManager to the committed generation with every structure
    exact; then a clean scrub, a flip on a DLL row the authoritative bank
    remaps (its fault offset in the bank's mirror, scrub naming exactly
    it) and a salvage recovery cutting the DLL there."""
    import numpy as np
    import torch
    from repro_torch.core import faultinject as fi
    from repro_torch.core.recovery import RecoveryManager
    t0 = time.perf_counter()
    w = mixed_workload("partly", TORN_N, dev, integrity=True,
                       commit_mode="shadow")
    fill_s = time.perf_counter() - t0
    a, structs, want = w["arena"], w["structs"], w["want"]
    d = structs["dll"]
    cases = []

    def recover(label, gen0):
        mgr = RecoveryManager(a)
        for kind in KINDS:
            mgr.add(MIXED_NAMES[kind], f"pstruct.{kind}", structs[kind])
        t0 = time.perf_counter()
        rep = mgr.recover()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not rep.valid or rep.generation != gen0 or \
                a.generation != gen0:
            raise AssertionError(f"{label}: recovered generation "
                                 f"{rep.generation}, committed {gen0}")
        for kind in KINDS:
            check_exact(kind, structs[kind], want[kind], label)
        return secs
    for case in ("torn_drain", "sealed_unflipped", "fold_cut"):
        gen0 = a.header_generation()
        secs = []
        if case == "torn_drain":
            with a.epoch():
                d.append_batch(np.full((64, 7), 5, np.int64))
                a.writeset.flush(include_meta=False)
                a.crash()
            secs.append(recover(case, gen0))
        elif case == "sealed_unflipped":
            d.append_batch(np.full((64, 7), 6, np.int64))
            a._shadow_collapse()
            a.writeset.flush()
            a._shadow_seal()
            a.crash()
            secs.append(recover(case, gen0))
        else:
            for _ in range(2):
                if a._shadow_collapse(limit=1):
                    raise AssertionError("fold_cut: the committed bank "
                                         "folded whole")
                a.crash()
                secs.append(recover(case, gen0))
        cases.append({"case": case, "generation": gen0, "recover_s": secs})
    t0 = time.perf_counter()
    clean = a.scrub()
    scrub_s = time.perf_counter() - t0
    if clean:
        raise AssertionError("shadow torn: a clean scrub named rows")
    order = want["dll"]["order"]
    mask = a._shadow_masks[a._shadow_auth_bank]["dll.nodes"]
    cand = np.flatnonzero(mask[order])
    pos = int(cand[cand.size // 2])
    row = int(order[pos])
    a.crash()
    owner, off, rb = fi.committed_row_offset(a, "dll.nodes", row)
    bank = a.header_generation() % 2
    if off != a.regions["dll.nodes"]._shadow_off[bank] + row * rb:
        raise AssertionError("committed_row_offset missed the bank mirror")
    fi.flip_bits(a, "dll.nodes", row, byte=8, mask=0x40)
    a.reopen()
    got = scrub_rows(a)
    if got != {"dll.nodes": [row]}:
        raise AssertionError(f"shadow torn: scrub named {got}, the fault "
                             f"was dll.nodes row {row}")
    rep, salvage_s = salvage_recover(a, structs)
    res = check_salvaged(structs, want, {"dll": row}, pos, None,
                         "shadow salvage", faulted=("dll",))
    out = {"sizes": TORN_N, "fill_s": fill_s, "cases": cases,
           "scrub_s": scrub_s, "fault_row": row, "fault_pos": pos,
           "remapped_dll_rows": int(mask.sum()), "bank": bank,
           "salvage_s": salvage_s, "quarantined": rep.quarantined,
           "degraded": rep.degraded, **res}
    del a, structs, w
    torch.cuda.empty_cache()
    return out


def shadow_serving(dev) -> dict:
    """Phase 13's serving: the 2-layer full-width engine through the twin
    protocol, then the feature store at phase 9's config and
    FS11_REQUESTS requests with a torn crash and the exactly-once replay
    beside its twin, both on shadow arenas."""
    import torch
    from repro_torch.feature_recover import requests, twin
    from repro_torch.models.backbone import init_params
    from repro_torch.serve.feature_store import FeatureConfig
    from repro_torch.serve_recover import run
    cfg = serve_config(layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    params = init_params(cfg, gen, dev)
    t0 = time.perf_counter()
    eng = run(cfg, dev, prompt_lens=SERVE_PROMPTS, max_batch=8,
              s_max=SERVE_S_MAX, steps=SERVE_STEPS, max_requests=64,
              seed=SERVE_SEED, params=params, workdir=str(ROOT / "build"),
              commit_mode="shadow")
    eng["run_s"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    fcfg = FeatureConfig(**FS_CONFIG, mode="partly", journal=True,
                         commit_mode="shadow")
    ops = requests(FS11_REQUESTS, FS_KEYS_PER_REQUEST, FS_KEY_SPACE,
                   fcfg.dim, seed=FS_SEED)
    boundary = FS11_REQUESTS * 3 // 4
    t0 = time.perf_counter()
    fs = twin(fcfg, ops, boundary, torn=True, device=dev)
    fs["twin_protocol_s"] = time.perf_counter() - t0
    if fs["refused"] != boundary:
        raise AssertionError(f"shadow feature store refused "
                             f"{fs['refused']}, not {boundary}")
    if fs["stats"]["fences"] > fs["stats"]["calls"]:
        raise AssertionError("shadow feature store: more fences than "
                             "commit calls")
    torch.cuda.empty_cache()
    return {"engine": {k: v for k, v in eng.items()
                       if k not in ("stats", "paging_stats")},
            "engine_stats": eng["stats"],
            "feature_store": {k: v for k, v in fs.items()
                              if k not in ("stats", "twin_stats")},
            "feature_stats": fs["stats"], "requests": FS11_REQUESTS,
            "boundary": boundary}


def shadow_crossover(dev, shard_counts=(1, SHARDS), gated: bool = True
                     ) -> dict:
    """The reference's shadow_crossover shape at ``shard_counts``, barrier
    and shadow interleaved, best of CROSSOVER["repeats"]: the flush wall,
    the fences (three an epoch against one), and the rate charging both
    modes the barrier row's lines, as the reference does; each row keeps
    its epochs' host profile.  The reference gates the four-shard speedup
    at CROSSOVER_GATE (``gated``; otherwise ``passes_gate`` reports it);
    the one-shard point is reported beside it ungated."""
    best = {}
    for _ in range(CROSSOVER["repeats"]):
        for ns in shard_counts:
            for mode in ("barrier", "shadow"):
                r = sweep_point(ns, dev, shape=CROSSOVER, commit_mode=mode)
                if (ns, mode) not in best or \
                        r["flush_wall_s"] < best[ns, mode]["flush_wall_s"]:
                    best[ns, mode] = r
    out = {"shape": CROSSOVER, "gate": CROSSOVER_GATE,
           "host_state": host_state()}
    for ns in shard_counts:
        bar, sh = best[ns, "barrier"], best[ns, "shadow"]
        for r in (bar, sh):
            r["flush_lines_per_s"] = bar["lines"] / max(r["flush_wall_s"],
                                                        1e-9)
        if bar["fences"] != 3 * bar["epochs"] or \
                sh["fences"] != sh["epochs"]:
            raise AssertionError(
                f"crossover at {ns} shards, fences: barrier "
                f"{bar['fences']} over {bar['epochs']} epochs, shadow "
                f"{sh['fences']} over {sh['epochs']}")
        key = "rows" if ns == 1 else f"rows_{ns}"
        out[key] = [bar, sh]
        out["speedup" if ns == 1 else f"speedup_{ns}"] = \
            bar["flush_wall_s"] / max(sh["flush_wall_s"], 1e-9)
    x = out[f"speedup_{SHARDS}"]
    out["passes_gate"] = x >= CROSSOVER_GATE
    if gated and x < CROSSOVER_GATE:
        raise AssertionError(
            f"shadow crossover at {SHARDS} shards: {x:.3f}x barrier, below "
            f"{CROSSOVER_GATE} (walls "
            f"{ {k: v['flush_wall_s'] for k, v in best.items()} }; host "
            f"{ {k: no_lists(v['host_profile']) for k, v in best.items()} })")
    return out


def no_lists(d: dict) -> dict:
    return {k: v for k, v in d.items() if not isinstance(v, list)}


def host_state() -> dict:
    """What else the host holds when a host-timed gate runs: live threads
    by name, the load average, this process's resident memory and
    threads, the machine's free, cached and dirty memory, each NUMA
    node's free memory, the cores this process may run on, and the
    collector's counts (all read from /proc and /sys)."""
    import gc
    import threading

    def fields(path, keys):
        try:
            lines = Path(path).read_text().splitlines()
        except OSError:
            return {}
        return {k: " ".join(ln.split(":", 1)[1].split()) for ln in lines
                for k in keys if ln.split(":", 1)[0].split()[-1] == k}

    names = {}
    for t in threading.enumerate():
        base = t.name.rstrip("0123456789_-")
        names[base] = names.get(base, 0) + 1
    nodes = sorted(Path("/sys/devices/system/node").glob("node[0-9]*"))
    return {"python_threads": names,
            "process": fields("/proc/self/status", ("VmRSS", "Threads")),
            "machine": fields("/proc/meminfo",
                              ("MemFree", "Cached", "Dirty")),
            "numa_free": {n.name: fields(n / "meminfo", ("MemFree",))
                          .get("MemFree") for n in nodes},
            "cores": len(os.sched_getaffinity(0)),
            "loadavg": os.getloadavg(),
            "gc_collections": [g["collections"] for g in gc.get_stats()]}


class HostSpans:
    """Per-epoch host wall of chosen methods, inclusive of what they call
    (the study's breakdown; off in the gated runs): each wrapped call adds
    its wall to ``Class.method``, ``epoch()`` closes an epoch."""

    def __init__(self, targets):
        self.targets, self.cur, self.epochs = targets, {}, []

    def __enter__(self):
        self.saved = []
        for cls, name in self.targets:
            real = cls.__dict__[name]
            label = f"{cls.__name__}.{name}"
            self.saved.append((cls, name, real))

            def wrapped(*a, _real=real, _label=label, **kw):
                t0 = time.perf_counter_ns()
                try:
                    return _real(*a, **kw)
                finally:
                    self.cur[_label] = self.cur.get(_label, 0) + \
                        time.perf_counter_ns() - t0
            setattr(cls, name, wrapped)
        return self

    def __exit__(self, *exc):
        for cls, name, real in self.saved:
            setattr(cls, name, real)

    def reset(self) -> None:
        self.cur, self.epochs = {}, []

    def epoch(self) -> None:
        self.epochs.append(self.cur)
        self.cur = {}

    def mean_ms(self) -> dict:
        keys = sorted(set().union(*self.epochs)) if self.epochs else []
        n = max(len(self.epochs), 1)
        return {k: sum(e.get(k, 0) for e in self.epochs) / n / 1e6
                for k in keys}


def span_targets() -> list:
    from repro_torch.core.arena import Arena, ShardedArena
    from repro_torch.core.writeset import ShardedWriteSet, WriteSet
    return [(WriteSet, "gather"), (ShardedWriteSet, "_write_phase"),
            (ShardedWriteSet, "_flush_shadow"), (ShardedArena, "run_shards"),
            (Arena, "_shadow_collapse"), (Arena, "_shadow_write"),
            (Arena, "_integrity_home"), (Arena, "_shadow_seal"),
            (Arena, "_shadow_retire"), (Arena, "_write_header"),
            (Arena, "_pay"), (ShardedArena, "_fence"),
            (ShardedArena, "_write_manifest")]


def pool_always(self, fn, shards, lines) -> None:
    """The pool rule without the stall estimate: every share of work
    over more than one shard goes to the pool wherever stalls are
    modeled (the study's other arm)."""
    shards = list(shards)
    if len(shards) > 1 and self.synth_line_ns:
        list(self.pool().map(fn, shards))
    else:
        for s in shards:
            fn(s)


def pool_study(dev, position: str, repeats: int = 3) -> dict:
    """``--crossover-study``: the shard pool's two rules, interleaved in
    each of ``repeats`` rounds: phase 12's flush-gate points (SWEEP at 1,
    2, 4 shards) and the four-shard crossover pair, then one more
    crossover pair per rule under ``HostSpans``.  Walls are the untraced
    runs'; the spans' run gives the per-epoch breakdown."""
    from repro_torch.core.arena import ShardedArena
    rules = {"estimate": ShardedArena.run_shards, "always": pool_always}
    walls, prof, parts = {}, {}, {}
    state = host_state()
    try:
        for _ in range(repeats):
            for rule, fn in rules.items():
                ShardedArena.run_shards = fn
                for ns in SWEEP_SHARDS:
                    r = sweep_point(ns, dev)
                    walls.setdefault(f"{rule}/gate/{ns}", []).append(
                        r["flush_wall_s"])
                for mode in ("barrier", "shadow"):
                    r = sweep_point(SHARDS, dev, shape=CROSSOVER,
                                    commit_mode=mode)
                    walls.setdefault(f"{rule}/crossover/{mode}", []).append(
                        r["flush_wall_s"])
                    prof.setdefault(f"{rule}/{mode}", []).append(
                        no_lists(r["host_profile"]))
        for rule, fn in rules.items():
            ShardedArena.run_shards = fn
            for mode in ("barrier", "shadow"):
                with HostSpans(span_targets()) as sp:
                    r = sweep_point(SHARDS, dev, shape=CROSSOVER,
                                    commit_mode=mode, spans=sp)
                parts[f"{rule}/{mode}"] = {
                    "wall_ms_per_epoch": r["flush_wall_s"] * 1e3
                    / r["epochs"], "spans_ms_per_epoch": sp.mean_ms()}
    finally:
        ShardedArena.run_shards = rules["estimate"]
    out = {"position": position, "host_state": state, "walls_s": walls,
           "host_profile": prof, "parts": parts}
    for rule in rules:
        for name, num, den in (("gate_x4", "gate/1", "gate/4"),
                               ("crossover_x4", "crossover/barrier",
                                "crossover/shadow")):
            a, b = walls[f"{rule}/{num}"], walls[f"{rule}/{den}"]
            out[f"{rule}/{name}"] = min(a) / min(b)
            out[f"{rule}/{name}_each"] = [x / y for x, y in zip(a, b)]
    return out


def seat_launches(a) -> int:
    """The ``scatter_rows`` launches one reload of every region of the
    sharded arena ``a`` makes: one per (region, shard) whose slice it
    seats by the kernel (a block router's shard holding no full block
    copies only the region's tail block)."""
    return sum(1 for r in a.regions.values()
               for s, sl in enumerate(r.slices)
               if sl is not None and (not r._blk or r._blocks[s].size))


@contextlib.contextmanager
def commit_counts():
    """Counts ``ShardedArena.commit`` calls per arena inside the block;
    yields ``{id: [arena, commits]}``."""
    from repro_torch.core.arena import ShardedArena
    seen, real = {}, ShardedArena.commit

    def counted(self, *args, **kw):
        seen.setdefault(id(self), [self, 0])[1] += 1
        return real(self, *args, **kw)
    ShardedArena.commit = counted
    try:
        yield seen
    finally:
        ShardedArena.commit = real


def fences_are_commits(label: str, seen: dict) -> dict:
    """Every shadow arena of ``seen`` paid exactly one fence a commit, at
    the sharded level (its shards none)."""
    out = []
    for a, commits in seen.values():
        fences = a._local_stats.fences
        if a.commit_mode != "shadow" or fences != commits or \
                any(sh.stats.fences for sh in a.shards):
            raise AssertionError(f"{label}: {fences} fences for {commits} "
                                 f"commits ({a.commit_mode})")
        out.append({"commits": commits, "fences": fences})
    return out


def shadow_sharded_structures(dev, launches3: dict) -> dict:
    """Phase 13's four-shard structures: phase 3's workload (committed
    after the inserts too) on four-shard shadow arenas, both modes,
    integrity off, recovered through RecoveryManager (concurrency 4,
    per-region load stages), each beside a four-shard barrier twin run
    just before it: the recovered state checked as phase 3 checks it,
    pack_rows launches = grouped gathers, one fence a commit and none on
    a shard, one scatter_rows launch per loaded (region, shard), every
    chain kernel phase 3 launched launched here."""
    import torch
    from repro_torch.core.writeset import WriteSet
    from repro_torch.kernels import launch_counts
    rows, chain = [], {k: 0 for k in CHAIN_KERNELS}
    for kind in KINDS:
        for mode in ("full", "partly"):
            n = SHADOW4_N[kind]
            tw = workload(kind, mode, n, dev, n_shards=SHARDS,
                          concurrency=SHARDS, commit_after_fill=True)
            twin = {k: tw[k] for k in ("insert_s", "delete_s", "recover_s",
                                       "lines", "gathers")}
            twin["fences"] = tw["stats"]["fences"]
            del tw
            torch.cuda.empty_cache()
            meter, label = {}, f"sharded shadow {kind} {mode}"
            hook = remap_meter(meter)
            before, g0 = launch_counts(), WriteSet.gathers
            r = workload(kind, mode, n, dev, n_shards=SHARDS,
                         concurrency=SHARDS, commit_mode="shadow",
                         commit_after_fill=True,
                         on_arena=lambda a: [hook(sh) for sh in a.shards])
            after = launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            gathers = gathers_check(label, delta, WriteSet.gathers - g0)
            for k in CHAIN_KERNELS:
                chain[k] += delta[k]
            a, st = r["arena"], r["stats"]
            seats = seat_launches(a)
            if delta["scatter_rows"] != seats:
                raise AssertionError(f"{label}: {delta['scatter_rows']} "
                                     f"scatter_rows launches for {seats} "
                                     f"loaded (region, shard) slices")
            if st["fences"] != r["commits"] or \
                    any(sh.stats.fences for sh in a.shards):
                raise AssertionError(f"{label}: {st['fences']} fences for "
                                     f"{r['commits']} commits")
            rep = r["recovery"]
            rows.append({"kind": kind, "mode": mode, "n": n,
                         "lines": r["lines"], "epochs": st["epochs"],
                         "fences": st["fences"], "commits": r["commits"],
                         "gathers": r["gathers"], **meter,
                         "shard_lines": [sh.stats.lines for sh in a.shards],
                         "scatter_rows": seats,
                         "insert_s": r["insert_s"],
                         "delete_s": r["delete_s"],
                         "recover_s": r["recover_s"], "twin": twin,
                         "stages": {x.name: x.seconds for x in rep.stages},
                         "insert_x": r["insert_s"] / twin["insert_s"],
                         "delete_x": r["delete_s"] / twin["delete_s"],
                         "write_x": (r["insert_s"] + r["delete_s"])
                         / (twin["insert_s"] + twin["delete_s"]),
                         "recover_x": r["recover_s"] / twin["recover_s"],
                         "launches": gathers})
            del r, a
            torch.cuda.empty_cache()
    missing = [k for k in CHAIN_KERNELS if launches3[k] and not chain[k]]
    if missing:
        raise AssertionError(f"phase 13 at {SHARDS} shards never launched "
                             f"{missing}, which phase 3 launched")
    return {"rows": rows, "chain_launches": chain}


def shadow_sharded_window(dev) -> dict:
    """Phase 13's four-shard commit window on a mixed shadow arena
    (TORN_N, partly, snapshots and integrity on): for each k of -1..3 an
    append whose commit crashes at k (-1: after every shard's seal, before
    any flip; k: after shard k's flip), recovered through RecoveryManager
    (concurrency 4, per-region load stages) to the manifest's generation
    without the append, every shard re-anchored to it and targeting the
    bank after it, every structure exact; then a commit sealing the next
    generation on every shard.  Then a committed epoch of DLL deletes
    (rewrites on every shard), a clean scrub, a flip in a live DLL row
    that shard 3's authoritative bank remaps (its offset in that shard's
    bank mirror), scrub naming exactly it, and a salvage cutting the DLL
    there with the others exact."""
    import numpy as np
    import torch
    from repro_torch.core import faultinject as fi
    from repro_torch.core.recovery import RecoveryManager
    with integrity_default():
        t0 = time.perf_counter()
        w = mixed_workload("partly", TORN_N, dev, n_shards=SHARDS,
                           commit_mode="shadow")
        fill_s = time.perf_counter() - t0
        a, structs, want = w["arena"], w["structs"], w["want"]
        if not a.integrity or a.n_shards != SHARDS or \
                a.commit_mode != "shadow":
            raise AssertionError("sharded window: not a sharded shadow "
                                 "integrity arena")
        d = structs["dll"]

        def recover(label, gen0):
            mgr = RecoveryManager(a)
            for kind in KINDS:
                mgr.add(MIXED_NAMES[kind], f"pstruct.{kind}", structs[kind],
                        regions=tuple(n for n in a.regions
                                      if n.startswith(MIXED_NAMES[kind]
                                                      + ".")))
            t0 = time.perf_counter()
            rep = mgr.recover(concurrency=SHARDS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if not rep.valid or rep.generation != gen0 or \
                    a.generation != gen0 or any(
                        sh.generation != gen0 or
                        sh._shadow_target_bank() != (gen0 + 1) % 2
                        for sh in a.shards):
                raise AssertionError(f"{label}: recovered generation "
                                     f"{rep.generation}, the manifest "
                                     f"sealed {gen0}")
            for kind in KINDS:
                check_exact(kind, structs[kind], want[kind], label)
            return rep, secs
        windows = []
        for k in (-1, 0, 1, 2, 3):
            label = f"sharded shadow window k={k}"
            gen0 = a.header_generation()
            d.append_batch(np.full((64, 7), k + 2, np.int64))
            a.commit(_crash_after_shard=k)
            heads = [sh.header_generation() for sh in a.shards]
            if heads != [gen0 + (s <= k) for s in range(SHARDS)]:
                raise AssertionError(f"{label}: shard headers {heads}")
            rep, secs = recover(label, gen0)
            a.commit()
            if a.header_generation() != gen0 + 1 or not a.header_valid() \
                    or any(sh.header_generation() != gen0 + 1
                           for sh in a.shards):
                raise AssertionError(f"{label}: the next commit did not "
                                     f"seal {gen0 + 1} everywhere")
            windows.append({"k": k, "generation": gen0,
                            "shard_headers": heads, "recover_s": secs,
                            "stages": {x.name: x.seconds
                                       for x in rep.stages}})
        # rewrites on every shard, committed: each shard's bank holds some
        order = want["dll"]["order"]
        gone = order[np.linspace(1, order.size - 2, 256).astype(np.int64)]
        d.delete_batch(np.unique(gone))
        a.commit()
        want["dll"]["order"] = order = d.to_list().cpu().numpy()
        t0 = time.perf_counter()
        clean = a.scrub()
        scrub_s = time.perf_counter() - t0
        if clean:
            raise AssertionError("sharded shadow: a clean scrub named rows")
        sh, sl = a.shards[SHARDS - 1], a.regions["dll.nodes"].slices[-1]
        remapped = sl._gidx[np.flatnonzero(
            sh._shadow_masks[sh._shadow_auth_bank]["dll.nodes"])]
        cand = np.flatnonzero(np.isin(order, remapped))
        if cand.size == 0:
            raise AssertionError("no live DLL row in the last shard's bank")
        pos = int(cand[cand.size // 2])
        row = int(order[pos])
        a.crash()
        owner, off, rb = fi.committed_row_offset(a, "dll.nodes", row)
        bank = sh.header_generation() % 2
        if owner is not sh or off != sl._shadow_off[bank] + int(
                a.regions["dll.nodes"].local_of[row]) * rb:
            raise AssertionError("committed_row_offset missed the last "
                                 "shard's bank mirror")
        fi.flip_bits(a, "dll.nodes", row, byte=8, mask=0x40)
        a.reopen()
        got = scrub_rows(a)
        if got != {"dll.nodes": [row]}:
            raise AssertionError(f"sharded shadow: scrub named {got}, the "
                                 f"fault was dll.nodes row {row}")
        rep, salvage_s = salvage_recover(a, structs)
        res = check_salvaged(structs, want, {"dll": row}, pos, None,
                             "sharded shadow salvage", faulted=("dll",))
        if rep.quarantined + rep.degraded != ["dll"]:
            raise AssertionError(f"sharded shadow salvage named "
                                 f"{rep.quarantined + rep.degraded}")
    out = {"sizes": TORN_N, "fill_s": fill_s, "windows": windows,
           "scrub_s": scrub_s, "fault_row": row, "fault_pos": pos,
           "fault_shard": SHARDS - 1, "bank": bank,
           "remapped_dll_rows_last_shard": int(remapped.size),
           "salvage_s": salvage_s, "quarantined": rep.quarantined,
           "degraded": rep.degraded, **res}
    del a, structs, w
    torch.cuda.empty_cache()
    return out


def shadow_sharded_serving(dev) -> dict:
    """Phase 13's four-shard serving: the 2-layer full-width engine through
    the twin protocol (token log slot-per-shard, re-prefill per (shard,
    prompt length)), then the feature store at phase 9's config and
    FS11_REQUESTS requests with a torn crash and the exactly-once replay
    beside its twin, both on four-shard shadow arenas; every arena pays
    one fence a commit."""
    import torch
    from repro_torch.feature_recover import requests, twin
    from repro_torch.models.backbone import init_params
    from repro_torch.serve.feature_store import FeatureConfig
    from repro_torch.serve_recover import run
    cfg = serve_config(layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    params = init_params(cfg, gen, dev)
    t0 = time.perf_counter()
    with commit_counts() as seen:
        eng = run(cfg, dev, prompt_lens=SERVE_PROMPTS, max_batch=8,
                  s_max=SERVE_S_MAX, steps=SERVE_STEPS, max_requests=64,
                  seed=SERVE_SEED, params=params,
                  workdir=str(ROOT / "build"), n_shards=SHARDS,
                  concurrency=SHARDS, commit_mode="shadow")
    eng["run_s"] = time.perf_counter() - t0
    eng["fences"] = fences_are_commits("sharded shadow engine", seen)
    del params, seen
    torch.cuda.empty_cache()
    fcfg = FeatureConfig(**FS_CONFIG, mode="partly", journal=True,
                         n_shards=SHARDS, commit_mode="shadow")
    ops = requests(FS11_REQUESTS, FS_KEYS_PER_REQUEST, FS_KEY_SPACE,
                   fcfg.dim, seed=FS_SEED)
    boundary = FS11_REQUESTS * 3 // 4
    t0 = time.perf_counter()
    with commit_counts() as seen:
        fs = twin(fcfg, ops, boundary, torn=True, device=dev,
                  concurrency=SHARDS)
    fs["twin_protocol_s"] = time.perf_counter() - t0
    fs["fences"] = fences_are_commits("sharded shadow feature store", seen)
    if fs["refused"] != boundary:
        raise AssertionError(f"sharded shadow feature store refused "
                             f"{fs['refused']}, not {boundary}")
    torch.cuda.empty_cache()
    return {"engine": {k: v for k, v in eng.items()
                       if k not in ("stats", "paging_stats")},
            "engine_stats": eng["stats"],
            "feature_store": {k: v for k, v in fs.items()
                              if k not in ("stats", "twin_stats")},
            "feature_stats": fs["stats"], "requests": FS11_REQUESTS,
            "boundary": boundary}


def shadow_phase(dev, launches3: dict, study: bool = False) -> dict:
    """Phase 13: shadow commit on one arena and at four shards, at the
    main path's size.  The four-shard crossover gate runs first; the same
    four-shard crossover runs again last (after the four-shard serving),
    reported beside the gate; ``study`` adds ``pool_study`` before
    each."""
    t_phase = time.perf_counter()
    out = {}
    steps = [("crossover", lambda: shadow_crossover(dev)),
             ("structures", lambda: shadow_structures(dev, launches3)),
             ("torn", lambda: shadow_torn(dev)),
             ("serving", lambda: shadow_serving(dev)),
             ("sharded_structures",
              lambda: shadow_sharded_structures(dev, launches3)),
             ("sharded_window", lambda: shadow_sharded_window(dev)),
             ("sharded_serving", lambda: shadow_sharded_serving(dev)),
             ("crossover_late",
              lambda: shadow_crossover(dev, shard_counts=(SHARDS,),
                                       gated=False))]
    if study:
        steps.insert(0, ("study_first", lambda: pool_study(dev, "first")))
        steps.insert(-1, ("study_late", lambda: pool_study(dev, "late")))
    for name, fn in steps:
        t0 = time.perf_counter()
        out[name] = fn()
        if name.startswith("study"):
            emit({"phase": f"crossover_{name}", **out[name]})
        out[f"{name}_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -------------------------------------------------------------- training

class TimedLaunches:
    """Stands in for a loaded kernel library: every ``*_launch`` call is
    bracketed by CUDA events on the current stream, so the kernels' device
    time inside a real step can be summed."""

    def __init__(self, lib):
        self._lib = lib
        self.events = []

    def __getattr__(self, name):
        import torch
        fn = getattr(self._lib, name)
        if not name.endswith("_launch"):
            return fn

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self.events.append((name, start, end))
            return rc
        return timed


def attention_share(trainer) -> dict:
    """One more step of ``trainer`` with the flash libraries' launches
    timed by CUDA events: the attention kernels' device ms (forward,
    recomputed forward and backward) against the step's ms on the host
    clock (the step ends in a synchronize)."""
    import torch
    from repro_torch.kernels import _build
    names = ("flash_attention", "flash_attention_bwd")
    saved = {n: _build.load(n) for n in names}
    timed = {n: TimedLaunches(lib) for n, lib in saved.items()}
    _build._loaded.update(timed)
    try:
        trainer.run(1)
    finally:
        _build._loaded.update(saved)
    torch.cuda.synchronize()
    ms = {n: sum(s.elapsed_time(e) for _, s, e in t.events)
          for n, t in timed.items()}
    step_ms = trainer.metrics_log[-1]["sec"] * 1e3
    return {"step_ms": step_ms, "forward_ms": ms["flash_attention"],
            "backward_ms": ms["flash_attention_bwd"],
            "launches": {n: len(t.events) for n, t in timed.items()},
            "share": (ms["flash_attention"] + ms["flash_attention_bwd"])
            / step_ms}


def train_phase(dev) -> dict:
    """Phase 10: llama3.2-3b at its published widths, cut to CKPT_LAYERS
    layers, trained in f32 on TRAIN_BATCH x TRAIN_SEQ tokens under
    PARTLY_PERSISTENT (async checkpoints every TRAIN_CKPT_EVERY steps), a
    crash after TRAIN_CRASH_AT steps, a resume and a run to TRAIN_STEPS,
    beside an uninterrupted twin (``repro_torch.train_resume.twin_run``),
    with torch's kernels deterministic.  Every loss and the final
    parameters must equal the twin's bit for bit; the flash counters must
    move by 2 x layers per step (forward, and again under remat) and by
    layers per step (backward)."""
    import torch
    from repro_torch.core import policy as pol
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import deterministic
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import TrainerConfig
    from repro_torch.train_resume import mismatches, twin_run
    cfg = ckpt_config()
    model = Model(cfg, compute_dtype=torch.float32)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    shutil.rmtree(str(TRAIN_DIR) + "_ref", ignore_errors=True)
    tc = TrainerConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                       ckpt_dir=str(TRAIN_DIR),
                       policy=pol.PARTLY_PERSISTENT, seed=TRAIN_SEED,
                       global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       async_ckpt=True)
    deterministic(dev)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        out = twin_run(model, tc, TRAIN_CRASH_AT, dev)
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        bad = mismatches(out)
        share = attention_share(out["twin_trainer"])
    finally:
        torch.use_deterministic_algorithms(False)
    steps_run = len(out["crashed_step_s"]) + len(out["twin_step_s"])
    final = TRAIN_STEPS - 1
    delta = abs(out["second"][final] - out["twin"][final])
    res = {
        "arch": cfg.name, "layers": cfg.n_layers, "dtype": "float32",
        "params": cfg.param_count(), "global_batch": TRAIN_BATCH,
        "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "crash_after": TRAIN_CRASH_AT, "resumed_at": out["resumed_at"],
        "steps_run": steps_run, "seconds": seconds, "delta": delta,
        "mismatches": bad[:8],
        "losses": {str(k): v for k, v in sorted(out["twin"].items())},
        "step_ms": statistics.median(out["twin_step_s"][1:]) * 1e3,
        "first_step_ms": out["twin_step_s"][0] * 1e3,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
        / statistics.median(out["twin_step_s"][1:]),
        "saves": [{"step": r.step, "seconds": r.seconds,
                   "bytes_written": r.bytes_written,
                   "bytes_skipped_derivable": r.bytes_skipped_derivable}
                  for r in out["saves"]],
        "restore_s": out["restore_s"],
        "restore_stages": {st.name: st.seconds
                           for st in out["restore"].stages},
        "peak_bytes": peak, "attention": share, "launches": launches}
    del out
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    shutil.rmtree(str(TRAIN_DIR) + "_ref", ignore_errors=True)
    if bad or delta != 0.0:
        raise AssertionError(f"phase 10: the resumed run differs from its "
                             f"twin (delta {delta}): {bad[:8]}")
    want_at = TRAIN_CRASH_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    if res["resumed_at"] != want_at:
        raise AssertionError(f"phase 10 resumed at {res['resumed_at']}, "
                             f"not {want_at}")
    want = {k: v * steps_run for k, v in flash_per_step(cfg).items()}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"phase 10 launched {got}, not {want}")
    return res


def train_bf16(dev) -> dict:
    """Phase 10's step in bf16, as the launcher trains on a card: the same
    layers, widths and TRAIN_BATCH x TRAIN_SEQ tokens through
    ``Model(cfg, compute_dtype=torch.bfloat16)``, no checkpoint inside the
    steps, torch's kernels deterministic.  Two runs of TRAIN_BF16_STEPS
    steps from the same parameters (the same seed) must give the same
    losses and final parameters bit for bit, and each must launch
    flash_attention 2 x layers and flash_attention_bwd layers times a
    step.  Returns the step ms (median past the first), tokens/s and one
    more step's attention share."""
    import torch
    from repro_torch.core import policy as pol
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import deterministic
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = ckpt_config()
    model = Model(cfg, compute_dtype=torch.bfloat16)
    tc = TrainerConfig(steps=TRAIN_BF16_STEPS, ckpt_every=0,
                       ckpt_dir=str(TRAIN_DIR) + "_bf16", seed=TRAIN_SEED,
                       global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    deterministic(dev)
    runs, counts = [], []
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):
            tr = Trainer(model, AdamWConfig(), tc, device=dev)
            tr.init()
            reset_launch_counts()
            tr.run()
            counts.append(launch_counts())
            runs.append(tr)
        peak = torch.cuda.max_memory_allocated(dev)
        theirs = dict(pol.tree_flatten_with_path(runs[1].state.params))
        differ = [pol.path_str(p) for p, t in
                  pol.tree_flatten_with_path(runs[0].state.params)
                  if not torch.equal(t, theirs[p])]
        del theirs
        share = attention_share(runs[-1])
    finally:
        torch.use_deterministic_algorithms(False)
    losses = [[m["loss"] for m in tr.metrics_log[:TRAIN_BF16_STEPS]]
              for tr in runs]
    step_s = [[m["sec"] for m in tr.metrics_log[:TRAIN_BF16_STEPS]]
              for tr in runs]
    del runs, tr
    torch.cuda.empty_cache()
    shutil.rmtree(str(TRAIN_DIR) + "_bf16", ignore_errors=True)
    med = statistics.median(step_s[0][1:] + step_s[1][1:])
    res = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "bfloat16",
           "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "steps": TRAIN_BF16_STEPS, "losses": losses[0],
           "step_ms": med * 1e3, "first_step_ms": step_s[0][0] * 1e3,
           "step_ms_each": [[s * 1e3 for s in run] for run in step_s],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
           "peak_bytes": peak, "attention": share,
           "launches": {k: counts[0][k] for k in ("flash_attention",
                                                   "flash_attention_bwd")}}
    if losses[0] != losses[1] or differ:
        raise AssertionError(f"bf16 training: two runs from the same "
                             f"parameters differ: losses {losses}, params "
                             f"{differ[:8]}")
    if not all(math.isfinite(x) for x in losses[0]):
        raise AssertionError(f"bf16 training: losses not finite: {losses}")
    want = {k: v * TRAIN_BF16_STEPS for k, v in flash_per_step(cfg).items()}
    for c in counts:
        got = {k: c[k] for k in want}
        if got != want:
            raise AssertionError(f"bf16 training launched {got}, not "
                                 f"{want}")
    return res


def train_card_vs_cpu(dev, cfg=None, twins: bool = False) -> dict:
    """``cfg`` (the small checkpoint config unless given; phase 4 gives
    reduced gemma3, gemma2 and the two MoE archs) trained TRAIN_CPU_STEPS
    steps in f32 on the card and on the CPU from the same parameters
    (drawn on the CPU): losses within TRAIN_LOSS_TOL relative (cuBLAS and
    the CPU's BLAS sum in other orders; the warm-up's learning rates, 0
    then 3e-6 and 6e-6, keep the parameters within a few 1e-6 of each
    other whatever the updates, so the losses can only part by
    rounding).  ``twins`` trains on the card twice with torch's kernels
    deterministic: the two runs' losses and parameters must be equal bit
    for bit."""
    import torch
    from repro_torch.core import policy as pol
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, init_moments
    from repro_torch.train.state import new_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = cfg or ckpt_config(small=True)
    model = Model(cfg, compute_dtype=torch.float32)
    g = torch.Generator()
    g.manual_seed(TRAIN_SEED)
    params = model.init_params(g, "cpu")
    losses, finals = {}, []
    runs = ("cuda", "cuda_twin", "cpu") if twins else ("cuda", "cpu")
    try:
        if twins:
            from repro_torch.launch.train import deterministic
            deterministic(dev)
        for d in runs:
            if d == "cpu":
                torch.use_deterministic_algorithms(False)
            tr = Trainer(model, AdamWConfig(),
                         TrainerConfig(steps=TRAIN_CPU_STEPS, ckpt_every=0,
                                       ckpt_dir=str(TRAIN_DIR) + "_" + d,
                                       seed=TRAIN_SEED,
                                       global_batch=TRAIN_CPU_BATCH,
                                       seq_len=TRAIN_CPU_SEQ),
                         device=d.split("_")[0])
            p = pol.tree_map(lambda t: t.to(tr.device), params)
            tr.state = new_state(p, *init_moments(p, AdamWConfig()),
                                 TRAIN_SEED, tr.device)
            tr.run()
            losses[d] = [m["loss"] for m in tr.metrics_log]
            if d.startswith("cuda"):
                finals.append(pol.tree_flatten_with_path(tr.state.params))
            shutil.rmtree(str(TRAIN_DIR) + "_" + d, ignore_errors=True)
    finally:
        torch.use_deterministic_algorithms(False)
    if twins and (losses["cuda"] != losses.pop("cuda_twin") or not all(
            torch.equal(a, b) for (_, a), (_, b) in zip(*finals))):
        raise AssertionError(f"training {cfg.name} on the card: two runs "
                             f"from the same parameters differ")
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    if not err <= TRAIN_LOSS_TOL:
        raise AssertionError(f"training {cfg.name} card vs CPU: losses "
                             f"{losses} differ by {err} relative")
    return {"arch": cfg.name, "losses": losses, "rel_err": err,
            "tolerance": TRAIN_LOSS_TOL, "twins_bitwise": twins}


def launch_train_on_card(arch: str = "llama3.2-3b",
                         own_process: bool = False) -> dict:
    """``repro_torch.launch.train --arch <arch> --crash-at-step 6 --steps
    10 --device cuda`` (the reduced config, bf16); it must return 0 after
    its crash.  With ``own_process`` it runs as users run it, ``python -m``
    in a fresh process, where the launcher's own ``CUBLAS_WORKSPACE_CONFIG``
    must come before CUDA starts.  Else through its ``main`` in this
    process, as ``launch_serve`` runs its launcher (a process of its own
    pays about 20 s to reach the card, for about 2 s of training); the
    launcher turns torch's deterministic algorithms on, and they are turned
    off after it."""
    import torch
    argv = ["--arch", arch, "--crash-at-step", "6", "--steps", "10",
            "--device", "cuda"]
    t0 = time.perf_counter()
    if own_process:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop("CUBLAS_WORKSPACE_CONFIG", None)
        done = subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.train"] + argv, cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        rc, out, err = done.returncode, done.stdout, done.stderr
    else:
        from repro_torch.launch import train as tlaunch
        said = io.StringIO()
        try:
            with contextlib.redirect_stdout(said):
                rc = tlaunch.main(argv)
        finally:
            torch.use_deterministic_algorithms(False)
        out, err = said.getvalue(), ""
    lines = out.splitlines()
    res = {"arch": arch, "rc": rc, "own_process": own_process,
           "seconds": time.perf_counter() - t0, "lines": lines[-8:]}
    if rc != 0 or "CRASH injected at step 6" not in out:
        raise AssertionError(f"launch.train --arch {arch} on the card: rc "
                             f"{rc}\n{out[-2000:]}\n{err[-4000:]}")
    return res


# ----------------------------------------------------------------------
# Phase 16: gemma3-27b and gemma2-9b trained at their published widths
# ----------------------------------------------------------------------

# depth cut for the card's memory and the run's time, widths as published:
# gemma3-27b two local layers (window 1024; 2,235,067,136 parameters,
# 35.8 GB of f32 params, grads and moments), two sequences of 2048 tokens
# a step; gemma2-9b one local and one global layer (head width 256,
# softcaps 50 and 30; 1,313,883,648 parameters, 21.0 GB), one sequence of
# 8192 tokens a step
GEMMA_TRAIN = {"gemma3-27b": {"layers": 2, "batch": 2, "seq": 2048},
               "gemma2-9b": {"layers": 2, "batch": 1, "seq": 8192}}
# each of the twin runs, per dtype; cut from 4 for the run's time (with 4
# the whole run took 991.3 s on an NVIDIA H100 80GB HBM3 at 700 W), then
# from 3 when phase 19 came (3 steps: this phase 43.3 s of a 1036.6 s
# run; 2 steps: 36.7 s)
GEMMA_TRAIN_STEPS = 2
GEMMA_TRAIN_DIR = ROOT / "build" / "chip_smoke_gemma_train"


def flash_per_step(cfg) -> dict:
    """The flash launches one training step makes: the forward once an
    attention call (an audio cross layer makes two, an encoder layer one)
    and again for each call a remat recomputes (a superblock's and an
    encoder layer's; the remainder's layers are not rematerialized, as in
    the reference), the backward once an attention call.  An xLSTM layer
    makes none."""
    from repro_torch.models import backbone as B
    pattern, n_super, rem = cfg.pattern_plan()

    def calls(tags):
        return sum(0 if B.parse_tag(t)[0] in ("mlstm", "slstm") else
                   2 if B.parse_tag(t)[1] == "cross" and
                   cfg.family == "audio" else 1 for t in tags)
    fwd = n_super * calls(pattern) + calls(rem) + cfg.encoder_layers
    remat = n_super * calls(pattern) + cfg.encoder_layers \
        if B.REMAT["policy"] != "none" else 0
    return {"flash_attention": fwd + remat, "flash_attention_bwd": fwd}


def train_twins(dev, cfg, batch: int, seq: int, steps: int,
                ckpt_dir: Path, share=attention_share) -> dict:
    """``cfg`` trained ``steps`` steps of ``batch`` x ``seq`` tokens in f32
    and then in bf16 (as the launcher trains on a card), each dtype twice
    from the same parameters (the trainer's seeded init), torch's kernels
    deterministic, no checkpoint inside the steps.  The twins' losses and
    final parameters must be equal bit for bit and finite, and each run
    must launch flash_attention and flash_attention_bwd as
    ``flash_per_step`` says a step.  Returns per dtype the step ms (median
    past the first), tokens/s, peak memory and the second twin's last
    step's attention share (CUDA events around the flash launches, which
    change no bit; ``share`` runs that step, ``attention_share`` or a
    function that also times other calls)."""
    import torch
    from repro_torch.core import policy as pol
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.train import deterministic
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    per_step = flash_per_step(cfg)
    tc = TrainerConfig(steps=steps, ckpt_every=0, ckpt_dir=str(ckpt_dir),
                       seed=TRAIN_SEED, global_batch=batch, seq_len=seq)
    out = {"flash_per_step": per_step}
    deterministic(dev)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            model = Model(cfg, compute_dtype=dtype)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            losses, step_s, counts, first = [], [], [], None
            for run in range(2):
                # a first call into torch's checkpoint leaves an import's
                # frames, and the locals of the step that made it, to the
                # garbage collector: collect them before a state is made
                gc.collect()
                torch.cuda.empty_cache()
                tr = Trainer(model, AdamWConfig(), tc, device=dev)
                tr.init()
                before = launch_counts()
                if run == 0:
                    tr.run()
                else:
                    # the second twin's last step is the timed one
                    tr.run(steps - 1)
                    shares = share(tr)
                counts.append({k: v - before[k]
                               for k, v in launch_counts().items()})
                losses.append([m["loss"] for m in tr.metrics_log])
                step_s.append([m["sec"] for m in tr.metrics_log])
                if run == 0:
                    # the first run's final parameters, in pinned host
                    # memory (a non-blocking copy pins its output): two
                    # states would not fit on the card beside each other
                    first = {p: t.to("cpu", non_blocking=True) for p, t in
                             pol.tree_flatten_with_path(tr.state.params)}
                    torch.cuda.synchronize()
                    del tr
            peak = torch.cuda.max_memory_allocated(dev)
            differ = [pol.path_str(p) for p, t in
                      pol.tree_flatten_with_path(tr.state.params)
                      if not torch.equal(t, first[p].to(dev,
                                                       non_blocking=True))]
            del first, tr
            torch.cuda.empty_cache()
            name = str(dtype).split(".")[-1]
            med = statistics.median(step_s[0][1:] + step_s[1][1:])
            out[name] = {"losses": losses[0], "step_ms": med * 1e3,
                         "first_step_ms": step_s[0][0] * 1e3,
                         "step_ms_each": [[x * 1e3 for x in r]
                                          for r in step_s],
                         "tokens_per_s": batch * seq / med,
                         "peak_bytes": peak, "attention": shares,
                         "launches": {k: counts[0][k] for k in per_step}}
            if losses[0] != losses[1] or differ:
                raise AssertionError(f"{cfg.name} {name} training: two runs "
                                     f"from the same parameters differ: "
                                     f"losses {losses}, params {differ[:8]}")
            if not all(math.isfinite(x) for x in losses[0]):
                raise AssertionError(f"{cfg.name} {name} training: losses "
                                     f"not finite: {losses}")
            want = {k: v * steps for k, v in per_step.items()}
            for c in counts:
                got = {k: c[k] for k in want}
                if got != want:
                    raise AssertionError(f"{cfg.name} {name} training "
                                         f"launched {got}, not {want}")
            if shares["launches"] != per_step:
                raise AssertionError(f"{cfg.name} {name}: the timed step "
                                     f"made {shares['launches']} flash "
                                     f"launches")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def gemma_train_one(dev, arch: str) -> dict:
    """Phase 16 for one arch: GEMMA_TRAIN's depth and tokens at the
    published widths, GEMMA_TRAIN_STEPS steps a twin (``train_twins``)."""
    from repro_torch.configs import registry
    spec = GEMMA_TRAIN[arch]
    cfg = dataclasses.replace(registry.get(arch), n_layers=spec["layers"])
    pattern, n_super, rem = cfg.pattern_plan()
    out = {"arch": arch, "layers": cfg.n_layers, "params": cfg.param_count(),
           "tags": list(pattern * n_super + rem),
           "window": cfg.window, "attn_softcap": cfg.attn_softcap,
           "final_softcap": cfg.final_softcap,
           "head_dim": cfg.resolved_head_dim, "global_batch": spec["batch"],
           "seq_len": spec["seq"], "steps": GEMMA_TRAIN_STEPS}
    out.update(train_twins(dev, cfg, spec["batch"], spec["seq"],
                           GEMMA_TRAIN_STEPS, GEMMA_TRAIN_DIR))
    return out


def gemma_train_phase(dev) -> dict:
    """Phase 16: gemma3-27b and gemma2-9b trained at their published widths
    (``gemma_train_one``), then the launcher on the card for gemma2-9b."""
    t0 = time.perf_counter()
    out = {arch: gemma_train_one(dev, arch) for arch in GEMMA_TRAIN}
    out["launch_train"] = launch_train_on_card("gemma2-9b")
    out["phase_s"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# Phase 17: the MoE archs served at their published widths
# ----------------------------------------------------------------------

# depth cut for the card's memory, widths as published: dbrx-132b 2 of
# its 40 layers in f32 (7,751,301,120 parameters, 31.0 GB); maverick one
# superblock, a dense and an MoE layer, in bf16 (in f32 its 74.7 GB
# would not fit beside the caches)
MOE_SERVE = {
    "dbrx-132b": {"layers": 2, "dtype": "float32"},
    "llama4-maverick-400b-a17b": {"layers": 2, "dtype": "bfloat16"},
}
# 4096: one router group (capacity 1280 and 40); the first request, which
# finishes before the crash, is the shorter, so the 4096-token log is live
# at the crash and re-prefilled (with its decoded tokens, 4112 tokens by
# then, all but the last in one group of 4111: capacity 1285 and 41)
MOE_PROMPTS = (1024, 4096)
MOE_STEPS = 8                  # before the finish, after it, after recovery
MOE_S_MAX = 4096 + 4 * MOE_STEPS
MOE_BWD_TOKENS = 4096          # the backward twins' sequence


def decode_bound_ms(cfg, params) -> dict:
    """The weight reads of one decode step, every expert's included (the
    dispatch runs each expert's capacity slots, one at decode): every
    parameter byte but the embedding table's when the head is untied (one
    row is read) and the encoder's (decode reads the cached cross keys and
    values instead), over HBM_BYTES_PER_S; and the experts' alone."""
    from repro_torch.core.policy import path_str, tree_flatten_with_path
    total = experts = 0
    for path, t in tree_flatten_with_path(params):
        name = path_str(path)
        if (name == "embed" and not cfg.tie_embeddings) or \
                name.startswith("enc_"):
            continue
        nbytes = t.numel() * t.element_size()
        total += nbytes
        if "moe" in name and any(w in name for w in ("w_gate", "w_up",
                                                    "w_down")):
            experts += nbytes
    return {"weight_bytes": total, "expert_bytes": experts,
            "bound_ms": 1e3 * total / HBM_BYTES_PER_S,
            "expert_bound_ms": 1e3 * experts / HBM_BYTES_PER_S}


def moe_serve_one(dev, arch: str) -> dict:
    """Phase 17 for one arch: ``serve_recover.run``'s MoE rule at the
    published widths (MOE_SERVE's depth and dtype), then the same 4096
    token prefill twice for bitwise-equal logits.  Every prefill (the
    admissions on the engine, its twin and the crash-free prefill engine,
    and each re-prefill group) must launch the flash kernel once a
    layer."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.backbone import init_params
    from repro_torch.models.model import Model
    from repro_torch.models.moe import capacity
    from repro_torch.serve_recover import prompts_for
    spec = MOE_SERVE[arch]
    dtype = getattr(torch, spec["dtype"])
    cfg = dataclasses.replace(registry.get(arch), n_layers=spec["layers"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev, dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out, calls = counted_twin_run(
        dev, cfg, params, prompt_lens=MOE_PROMPTS, max_batch=3,
        s_max=MOE_S_MAX, steps=MOE_STEPS, max_requests=16,
        compute_dtype=dtype)
    # admissions on the engine and its twin, the new request on those and
    # on the crash-free prefill engine, each re-prefill group, and the
    # crash-free prefill of each live log (its group's length); each of
    # every logged token but the last
    prefills = {}
    for n in MOE_PROMPTS:
        prefills[n - 1] = prefills.get(n - 1, 0) + 2
    prefills[MOE_PROMPTS[-1] - 1] += 3
    for grp in out["groups"]:
        prefills[grp["prefilled"]] = prefills.get(grp["prefilled"], 0) + 1 \
            + len(grp["slots"])
    check_flash_calls(cfg, out, calls, {("global", n): cfg.n_layers * times
                                        for n, times in prefills.items()})
    # routing is deterministic: the same prefill twice, bitwise (and timed
    # warm: the engine's first admission also pays the libraries' first
    # calls)
    model = Model(cfg, compute_dtype=dtype)
    tokens = torch.as_tensor(prompts_for(MOE_PROMPTS[-1:], cfg.vocab,
                                         SERVE_SEED)[0][None]).to(dev)
    twice, warm = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        twice.append(model.prefill(params, {"tokens": tokens})[0])
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    if not torch.equal(*twice):
        raise AssertionError(f"{arch}: the same prefill twice gave "
                             f"different logits")
    if not bool(torch.isfinite(twice[0]).all()):
        raise AssertionError(f"{arch}: prefill logits not finite")
    bound = decode_bound_ms(cfg, params)
    del params, twice, model
    torch.cuda.empty_cache()
    out.update({"init_params_s": init_s,
                "decode_bound": bound, "prefill_twice_equal": True,
                "prefill_warm_s": warm,
                "prefill_warm_tokens_per_s": MOE_PROMPTS[-1] / min(warm),
                "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
                "expert_d_ff": cfg.moe.expert_d_ff or cfg.d_ff,
                "shared_expert": cfg.moe.shared_expert,
                "capacity": {n: capacity(n, cfg.moe) for n in MOE_PROMPTS}})
    return out


def layer_backward_twins(dev, cfg, tag: str, params, inputs: dict,
                         r) -> dict:
    """``tag``'s layer of ``cfg`` at ``params`` in train mode on
    ``inputs`` (``x``, and ``ctx`` for a cross layer), no optimizer:
    forward and backward of ``(y * r).sum()``, twice in f32 and twice in
    bf16 compute, torch's kernels deterministic.  Every gradient (the
    parameters' and the inputs') must be equal bit for bit between a
    dtype's two runs, and finite; one flash forward and one backward
    launch a run.  Returns per dtype the runs' ms, the launches and each
    gradient's largest |value|."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.train import deterministic
    from repro_torch.models import backbone as B
    from repro_torch.core.policy import (path_str, tree_flatten_with_path,
                                         tree_unflatten)
    names = [path_str(p) for p, _ in tree_flatten_with_path(params)]
    names += list(inputs)
    out = {}
    deterministic(dev)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            grads, ms, counts = None, [], []
            for _ in range(2):
                torch.cuda.empty_cache()
                leaves = [t.detach().requires_grad_() for _, t in
                          tree_flatten_with_path(params)]
                ins = {k: v.to(dtype).requires_grad_()
                       for k, v in inputs.items()}
                p = tree_unflatten(params, leaves)
                before = launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y, _ = B.apply_layer(cfg, tag, p, ins["x"], mode="train",
                                     ctx=ins.get("ctx"))
                g = torch.autograd.grad((y.float() * r).sum(),
                                        leaves + list(ins.values()))
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                counts.append({k: v - before[k] for k, v in
                               launch_counts().items()
                               if k.startswith("flash")})
                if grads is None:
                    grads = g
                    continue
                differ = [n for n, a, b in zip(names, grads, g)
                          if not torch.equal(a, b)]
                finite = all(bool(torch.isfinite(a).all()) for a in g)
            name = str(dtype).split(".")[-1]
            out[name] = {"fwd_bwd_ms": ms, "launches": counts[0],
                         "grads_bitwise": not differ, "finite": finite,
                         "grad_max": {n: float(a.abs().max())
                                      for n, a in zip(names, g)}}
            del grads, g, leaves, ins, y
            if differ or not finite:
                raise AssertionError(f"{cfg.name} {tag} layer {name}: two "
                                     f"forward and backward runs differ in "
                                     f"gradients {differ[:8]} (finite "
                                     f"{finite})")
            for c in counts:
                if c != {"flash_attention": 1, "flash_attention_bwd": 1}:
                    raise AssertionError(f"{cfg.name} {tag} layer {name}: "
                                         f"flash launches {c} a run")
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    return out


def moe_backward_twins(dev) -> dict:
    """One dbrx-132b MoE layer at its published widths (12.7 GB of expert
    weights in f32) on 1 x MOE_BWD_TOKENS tokens, its forward and backward
    twice a dtype (``layer_backward_twins``)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import backbone as B
    from repro_torch.core.policy import tree_flatten_with_path, tree_map
    cfg = dataclasses.replace(registry.get("dbrx-132b"), n_layers=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED)
    params = tree_map(lambda spec: B.init_leaf(spec, gen, dev),
                      B._leaf_specs(B.layer_shapes(cfg, "moe")))
    x = torch.randn((1, MOE_BWD_TOKENS, cfg.d_model), generator=gen,
                    device=dev)
    r = torch.randn(x.shape, generator=gen, device=dev)
    n_params = sum(t.numel() for _, t in tree_flatten_with_path(params))
    out = {"arch": cfg.name, "tokens": MOE_BWD_TOKENS, "params": n_params}
    out.update(layer_backward_twins(dev, cfg, "moe", params, {"x": x}, r))
    del params, x, r
    torch.cuda.empty_cache()
    return out


def moe_phase(dev) -> dict:
    """Phase 17: dbrx-132b and maverick served at their published widths,
    then the dbrx-width MoE layer's backward twins."""
    t0 = time.perf_counter()
    out = {}
    out["dbrx-132b"] = moe_serve_one(dev, "dbrx-132b")
    out["backward"] = moe_backward_twins(dev)
    arch = "llama4-maverick-400b-a17b"
    out[arch] = moe_serve_one(dev, arch)
    out["phase_s"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# Phase 18: the context archs, llama-3.2-vision-90b and whisper-large-v3
# ----------------------------------------------------------------------

# before the finish, after it, after recovery; cut from 8 when phase 19
# came (whisper decodes at about 82 ms a slot-step)
CONTEXT_STEPS = 4
# widths as published; vision's depth cut for the card's memory to one
# superblock, 4 dense layers and the cross layer of its 100 (6,379,626,497
# parameters, 25.5 GB in f32); whisper whole, 32 encoder and 32 decoder
# layers (1,954,163,200 parameters, 7.82 GB), s_max its text context
CONTEXT_SERVE = {
    "llama-3.2-vision-90b": {"layers": 5, "prompts": (1024, 4096),
                             "s_max": 4096 + 4 * CONTEXT_STEPS},
    "whisper-large-v3": {"layers": 32, "prompts": (64, 224), "s_max": 448},
}
# (c): the prompt a seeded context's prefill-vs-decode rule is held at
CONTEXT_CHECK = {"llama-3.2-vision-90b": 1023, "whisper-large-v3": 223}
# (d): whisper trained at its published widths and depth, and one vision
# cross layer's forward and backward over its 1600 patches
CONTEXT_TRAIN = {"batch": 2, "seq": 448, "steps": 3}
CONTEXT_LAYER_TOKENS = 4096
CONTEXT_TRAIN_DIR = ROOT / "build" / "chip_smoke_context_train"


def attention_calls(cfg) -> dict:
    """The flash calls one prefill (or training forward) makes, by query
    length: each decoder layer once, an audio cross layer twice (self,
    then cross), at the prompt's length; each encoder layer once at
    ``encoder_seq``.  {"decoder": calls at the prompt, "encoder": calls at
    encoder_seq}."""
    from repro_torch.models.backbone import parse_tag
    pattern, n_super, rem = cfg.pattern_plan()
    tags = list(pattern) * n_super + list(rem)
    dec = sum(2 if parse_tag(t)[1] == "cross" and cfg.family == "audio"
              else 1 for t in tags)
    return {"decoder": dec, "encoder": cfg.encoder_layers}


def open_gates(params) -> int:
    """Set every ``xgate`` leaf to 1 in place (the init's 0 shuts the image
    layers: tanh(0) = 0); returns how many were set."""
    from repro_torch.core.policy import path_str, tree_flatten_with_path
    n = 0
    for path, t in tree_flatten_with_path(params):
        if path_str(path).endswith("xgate"):
            t.fill_(1.0)
            n += 1
    return n


def context_serve_one(dev, arch: str, params, cfg) -> dict:
    """Phase 18 (a)/(b) for one arch: the twin protocol
    (``serve_recover.run``, the dense rule of phase 15) at CONTEXT_SERVE's
    depth, f32: prompts, CONTEXT_STEPS steps, the first request finished,
    CONTEXT_STEPS more, a crash and the re-prefill, CONTEXT_STEPS after
    it.  The engine prefills with a context of zeros, as the reference's
    does.  Every prefill (admissions on both engines, the new request,
    each re-prefill group) must call the flash kernel once a decoder
    layer, twice an audio cross layer and once an encoder layer
    (``attention_calls``: 5 a vision prefill, 96 a whisper one)."""
    spec = CONTEXT_SERVE[arch]
    calls = attention_calls(cfg)
    per_prefill = calls["decoder"] + calls["encoder"]
    out, seen = counted_twin_run(
        dev, cfg, params, prompt_lens=spec["prompts"], max_batch=2,
        s_max=spec["s_max"], steps=CONTEXT_STEPS, max_requests=16)
    prefills = {}
    for n in list(spec["prompts"]) + [spec["prompts"][-1]]:
        prefills[n - 1] = prefills.get(n - 1, 0) + 2
    for grp in out["groups"]:
        prefills[grp["prefilled"]] = prefills.get(grp["prefilled"], 0) + 1
        grp["flash_launches"] = per_prefill
    want = {("global", n): calls["decoder"] * times
            for n, times in prefills.items()}
    if calls["encoder"]:
        key = ("global", cfg.encoder_seq)
        want[key] = want.get(key, 0) + calls["encoder"] * sum(
            prefills.values())
    check_flash_calls(cfg, out, seen, want)
    out.update({"flash_launches_per_prefill": per_prefill,
                "decode_bound": decode_bound_ms(cfg, params),
                "context_len": cfg.encoder_seq if cfg.family == "audio"
                else cfg.context_seq})
    return out


def context_cross_checks(dev, arch: str, params, cfg) -> dict:
    """Phase 18 (c): the cross path with a real context, every xgate 1
    (set by the caller).  A batch of 2 prompts of n + 1 tokens
    (CONTEXT_CHECK's n) with the pipeline's seeded ``context_at`` /
    ``frames_at`` (0.02 N(0, 1)), held by ``prefill_checks`` with
    ``attention_calls`` launches a prefill."""
    import torch
    from repro_torch.data.pipeline import Pipeline
    n = CONTEXT_CHECK[arch]
    batch = Pipeline(cfg, 2, n + 1, seed=SERVE_SEED).batch_at(0)
    key = "frames" if cfg.family == "audio" else "context"
    full = {"tokens": torch.from_numpy(batch["tokens"]).to(dev),
            key: torch.from_numpy(batch[key]).to(dev)}
    calls = attention_calls(cfg)
    out = {"tokens": n + 1, "batch": 2, "context_key": key}
    out.update(prefill_checks(dev, arch, cfg, params, full, n,
                              calls["decoder"] + calls["encoder"]))
    return out


def prefill_checks(dev, label: str, cfg, params, full: dict, n: int,
                   per_prefill: int) -> dict:
    """``Model.prefill`` of the batch ``full`` (tokens n + 1 long) in f32
    and in bf16 compute: through the kernels against the same prefill
    with ``flash_attention_plain`` substituted (logits within 1e-4 of the
    largest |logit| in f32, FLASH_PREFILL_TOL in bf16; ``per_prefill``
    flash launches a prefill); in f32 a prefill of n tokens and
    ``decode_step`` at n against the prefill of n + 1 (last logits within
    1e-4, the reference's own rule); the same prefill twice, bitwise
    equal.  Returns per dtype the errors and the prefill seconds."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers
    from repro_torch.models.model import Model
    from repro_torch.serve_recover import LOGIT_TOL

    def prefill(model, b, attention, s_max=None):
        layers.flash_attention = attention
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = FA.flash_attention.launches
            out = model.prefill(params, b, s_max=s_max)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, \
                FA.flash_attention.launches - before
        finally:
            layers.flash_attention = FA.flash_attention
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = Model(cfg, compute_dtype=dtype)
        name = str(dtype).split(".")[-1]
        prefill(model, full, FA.flash_attention_plain)   # first-use set-up
        (got, _), kernel_s, launched = prefill(model, full,
                                               FA.flash_attention)
        (again, _), _, _ = prefill(model, full, FA.flash_attention)
        (want, _), plain_s, _ = prefill(model, full,
                                        FA.flash_attention_plain)
        if launched != per_prefill:
            raise AssertionError(f"{label} {name}: a prefill launched "
                                 f"flash_attention {launched} times, not "
                                 f"{per_prefill}")
        if not (bool(torch.isfinite(got).all())
                and got.shape == (full["tokens"].shape[0],
                                  cfg.vocab_padded)):
            raise AssertionError(f"{label} {name}: prefill logits not "
                                 f"finite or misshapen")
        v = cfg.vocab
        err = float((got[:, :v] - want[:, :v]).abs().max()) / float(
            want[:, :v].abs().max())
        tol = LOGIT_TOL if dtype == torch.float32 else FLASH_PREFILL_TOL
        row = {"kernel_vs_plain": err, "tolerance": tol,
               "launches": launched, "prefill_s": kernel_s,
               "plain_prefill_s": plain_s,
               "repeat_bitwise": bool(torch.equal(got, again))}
        if not err <= tol:
            raise AssertionError(f"{label} {name}: kernel prefill logits "
                                 f"differ from the plain attention's by "
                                 f"{err} of the largest |logit|")
        if not row["repeat_bitwise"]:
            raise AssertionError(f"{label} {name}: the same prefill twice "
                                 f"gave different logits")
        if dtype == torch.float32:
            short = dict(full, tokens=full["tokens"][:, :n])
            (_, kv), _, _ = prefill(model, short, FA.flash_attention,
                                    s_max=n + 1)
            inc, _ = model.decode_step(params, kv, full["tokens"][:, n], n)
            dec = float((inc[:, :v] - got[:, :v]).abs().max()) / float(
                got[:, :v].abs().max())
            row["decode_vs_prefill"] = dec
            del kv
            if not dec <= LOGIT_TOL:
                raise AssertionError(f"{label}: prefill + decode at {n} "
                                     f"differs from the prefill of {n + 1} "
                                     f"by {dec} of the largest |logit|")
        out[name] = row
        del got, again, want
        torch.cuda.empty_cache()
    return out


def context_train_whisper(dev) -> dict:
    """Phase 18 (d): whisper-large-v3 at its published widths and depth,
    CONTEXT_TRAIN's steps on 2 x 448 tokens with 2 x 1500 frames (the
    pipeline's ``frames_at``) a twin (``train_twins``: f32 and bf16, bitwise
    twins, flash launches a step counted with the encoder's and the cross
    layers')."""
    from repro_torch.configs import registry
    cfg = registry.get("whisper-large-v3")
    spec = CONTEXT_TRAIN
    out = {"arch": cfg.name, "params": cfg.param_count(),
           "encoder_layers": cfg.encoder_layers, "layers": cfg.n_layers,
           "frames": cfg.encoder_seq, "global_batch": spec["batch"],
           "seq_len": spec["seq"], "steps": spec["steps"]}
    out.update(train_twins(dev, cfg, spec["batch"], spec["seq"],
                           spec["steps"], CONTEXT_TRAIN_DIR))
    return out


def context_layer_twins(dev) -> dict:
    """Phase 18 (d): one llama-3.2-vision-90b cross layer at its published
    widths (855,638,017 parameters) on 1 x CONTEXT_LAYER_TOKENS tokens
    over 1600 image patches (0.02 N(0, 1)), xgate 1: its forward and
    backward twice a dtype (``layer_backward_twins``), every gradient of
    the cross attention's weights and the gate non-zero."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import backbone as B
    from repro_torch.core.policy import tree_flatten_with_path, tree_map
    cfg = registry.get("llama-3.2-vision-90b")
    tag = "dense:cross"
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED)
    params = tree_map(lambda spec: B.init_leaf(spec, gen, dev),
                      B._leaf_specs(B.layer_shapes(cfg, tag)))
    open_gates(params)
    x = torch.randn((1, CONTEXT_LAYER_TOKENS, cfg.d_model), generator=gen,
                    device=dev)
    ctx = 0.02 * torch.randn((1, cfg.context_seq, cfg.d_model),
                             generator=gen, device=dev)
    r = torch.randn(x.shape, generator=gen, device=dev)
    out = {"arch": cfg.name, "tokens": CONTEXT_LAYER_TOKENS,
           "patches": cfg.context_seq,
           "params": sum(t.numel() for _, t in
                         tree_flatten_with_path(params))}
    out.update(layer_backward_twins(dev, cfg, tag, params,
                                    {"x": x, "ctx": ctx}, r))
    for name in ("float32", "bfloat16"):
        zero = [n for n, m in out[name]["grad_max"].items()
                if ("xattn" in n or n == "xgate") and not m > 0]
        if zero:
            raise AssertionError(f"vision cross layer {name}: zero "
                                 f"gradients {zero}")
    del params, x, ctx, r
    torch.cuda.empty_cache()
    return out


def context_phase(dev) -> dict:
    """Phase 18: each context arch served at its published widths
    (``context_serve_one``), then its cross path with a seeded context and
    open gates (``context_cross_checks``) on the same parameters; whisper
    trained at its published widths and depth; one vision cross layer's
    backward twins."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.backbone import init_params
    t_phase = time.perf_counter()
    out = {}
    for arch, spec in CONTEXT_SERVE.items():
        cfg = dataclasses.replace(registry.get(arch),
                                  n_layers=spec["layers"])
        gen = torch.Generator(device=dev)
        gen.manual_seed(SERVE_SEED)
        t0 = time.perf_counter()
        params = init_params(cfg, gen, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        serve = context_serve_one(dev, arch, params, cfg)
        serve["init_params_s"] = init_s
        gates = open_gates(params)
        cross = context_cross_checks(dev, arch, params, cfg)
        cross["gates_opened"] = gates
        out[arch] = {"serve": serve, "cross": cross}
        del params
        torch.cuda.empty_cache()
    out["train"] = context_train_whisper(dev)
    out["layer_twins"] = context_layer_twins(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# Phase 19: hymba-1.5b's hybrid layers, served and trained whole
# ----------------------------------------------------------------------

HYMBA = "hymba-1.5b"
# (a): whole (32 layers, 1,352,603,200 parameters, 5.41 GB in f32).  The
# admissions prefill 1024 and 4096 tokens (8 and 32 scan chunks of 128;
# 4096 wraps the local layers' 1024-slot rings) and 999 (no multiple of
# 128: one chunk, the chunk rule's fallback); the first request finishes
# before the crash, the new one after it takes the last length
HYMBA_PROMPTS = (1025, 4097, 1000)
HYMBA_STEPS = 4                # before the finish, after it, after recovery
HYMBA_S_MAX = 4097 + 4 * HYMBA_STEPS
HYMBA_STATE_TOL = 1e-4         # (b): a slot's ssm, conv against a prefill
HYMBA_CHECK = 1024             # (c): prefill + decode at n against n + 1
# 3 steps a twin until phase 20 came (phase 19 68.7 s of a 957.6 s run
# on an NVIDIA H100 80GB HBM3 at 700 W)
HYMBA_TRAIN = {"batch": 2, "seq": 2048, "steps": 2}
HYMBA_TRAIN_DIR = ROOT / "build" / "chip_smoke_hymba_train"


class ScanEvents:
    """CUDA events around every call of the named functions, by label:
    by default the ``ssm_scan`` and ``ssm_step`` calls of
    ``models/ssm.py`` (the backbone calls them through the module), so a
    recurrence's device time inside a prefill, a decode step or a
    training step can be summed.  ``targets`` maps a label to (owner,
    attribute) pairs; a staticmethod (an autograd Function's backward,
    which autograd looks up on the class when it runs) stays one."""

    def __init__(self, targets=None):
        if targets is None:
            from repro_torch.models import ssm as S
            targets = {"scan": ((S, "ssm_scan"), (S, "ssm_step"))}
        self.targets = targets

    def __enter__(self):
        self.events, self._real = [], []
        for label, pairs in self.targets.items():
            for owner, name in pairs:
                real = vars(owner)[name]
                self._real.append((owner, name, real))
                fn = self._timed(label, getattr(owner, name))
                setattr(owner, name, staticmethod(fn)
                        if isinstance(real, staticmethod) else fn)
        return self

    def _timed(self, label, fn):
        import torch

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.append((label, start, end))
            return out
        return timed

    def __exit__(self, *exc):
        for owner, name, real in self._real:
            setattr(owner, name, real)

    def ms(self, label=None) -> float:
        return sum(s.elapsed_time(e) for lb, s, e in self.events
                   if label in (None, lb))

    def calls(self, label=None) -> int:
        return sum(label in (None, lb) for lb, _, _ in self.events)


def hymba_scan_shares(dev, cfg, params) -> dict:
    """(a): the scan's share of a 4096-token prefill and of a decode step
    at position 4096 (batch 1, f32, warm): CUDA events around each
    ``ssm_scan`` / ``ssm_step`` call summed, against events around the
    whole call; the median of three by the call's time."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serve_recover import prompts_for
    model = Model(cfg, compute_dtype=torch.float32)
    tokens = torch.as_tensor(prompts_for((4096,), cfg.vocab, SERVE_SEED)[0][
        None]).to(dev)
    _, kv = model.prefill(params, {"tokens": tokens}, s_max=HYMBA_S_MAX)
    tok = tokens[:, -1]
    out = {}
    for name, fn in (
            ("prefill", lambda: model.prefill(params, {"tokens": tokens},
                                              s_max=HYMBA_S_MAX)),
            ("decode", lambda: model.decode_step(params, kv, tok, 4096))):
        fn()                                     # warm
        rows = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with ScanEvents() as ev:
                start.record()
                fn()
                end.record()
            end.synchronize()
            rows.append({"ms": start.elapsed_time(end), "scan_ms": ev.ms(),
                         "scan_calls": ev.calls()})
        row = sorted(rows, key=lambda r: r["ms"])[1]
        row["share"] = row["scan_ms"] / row["ms"]
        out[name] = row
    del kv
    torch.cuda.empty_cache()
    return out


def hymba_serve(dev, cfg, params) -> dict:
    """Phase 19 (a) and (b): the dense twin rule (``serve_recover.run``,
    phase 15's tolerances, now over the ``ssm`` state and ``conv`` tail
    too, each against its own largest |value|) at HYMBA_PROMPTS, f32:
    HYMBA_STEPS steps, the first request finished, as many, a crash and
    the re-prefill, as many again.  Every prefill calls the flash kernel once a
    layer (4 full, 28 windowed); ``scatter_rows`` launches once a cache
    leaf per admission and per re-prefill group.  (b): after the last
    step each live slot's ``ssm`` and ``conv`` caches, on the recovered
    engine and on its twin, equal a fresh prefill of that slot's logged
    tokens but the last within HYMBA_STATE_TOL of their largest |value|.
    Then the scan's share of a prefill and of a decode step."""
    import numpy as np
    import torch
    from repro_torch.models.backbone import parse_tag
    from repro_torch.models.model import Model
    pattern, n_super, rem = cfg.pattern_plan()
    if rem:
        raise AssertionError(f"{cfg.name}: a remainder layer, not checked")
    tags = list(pattern) * n_super
    local = sum(parse_tag(t)[1] == "local" for t in tags)
    model = Model(cfg, compute_dtype=torch.float32)
    held = []

    def check(eng, twin):
        for name, e in (("recovered", eng), ("twin", twin)):
            for s in np.flatnonzero(e.slot_rid >= 0):
                n = int(e.pos[s]) - 1
                toks = e.tok_region.read_at([int(s)], slice(0, n)).to(dev)
                _, kv = model.prefill(params, {"tokens": toks},
                                      s_max=e.cfg.s_max)
                row = {"engine": name, "slot": int(s), "tokens": n}
                for leaf in ("ssm", "conv"):
                    err = top = 0.0
                    for pos, c in e.cache["blocks"].items():
                        x = c[leaf][:, s].float()
                        y = kv["blocks"][pos][leaf][:, 0].float()
                        err = max(err, float((x - y).abs().max()))
                        top = max(top, float(y.abs().max()))
                    row[leaf] = err / top
                held.append(row)
                del kv
    out, calls = counted_twin_run(
        dev, cfg, params, prompt_lens=HYMBA_PROMPTS, max_batch=3,
        s_max=HYMBA_S_MAX, steps=HYMBA_STEPS, max_requests=16, check=check)
    bad = [r for r in held if not max(r["ssm"], r["conv"])
           <= HYMBA_STATE_TOL]
    if bad or len(held) != 6:
        raise AssertionError(f"{cfg.name}: live slots' recurrent caches "
                             f"against a prefill of their logs but the "
                             f"last: {held}")
    # admissions on the engine and its twin (each prompt and the new
    # request), each re-prefill group, and (b)'s prefills; each of every
    # logged token but the last
    prefills = {}
    for n in list(HYMBA_PROMPTS) + [HYMBA_PROMPTS[-1]]:
        prefills[n - 1] = prefills.get(n - 1, 0) + 2
    for grp in out["groups"]:
        prefills[grp["prefilled"]] = prefills.get(grp["prefilled"], 0) + 1
        grp["flash_launches"] = len(tags)
    for row in held:
        prefills[row["tokens"]] = prefills.get(row["tokens"], 0) + 1
    want = {}
    for n, times in prefills.items():
        want[("local", n)] = local * times
        want[("global", n)] = (len(tags) - local) * times
    check_flash_calls(cfg, out, calls, want)
    leaves = sum(len(v) for v in model.cache_specs(1, 1)["blocks"].values())
    seats = 2 * (len(HYMBA_PROMPTS) + 1) + len(out["groups"])
    if out["launches"]["scatter_rows"] != leaves * seats:
        raise AssertionError(f"{cfg.name}: {out['launches']['scatter_rows']}"
                             f" scatter_rows launches, not one per cache "
                             f"leaf ({leaves}) per seating ({seats})")
    out.update({"flash_launches_per_prefill": len(tags),
                "local_layers": local, "global_layers": len(tags) - local,
                "cache_leaves": leaves, "seatings": seats,
                "state_vs_prefill": held,
                "decode_bound": decode_bound_ms(cfg, params),
                "scan": hymba_scan_shares(dev, cfg, params)})
    return out


def hymba_checks(dev, cfg, params) -> dict:
    """Phase 19 (c): a batch of 2 seeded prompts of HYMBA_CHECK + 1
    tokens (one scan chunk of 1025; its first 1024 tokens, 8 chunks, for
    the decode rule) held by ``prefill_checks``, 32 flash launches a
    prefill."""
    import numpy as np
    import torch
    from repro_torch.serve_recover import prompts_for
    toks = np.stack(prompts_for((HYMBA_CHECK + 1,) * 2, cfg.vocab,
                                SERVE_SEED + 1))
    full = {"tokens": torch.as_tensor(toks).to(dev)}
    out = {"tokens": HYMBA_CHECK + 1, "batch": 2}
    out.update(prefill_checks(dev, cfg.name, cfg, params, full, HYMBA_CHECK,
                              cfg.n_layers))
    return out


def hymba_scan_train(dev, cfg, step_ms: dict) -> dict:
    """Phase 19 (d): ``ssm_scan`` alone at the training step's shape (2 x
    2048 tokens of d_inner 1600, state 16; x and dt in the step's dtype),
    its forward with a gradient wanted and its forward and backward
    (each chunk recomputed), CUDA-event medians.  A step runs a layer's
    scan forward twice (the superblock's remat recomputes it) and its
    backward once, so the scan's estimated share of a step is layers x
    (forward + forward and backward) over the step's ms."""
    import torch
    from repro_torch.models import ssm as S
    b, s = HYMBA_TRAIN["batch"], HYMBA_TRAIN["seq"]
    c, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        def leaf(*shape, dt=torch.float32):
            return torch.randn(shape, generator=gen, device=dev).to(
                dt).requires_grad_()
        x = leaf(b, s, c, dt=dtype)
        # step sizes as the init gives them: softplus(N(0, 1) - 2)
        dtp = torch.nn.functional.softplus(torch.randn(
            (b, s, c), generator=gen, device=dev) - 2.0).to(
            dtype).requires_grad_()
        a_log = torch.log(torch.arange(1, n + 1, device=dev,
                                       dtype=torch.float32)).expand(
            c, n).contiguous().requires_grad_()
        bm, cm, d = leaf(b, s, n), leaf(b, s, n), leaf(c)
        st0 = torch.zeros((b, c, n), device=dev)
        args = (x, dtp, a_log, bm, cm, d, st0)
        r = torch.randn((b, s, c), generator=gen, device=dev)

        def fwd():
            return S.ssm_scan(*args)

        def fwd_bwd():
            y, st = S.ssm_scan(*args)
            torch.autograd.grad((y.float() * r).sum() + st.sum(),
                                [x, dtp, a_log, bm, cm, d])
        name = str(dtype).split(".")[-1]
        f_ms, fb_ms = time_ms(fwd, reps=5), time_ms(fwd_bwd, reps=5)
        est = cfg.n_layers * (f_ms + fb_ms)
        out[name] = {"forward_ms": f_ms, "forward_backward_ms": fb_ms,
                     "per_step_ms": est, "step_ms": step_ms[name],
                     "share": est / step_ms[name]}
        del args, x, dtp, a_log, bm, cm, d, r
    torch.cuda.empty_cache()
    return out


def hymba_train(dev) -> dict:
    """Phase 19 (d): hymba-1.5b whole at its published widths,
    HYMBA_TRAIN's steps of 2 x 2048 tokens a twin (``train_twins``: f32
    and bf16, bitwise twins, flash launches a step: 32 forward, 32 more
    for the remat, 32 backward; step ms, attention share, peak), then the
    scan's share (``hymba_scan_train``)."""
    from repro_torch.configs import registry
    cfg = registry.get(HYMBA)
    spec = HYMBA_TRAIN
    out = {"arch": cfg.name, "params": cfg.param_count(),
           "layers": cfg.n_layers, "global_batch": spec["batch"],
           "seq_len": spec["seq"], "steps": spec["steps"]}
    out.update(train_twins(dev, cfg, spec["batch"], spec["seq"],
                           spec["steps"], HYMBA_TRAIN_DIR))
    out["scan"] = hymba_scan_train(dev, cfg, {
        k: out[k]["step_ms"] for k in ("float32", "bfloat16")})
    return out


def hymba_phase(dev) -> dict:
    """Phase 19: hymba-1.5b whole, f32, served through the twin rule with
    its recurrent caches checked against fresh prefills (``hymba_serve``),
    the kernel-vs-plain and decode-vs-prefill rules on the same
    parameters (``hymba_checks``), then trained (``hymba_train``)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.backbone import init_params
    t_phase = time.perf_counter()
    cfg = registry.get(HYMBA)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    out = {"init_params_s": time.perf_counter() - t0,
           "params": cfg.param_count()}
    out["serve"] = hymba_serve(dev, cfg, params)
    out["checks"] = hymba_checks(dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    out["train"] = hymba_train(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# Phase 20: xlstm-1.3b's mLSTM and sLSTM layers, served and trained whole
# ----------------------------------------------------------------------

XLSTM = "xlstm-1.3b"
# (a): whole (48 layers, 1,214,150,992 parameters, 4.86 GB in f32).  The
# admissions prefill 1024 and 4096 tokens (4 and 16 mLSTM chunks of 256)
# and 999 (no multiple of 256: one chunk, the chunk rule's fallback); the
# first request finishes before the crash, the new one after it takes
# the last length
XLSTM_PROMPTS = (1025, 4097, 1000)
XLSTM_STEPS = 4                # before the finish, after it, after recovery
XLSTM_S_MAX = 4097 + 4 * XLSTM_STEPS
XLSTM_CHECK = 1024             # (b): prefill + decode at n against n + 1
# (c): cut from 2 x 1024 tokens for the run's time: the sLSTM loop runs
# once a token a layer, forward (twice under the remat) and backward; 512
# keeps two mLSTM chunks a layer
XLSTM_TRAIN = {"batch": 2, "seq": 512, "steps": 2}
XLSTM_TRAIN_DIR = ROOT / "build" / "chip_smoke_xlstm_train"


def xlstm_targets(train: bool = False) -> dict:
    """``ScanEvents`` targets of the two recurrences: serving's forward
    and decode-step calls, or a training step's forward calls (again
    under the superblock's remat) and their backward nodes (each mLSTM
    chunk's recomputing backward, the sLSTM scan's reversed loop)."""
    from repro_torch.models import xlstm as X
    if train:
        return {"mlstm": ((X, "mlstm_chunkwise"), (X._ChunkRemat,
                                                   "backward")),
                "slstm": ((X, "slstm_scan"), (X._SLSTMScan, "backward"))}
    return {"mlstm": ((X, "mlstm_chunkwise"), (X, "mlstm_step")),
            "slstm": ((X, "slstm_scan"), (X, "slstm_step"))}


def xlstm_shares(dev, cfg, params) -> dict:
    """(a): the two recurrences' shares of a 4096-token prefill and of a
    decode step at position 4096 on its caches (batch 1, f32, warm from
    the serving run): CUDA events around each mLSTM and sLSTM call
    summed, against events around the whole call."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serve_recover import prompts_for
    model = Model(cfg, compute_dtype=torch.float32)
    tokens = torch.as_tensor(prompts_for((4096,), cfg.vocab, SERVE_SEED)[0][
        None]).to(dev)
    out, kv = {}, None
    for name in ("prefill", "decode"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with ScanEvents(xlstm_targets()) as ev:
            start.record()
            if name == "prefill":
                _, kv = model.prefill(params, {"tokens": tokens},
                                      s_max=XLSTM_S_MAX)
            else:
                model.decode_step(params, kv, tokens[:, -1], 4096)
            end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        out[name] = {"ms": ms}
        for r in ("mlstm", "slstm"):
            out[name].update({f"{r}_ms": ev.ms(r), f"{r}_calls": ev.calls(r),
                              f"{r}_share": ev.ms(r) / ms})
    del kv
    torch.cuda.empty_cache()
    return out


def xlstm_serve(dev, cfg, params) -> dict:
    """Phase 20 (a): ``serve_recover.run``'s prefill rule at XLSTM_PROMPTS,
    f32: XLSTM_STEPS steps, the first request finished, as many, a crash
    and the re-prefill, as many again.  The recovered engine's caches,
    every leaf kind (``mlstm.c``, ``slstm.c``, ...) against its own
    largest |value|, equal a crash-free prefill of each live slot's
    logged tokens but the last within 1e-4 (a third engine admitting each
    live log) and serve on beside it with equal tokens; the decode-built
    twin is held on the first layer (fed by the embedding alone) within
    1e-4, and its other layers are reported, superblock by superblock
    (``cache_vs_decode_twin``'s ``superblocks``, at the recovery): the
    chunkwise prefill and the step round differently and
    the gates amplify that through the sequence and the depth, as in the
    reference (``tests/test_torch_xlstm_model.py``).  No prefill calls the
    flash kernel; ``scatter_rows`` launches once a cache leaf (25: 7
    mLSTM positions of 3, an sLSTM position of 4) per seating (each
    admission, each re-prefill group, each crash-free prefill).  Then the
    recurrences' shares (``xlstm_shares``)."""
    import torch
    from repro_torch.models.model import Model
    out, calls = counted_twin_run(
        dev, cfg, params, prompt_lens=XLSTM_PROMPTS, max_batch=3,
        s_max=XLSTM_S_MAX, steps=XLSTM_STEPS, max_requests=16)
    # no attention layer: no flash call at all
    check_flash_calls(cfg, out, calls, {})
    model = Model(cfg, compute_dtype=torch.float32)
    leaves = sum(len(v) for v in model.cache_specs(1, 1)["blocks"].values())
    live = sum(len(g["slots"]) for g in out["groups"])
    # admissions on the engine and its twin, the re-prefill groups, the
    # crash-free prefill engine's live logs and its new request
    seats = 2 * (len(XLSTM_PROMPTS) + 1) + len(out["groups"]) + live + 1
    if out["launches"]["scatter_rows"] != leaves * seats:
        raise AssertionError(f"{cfg.name}: {out['launches']['scatter_rows']}"
                             f" scatter_rows launches, not one per cache "
                             f"leaf ({leaves}) per seating ({seats})")
    out.update({"flash_launches_per_prefill": 0,
                "cache_leaves": leaves, "seatings": seats,
                "decode_bound": decode_bound_ms(cfg, params),
                "recurrences": xlstm_shares(dev, cfg, params)})
    return out


def xlstm_layer_check(dev, cfg, params, pos: str, n: int) -> dict:
    """One layer of superblock 0 (``pos``) on 2 seeded N(0, 1) inputs of n
    + 1 tokens: a prefill of the first n and a decode step at n against
    the prefill of all n + 1, the step's output (less its residual input)
    and every cache leaf within 1e-4 of their largest |value|."""
    import torch
    from repro_torch.core.policy import tree_map
    from repro_torch.models.backbone import apply_layer
    from repro_torch.serve_recover import LOGIT_TOL
    tag = cfg.layer_pattern[int(pos[3:])]
    p = tree_map(lambda t: t[0], params["blocks"][pos])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    x = torch.randn((2, n + 1, cfg.d_model), generator=gen, device=dev)
    y, full = apply_layer(cfg, tag, p, x, mode="prefill")
    _, kv = apply_layer(cfg, tag, p, x[:, :n], mode="prefill")
    y1, kv1 = apply_layer(cfg, tag, p, x[:, n:], mode="decode", cache=kv,
                          pos=n)
    want = y[:, n] - x[:, n]
    row = {"tag": tag, "position": pos, "tokens": n + 1,
           "output": float((y1[:, 0] - x[:, n] - want).abs().max())
           / float(want.abs().max())}
    for leaf, t in kv1.items():
        row[leaf] = float((t - full[leaf]).abs().max()) / float(
            full[leaf].abs().max())
    bad = {k: v for k, v in row.items() if isinstance(v, float)
           and not v <= LOGIT_TOL}
    if bad:
        raise AssertionError(f"{cfg.name} {tag} layer: prefill + decode at "
                             f"{n} against the prefill of {n + 1}: {bad}")
    return row


def xlstm_checks(dev, cfg, params) -> dict:
    """Phase 20 (b): a batch of 2 seeded prompts of XLSTM_CHECK + 1 tokens
    (one mLSTM chunk of 1025: the fallback), f32: a prefill of their
    first XLSTM_CHECK tokens (4 chunks) and a decode step at XLSTM_CHECK
    against the prefill of all of them: logits finite and of the
    expected shape; the first layer's caches within 1e-4 of each leaf's
    largest |value| (the reference's rule, ``tests/test_arch_smoke.py``,
    held where no recurrence feeds the layer); the last logits' difference
    reported (the depth amplifies the recurrences' rounding, as (a)'s
    twin shows).  Then each layer kind alone at that length, on the same
    input to both (``xlstm_layer_check``), gated at 1e-4.  No
    kernel-vs-plain prefill: the model launches no flash kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import Model
    from repro_torch.serve_recover import LOGIT_TOL, prompts_for
    n = XLSTM_CHECK
    toks = torch.as_tensor(np.stack(prompts_for((n + 1,) * 2, cfg.vocab,
                                                SERVE_SEED + 1))).to(dev)
    model = Model(cfg, compute_dtype=torch.float32)
    before = launch_counts()["flash_attention"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, kv_full = model.prefill(params, {"tokens": toks}, s_max=n + 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    _, kv = model.prefill(params, {"tokens": toks[:, :n]}, s_max=n + 1)
    inc, kv = model.decode_step(params, kv, toks[:, n], n)
    v = cfg.vocab
    if not (bool(torch.isfinite(full[:, :v]).all())
            and full.shape == (2, cfg.vocab_padded)):
        raise AssertionError(f"{cfg.name}: prefill logits not finite or "
                             f"misshapen")
    dec = float((inc[:, :v] - full[:, :v]).abs().max()) / float(
        full[:, :v].abs().max())
    first = {leaf: float((t[0] - kv_full["blocks"]["pos0"][leaf][0]).abs()
                         .max()) / float(kv_full["blocks"]["pos0"][leaf][0]
                                         .abs().max())
             for leaf, t in kv["blocks"]["pos0"].items()}
    if not max(first.values()) <= LOGIT_TOL:
        raise AssertionError(f"{cfg.name}: prefill + decode at {n}: the "
                             f"first layer's caches differ from the "
                             f"prefill of {n + 1}'s by {first}")
    launched = launch_counts()["flash_attention"] - before
    if launched:
        raise AssertionError(f"{cfg.name}: {launched} flash launches")
    del kv, kv_full, full, inc
    layers = [xlstm_layer_check(dev, cfg, params, pos, n)
              for pos in ("pos0", "pos7")]
    torch.cuda.empty_cache()
    return {"tokens": n + 1, "batch": 2,
            "decode_vs_prefill_logits": dec,
            "decode_vs_prefill_first_layer": first,
            "layers": layers, "tolerance": LOGIT_TOL,
            "prefill_s": prefill_s, "flash_launches": launched,
            "kernel_vs_plain": "not run: the model launches no flash kernel"}


def xlstm_step_share(trainer) -> dict:
    """``attention_share``'s step (no flash launch here) with the two
    recurrences' forward and backward timed by CUDA events
    (``xlstm_targets(train=True)``)."""
    import torch
    with ScanEvents(xlstm_targets(train=True)) as ev:
        out = attention_share(trainer)
    torch.cuda.synchronize()
    for r in ("mlstm", "slstm"):
        out.update({f"{r}_ms": ev.ms(r), f"{r}_calls": ev.calls(r),
                    f"{r}_share": ev.ms(r) / out["step_ms"]})
    return out


def xlstm_train(dev) -> dict:
    """Phase 20 (c): xlstm-1.3b whole at its published widths,
    XLSTM_TRAIN's steps of 2 x 512 tokens a twin (``train_twins``: f32
    and bf16, bitwise twins, no flash launch), step ms, tokens/s, peak,
    and the second twin's last step's recurrence shares
    (``xlstm_step_share``)."""
    from repro_torch.configs import registry
    cfg = registry.get(XLSTM)
    spec = XLSTM_TRAIN
    out = {"arch": cfg.name, "params": cfg.param_count(),
           "layers": cfg.n_layers, "global_batch": spec["batch"],
           "seq_len": spec["seq"], "steps": spec["steps"]}
    out.update(train_twins(dev, cfg, spec["batch"], spec["seq"],
                           spec["steps"], XLSTM_TRAIN_DIR,
                           share=xlstm_step_share))
    return out


def xlstm_phase(dev) -> dict:
    """Phase 20: xlstm-1.3b whole, f32, served through the twin rule with
    its recurrent caches checked against fresh prefills (``xlstm_serve``),
    decode against prefill on the same parameters (``xlstm_checks``),
    then trained (``xlstm_train``)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.backbone import init_params
    t_phase = time.perf_counter()
    cfg = registry.get(XLSTM)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    out = {"init_params_s": time.perf_counter() - t0,
           "params": cfg.param_count()}
    t0 = time.perf_counter()
    out["serve"] = xlstm_serve(dev, cfg, params)
    out["serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["checks"] = xlstm_checks(dev, cfg, params)
    out["checks_s"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["train"] = xlstm_train(dev)
    out["train_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------- main

# ----------------------------------------------------------------------
# Paged regions and the block cache (DESIGN.md §12): phase 2's pool
# kernels, phase 4's paged cases and phase 14
# ----------------------------------------------------------------------

PAGED_SLOTS = 6554             # (b)'s cache_blocks: the pool phase 2 seats
PAGED_FAULT_BLOCKS = 64        # phase 2's fault batch
PAGED_BLOCK = 4096
PAGED_SMALL = {"block_bytes": 512, "cache_blocks": 8}   # phase 4's cache
PARITY_SHAPE = {"n_init": 12000, "n_ops": 8192, "batch": 256, "group": 16,
                "synth_ns": 4000.0, "repeats": 3}
PARITY_GATE = 0.95             # the reference's --paged-parity gate
PARITY_BIG_N = (1 << 22) - 64  # cap = 2**22: a cache of 65,552 blocks
BUDGET_FACTOR = 10
BUDGET_CACHE = 6554            # (b): n_pages = 10 * 6554 * 64 = 4,194,560
SHARDED_CACHE = 819            # (d): n_pages = 524,160, four shards (cut
                               # from 1639 blocks, 1,048,960 pages, for time)
TTFT_GATE = 1.5                # the reference's --paged-slo gate
TTFT_REPEATS = 8


def paged_kernels(dev, flush) -> dict:
    """Phase 2's paged shapes: the grouped ``pack_rows`` over two block
    pools (4 KiB blocks of 64 B rows, of (b)'s and (d)'s caches) and one
    resident 2**22-row region, BATCH scattered translated indices each,
    and ``scatter_rows_`` seating a 64-block fault batch of 4 KiB blocks
    into a pool of 6554 slots; each exact against its plain version and
    timed beside its byte bound."""
    import torch
    from repro_torch.kernels import pack_flush as P
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    br = PAGED_BLOCK // 64
    srcs = [torch.randint(-(1 << 62), 1 << 62, (rows, 8), dtype=torch.int64,
                          device=dev, generator=g)
            for rows in (PAGED_SLOTS * br, SHARDED_CACHE * br, 1 << 22)]
    m = BATCH
    idx = torch.cat([torch.randint(0, s.shape[0], (m,), dtype=torch.int32,
                                   device=dev, generator=g) for s in srcs])
    counts = [m] * len(srcs)
    err = require_equal("pack_rows (block pools)", [
        (P.pack_rows_grouped(srcs, idx, counts),
         P.pack_rows_grouped_plain(srcs, idx, counts))])
    pack = {"ms": time_ms(lambda: P.pack_rows_grouped(srcs, idx, counts),
                          flush=flush),
            "plain_ms": time_ms(lambda: P.pack_rows_grouped_plain(
                srcs, idx, counts), flush=flush),
            "library_ms": None,
            "bound_ms": bound_ms(3 * m * (2 * 64 + 4)),
            "max_abs_err": err,
            "shape": f"3 x {m} rows of 64 B: pools of {PAGED_SLOTS} and "
                     f"{SHARDED_CACHE} slots of {br} rows, a resident "
                     f"2**22-row region; scattered translated indices"}
    del srcs
    width = PAGED_BLOCK
    dst = torch.randint(0, 256, (PAGED_SLOTS, width), dtype=torch.uint8,
                        device=dev, generator=g)
    packed = torch.randint(0, 256, (PAGED_FAULT_BLOCKS, width),
                           dtype=torch.uint8, device=dev, generator=g)
    sidx = torch.randperm(PAGED_SLOTS, device=dev, generator=g)[
        :PAGED_FAULT_BLOCKS].to(torch.int32)
    err = require_equal("scatter_rows (fault batch)", [
        (P.scatter_rows(dst, packed, sidx),
         P.scatter_rows_plain(dst.clone(), packed, sidx))])
    lidx = sidx.long()
    nbytes = PAGED_FAULT_BLOCKS * width
    scatter = {"ms": time_ms(lambda: P.scatter_rows_(dst, packed, sidx),
                             flush=flush),
               "plain_ms": time_ms(lambda: P.scatter_rows_plain(
                   dst, packed, sidx), flush=flush),
               "library_ms": time_ms(lambda: dst.index_copy_(0, lidx,
                                                             packed),
                                     flush=flush),
               "bound_ms": bound_ms(2 * nbytes + 4 * PAGED_FAULT_BLOCKS),
               "max_abs_err": err,
               "shape": f"{PAGED_FAULT_BLOCKS} blocks of {width} B into a "
                        f"({PAGED_SLOTS}, {width}) pool"}
    del dst, packed
    torch.cuda.empty_cache()
    return {"pack_rows": pack, "scatter_rows": scatter}


def cache_counters(a) -> dict:
    c = a.cache
    return {} if c is None else {k: int(getattr(c, k)) for k in (
        "faults", "hits", "evictions", "spills", "over_budget",
        "resident_bytes", "peak_resident_bytes")}


def paged_small(mode: str, n_shards: int, commit_mode: str, device,
                paged: bool = True) -> tuple:
    """Phase 4's paged case: a DLL of PARITY_N rows, snapshots on, on a
    paged arena whose cache evicts all along (512 B blocks, 8 of them):
    appends, scattered deletes and pops, a commit after each, an
    uncommitted tail, a crash and a recovery.  Returns the image's sha256,
    the FlushStats, every cache counter after the trace and after the
    recovery, the report without timings and the recovered order's
    digest."""
    import numpy as np
    from repro_torch.core.arena import open_arena
    from repro_torch.core.recovery import RecoveryManager
    from repro_torch.interop import image_of
    from repro_torch.pstruct.dll import DoublyLinkedList
    n = PARITY_N
    kw = dict(paged=True, **PAGED_SMALL) if paged else {"paged": False}
    a = open_arena(None, DoublyLinkedList.layout(n, mode, snapshot=True),
                   device=device, integrity=False, n_shards=n_shards,
                   commit_mode=commit_mode, **kw)
    d = DoublyLinkedList(a, n, mode, snapshot=True)
    rng = np.random.default_rng(14)
    vals = rng.integers(0, 1 << 40, (n, 7)).astype(np.int64)
    live = n * 3 // 4
    for i in range(0, live, 1024):
        d.append_batch(vals[i:i + 1024])
        a.commit()
    gone = rng.permutation(live)[:2048].astype(np.int64)
    for i in range(0, gone.size, 256):
        d.delete_batch(gone[i:i + 256])
        a.commit()
    d.pop_front_batch(300)
    a.commit()
    d.append_batch(vals[:500])                 # uncommitted tail
    before = cache_counters(a)
    a.crash()
    rep = RecoveryManager(a).add("dll", "pstruct.dll", d, regions=(
        "dll.nodes", "dll.header", "dll.snapring", "dll.snaprec")).recover()
    order = d.to_list().cpu().numpy()
    return (hashlib.sha256(image_of(a)).hexdigest(),
            dataclasses.asdict(a.stats), before, cache_counters(a),
            no_timing(rep),
            hashlib.sha256(order.astype(np.int64).tobytes()).hexdigest())


def paged_fault_small(commit_mode: str, device) -> tuple:
    """Phase 4's paged integrity case: a mixed DLL + B+Tree + hashmap arena,
    integrity on, paged on 256 B blocks (4 of them); a flipped DLL row; the
    demand fault of its block must raise ``CorruptLineError`` naming the
    row.  Returns the row, the error's message and the cache counters."""
    import numpy as np
    from repro_torch.core import faultinject as F
    from repro_torch.core.arena import CorruptLineError, open_arena
    from repro_torch.pstruct.bptree import BPTree
    from repro_torch.pstruct.dll import DoublyLinkedList
    from repro_torch.pstruct.hashmap import Hashmap
    layout = {}
    layout.update(DoublyLinkedList.layout(256, "partly", name="dll"))
    layout.update(BPTree.layout(256, 1024, "partly", name="bt"))
    layout.update(Hashmap.layout(512, "partly", name="hm"))
    a = open_arena(None, layout, device=device, integrity=True,
                   commit_mode=commit_mode, paged=True, block_bytes=256,
                   cache_blocks=4)
    d = DoublyLinkedList(a, 256, "partly", name="dll")
    t = BPTree(a, 256, 1024, "partly", name="bt")
    h = Hashmap(a, 512, "partly", name="hm")
    rng = np.random.default_rng(2)
    key = 0
    for i in range(12):
        m = int(rng.integers(2, 7))
        vals = rng.integers(0, 1 << 30, (m, 7)).astype(np.int64)
        keys = np.arange(key, key + m, dtype=np.int64)
        key += m
        with a.epoch():
            if i % 3 == 0:
                d.append_batch(vals)
            elif i % 3 == 1:
                t.insert_batch(keys, vals)
            else:
                h.insert_batch(keys, vals)
        a.commit()
    row = int(d.order()[1])
    a.crash()
    F.flip_bits(a, a.regions["dll.nodes"], row, byte=8, mask=0x04)
    a.reopen()
    try:
        a.regions["dll.nodes"].read_rows(np.array([row], np.int64))
    except CorruptLineError as e:
        if row not in e.rows.tolist():
            raise AssertionError(f"paged fault named rows {e.rows}, not "
                                 f"{row}") from e
        return row, str(e), cache_counters(a)
    raise AssertionError(f"{commit_mode}: the demand fault of a corrupt "
                         f"block was admitted")


def paged_card_vs_cpu(dev) -> list:
    """Phase 4's paged cases, card against CPU, each also against an
    unpaged run's image on the card."""
    same = []
    for mode in ("partly", "full"):
        for n_shards in (1, 3):
            for commit_mode in ("barrier", "shadow"):
                out = {d: paged_small(mode, n_shards, commit_mode, d)
                       for d in ("cuda", "cpu")}
                if out["cuda"] != out["cpu"]:
                    raise AssertionError(
                        f"paged dll {mode} {n_shards} shards {commit_mode}: "
                        f"card and CPU images, FlushStats, cache counters "
                        f"or recovered order differ")
                flat = paged_small(mode, n_shards, commit_mode, "cuda",
                                   paged=False)
                if (flat[0], flat[1], flat[5]) != \
                        (out["cuda"][0], out["cuda"][1], out["cuda"][5]):
                    raise AssertionError(
                        f"paged dll {mode} {n_shards} shards {commit_mode}: "
                        f"paged and unpaged images differ")
                c = out["cuda"][2]
                same.append(f"dll.{mode}.paged.shards_{n_shards}."
                            f"{commit_mode}:{out['cuda'][0][:12]}:"
                            f"faults={c['faults']}:"
                            f"evictions={c['evictions']}")
    for commit_mode in ("barrier", "shadow"):
        out = {d: paged_fault_small(commit_mode, d) for d in ("cuda",
                                                              "cpu")}
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"paged fault verification {commit_mode}: "
                                 f"card and CPU differ")
        same.append(f"mixed.paged.{commit_mode}.fault_row_"
                    f"{out['cuda'][0]}:CorruptLineError")
    return same


class LaunchMeter:
    """Kernel launches, grouped gathers and fault batches over a block."""

    def __enter__(self):
        from repro_torch.core.paging import _BlockPool
        from repro_torch.core.writeset import WriteSet
        from repro_torch.kernels import launch_counts
        self._read = lambda: (launch_counts(), WriteSet.gathers,
                              _BlockPool.fault_batches)
        self._start = self._read()
        return self

    def __exit__(self, *exc):
        end = self._read()
        self.launches = {k: end[0][k] - self._start[0][k] for k in end[0]}
        self.gathers = end[1] - self._start[1]
        self.fault_batches = end[2] - self._start[2]
        return False

    def check_seats(self, label: str) -> dict:
        """scatter_rows launches must equal the fault batches seated."""
        if self.launches["scatter_rows"] != self.fault_batches:
            raise AssertionError(
                f"{label}: {self.launches['scatter_rows']} scatter_rows "
                f"launches for {self.fault_batches} fault batches")
        return {"scatter_rows": self.fault_batches,
                "pack_rows": self.launches["pack_rows"],
                "gathers": self.gathers}


def parity_run(dev, paged: bool, n_init: int, n_ops: int, batch: int,
               group: int, synth_ns: float, build_batch: int = 4096,
               spans=None) -> dict:
    """One side of the reference's ``--paged-parity`` (flush_batching.py
    ``paged_parity``): a partly DLL of ``n_init`` nodes, ``n_ops``
    scattered deletes in batches of ``batch``, ``group`` batches an epoch,
    each epoch's drain and commit timed; the cache fits the list.  With
    ``spans``, an entered ``HostSpans``, each epoch's drain and commit
    alone (and their wall, ``flush_wall``) close one of its epochs."""
    import numpy as np
    import torch
    from repro_torch.core.arena import open_arena
    from repro_torch.pstruct.dll import DoublyLinkedList
    rng = np.random.default_rng(0)
    cap = n_init + 64
    a = open_arena(None, DoublyLinkedList.layout(cap, "partly"),
                   synth_line_ns=synth_ns, paged=paged,
                   block_bytes=PAGED_BLOCK,
                   cache_blocks=(cap * 64) // PAGED_BLOCK + 16, device=dev)
    d = DoublyLinkedList(a, cap, "partly")
    vals = rng.integers(0, 1 << 40, (n_init, 7)).astype(np.int64)
    for i in range(0, n_init, build_batch):
        d.append_batch(vals[i:i + build_batch])
    a.commit()
    ids = rng.permutation(n_init)[:n_ops].astype(np.int64)
    base = a.stats.snapshot()
    flush_wall = 0.0
    for g in range(0, n_ops, batch * group):
        a._epoch_depth += 1
        for i in range(g, min(g + batch * group, n_ops), batch):
            d.delete_batch(ids[i:i + batch])
        a._epoch_depth -= 1
        torch.cuda.synchronize()
        if spans is not None:
            spans.cur = {}
        t0 = time.perf_counter()
        a.writeset.flush()
        a.commit()
        dt = time.perf_counter() - t0
        flush_wall += dt
        if spans is not None:
            spans.cur["flush_wall"] = dt * 1e9
            spans.epoch()
    st = a.stats.delta(base)
    c = a.cache
    row = {"paged": paged, "n_init": n_init, "flush_wall_s": flush_wall,
           "lines": st.lines, "saved_lines": st.saved_lines,
           "snapshot_lines": st.snapshot_lines,
           "dedup_rows": st.dedup_rows, "epochs": st.epochs,
           "fences": st.fences,
           "evictions": int(c.evictions) if c else 0,
           "spills": int(c.spills) if c else 0,
           "faults": int(c.faults) if c else 0,
           "pool_bytes": int(c.peak_pool_bytes) if c else 0,
           "lines_per_s": st.lines / max(flush_wall, 1e-9)}
    a.close()
    return row


def paged_parity(dev, n_init: int, n_ops: int, batch: int, group: int,
                 synth_ns: float, repeats: int, gated: bool = True,
                 build_batch: int = 4096) -> dict:
    """Best of ``repeats`` per side, unpaged then paged in each round;
    gated (the reference's gate): equal line, dedup, epoch and fence
    accounting, zero evictions and spills, lines/s ratio >= 0.95."""
    best = {}
    for _ in range(repeats):
        for paged in (False, True):
            r = parity_run(dev, paged, n_init, n_ops, batch, group, synth_ns,
                           build_batch)
            if paged not in best or \
                    r["flush_wall_s"] < best[paged]["flush_wall_s"]:
                best[paged] = r
    up, pg = best[False], best[True]
    ratio = pg["lines_per_s"] / max(up["lines_per_s"], 1e-9)
    out = {"rows": [up, pg], "lines_per_s_ratio": ratio,
           "synth_line_ns": synth_ns, "gated": gated}
    if gated:
        if pg["evictions"] or pg["spills"]:
            raise AssertionError(f"paged parity: {pg['evictions']} "
                                 f"evictions, {pg['spills']} spills")
        for k in ("lines", "saved_lines", "snapshot_lines", "dedup_rows",
                  "epochs", "fences"):
            if up[k] != pg[k]:
                raise AssertionError(f"paged parity: {k} {up[k]} unpaged, "
                                     f"{pg[k]} paged")
        if ratio < PARITY_GATE:
            raise AssertionError(f"paged parity: lines/s ratio {ratio:.3f} "
                                 f"< {PARITY_GATE}")
    return out


BUILD_REQUESTS = 64            # requests a build commit allocates


def alloc_many(pa, rid0: int, sizes) -> None:
    """Allocate requests ``rid0, rid0 + 1, ...`` of ``sizes`` pages in one
    epoch, one append batch and one commit, their pages taken from the
    free stack as ``alloc`` takes them, request by request, and their
    nodes interleaved in the LRU as decode steps would append them: a page
    of every request that still grows, then the next."""
    import numpy as np
    grid = np.full((len(sizes), max(sizes)), -1, np.int64)
    owners = []
    for k, n in enumerate(sizes):
        top = len(pa.pages_free) - n
        pages = pa.pages_free[top:][::-1].copy()
        pa.pages_free = pa.pages_free[:top]
        grid[k, :n] = pages
        owners.append((pages, rid0 + k))
    order = grid.T.reshape(-1)
    keep = order >= 0
    vals = np.zeros((int(keep.sum()), 7), np.int64)
    vals[:, 0] = order[keep]
    vals[:, 1] = rid0 + np.tile(np.arange(len(sizes)), grid.shape[1])[keep]
    with pa.arena.epoch():
        ids = pa.lru.append_batch(vals).cpu().numpy()
        pa.page_of_node.update(zip(ids.tolist(), vals[:, 0].tolist()))
        for pages, rid in owners:
            pa.owner[pages] = rid
        pa.arena.commit()


def free_many(pa, rids) -> None:
    """Free the requests ``rids`` in one epoch, one delete batch and one
    commit (``free_request`` of each, merged)."""
    import numpy as np
    rids = np.asarray(sorted(rids), np.int64)
    pages = np.nonzero(np.isin(pa.owner, rids))[0]
    nd = np.fromiter(pa.page_of_node.keys(), np.int64,
                     len(pa.page_of_node))
    pg = np.fromiter(pa.page_of_node.values(), np.int64,
                     len(pa.page_of_node))
    nodes = nd[np.isin(pa.owner[pg], rids)]
    with pa.arena.epoch():
        pa.lru.delete_batch(nodes)
        for n in nodes.tolist():
            pa.page_of_node.pop(n, None)
        pa.owner[pages] = -1
        pa.pages_free = np.concatenate([pa.pages_free, pages])
        pa.arena.commit()


def alloc_fingerprint(pa) -> tuple:
    """The recovered allocator's state: LRU order, owners, free pages."""
    import numpy as np
    return (pa.lru.order().cpu().numpy(), pa.owner.copy(),
            np.sort(pa.pages_free))


def same_fingerprint(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def paged_budget(dev, cache_blocks: int, snapshot=None, n_shards: int = 1,
                 commit_mode: str = "barrier",
                 factor: int = BUDGET_FACTOR) -> dict:
    """The reference's ``paged_budget_report`` (recovery_bench.py): a
    file-backed paged-KV pool ``factor`` times the cache's budget, built
    about 75 % live in requests of 2048 pages (BUILD_REQUESTS a commit,
    their pages interleaved in the LRU as decode steps append them) and
    fragmented by freeing every third request (a delete batch for each
    commit's requests), crashed, recovered on demand and served.  Gated:
    peak resident <= (cache_blocks + 16) blocks, the recovered state equal
    to the pre-crash one and to an unpaged reopen of the same files, zero
    spills, the pools' peak device bytes <= twice the budget."""
    import torch
    from repro_torch.serve.kvcache import PagedAllocator, PagedConfig
    n_pages = factor * cache_blocks * (PAGED_BLOCK // 64)
    budget = (cache_blocks + 16) * PAGED_BLOCK
    root = ROOT / "build" / "chip_smoke_paged"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    path = str(root / "pool.bin")
    cfg = dict(n_pages=n_pages, snapshot=snapshot, n_shards=n_shards,
               commit_mode=commit_mode)
    t0 = time.perf_counter()
    pa = PagedAllocator(PagedConfig(paged=True, block_bytes=PAGED_BLOCK,
                                    cache_blocks=cache_blocks, **cfg),
                        path=path, device=dev)
    live = int(n_pages * 0.75)
    sizes = [min(2048, live - i) for i in range(0, live, 2048)]
    for k in range(0, len(sizes), BUILD_REQUESTS):
        alloc_many(pa, k, sizes[k:k + BUILD_REQUESTS])
    rid = len(sizes)
    for k in range(0, rid, BUILD_REQUESTS):
        free_many(pa, [r for r in range(k, min(k + BUILD_REQUESTS, rid))
                       if r % 3 == 0])
    build_s = time.perf_counter() - t0
    fp0 = alloc_fingerprint(pa)
    cache = pa.arena.cache
    pa.arena.crash()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    cache.reset_peak()
    with LaunchMeter() as rec:
        t0 = time.perf_counter()
        pa.recover()
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
    mem_recovered = torch.cuda.memory_allocated(dev) - mem0
    fp_rec = alloc_fingerprint(pa)
    rep = pa.last_recovery
    faults_per_stage = {s.name: s.detail.get("block_faults")
                        for s in rep.stages if s.name != "reopen"}
    lru_chain = rep.stage("lru").detail.get("chain")
    # an unpaged reopen of the same files, before serving mutates them
    pu = PagedAllocator(PagedConfig(paged=False, **cfg), path=path,
                        device=dev)
    t0 = time.perf_counter()
    pu.recover()
    torch.cuda.synchronize()
    unpaged_s = time.perf_counter() - t0
    match_unpaged = same_fingerprint(fp_rec, alloc_fingerprint(pu))
    pu.arena.close()
    del pu
    torch.cuda.empty_cache()
    # serve on the recovered pool under the same budget
    for k in range(5):
        pa.alloc(1_000_000 + k, 128)
    for k in range(0, 5, 2):
        pa.free_request(1_000_000 + k)
    torch.cuda.synchronize()
    row = {"n_pages": n_pages, "factor": factor, "n_shards": n_shards,
           "commit_mode": commit_mode, "snapshot": snapshot,
           "built_live_pages": live, "requests": rid, "build_s": build_s,
           "recover_s": recover_s, "budget_bytes": budget,
           "capacity_bytes": int(cache.capacity_bytes),
           "peak_resident_bytes": int(cache.peak_resident_bytes),
           "peak_pool_bytes": int(cache.peak_pool_bytes),
           "allocated_delta_bytes": int(mem_recovered),
           "faults": int(cache.faults), "hits": int(cache.hits),
           "evictions": int(cache.evictions), "spills": int(cache.spills),
           "over_budget": int(cache.over_budget),
           "block_faults_per_stage": faults_per_stage, "lru_chain": lru_chain,
           "recover_launches": {k: v for k, v in rec.launches.items() if v},
           "recover_fault_batches": rec.fault_batches,
           "fingerprint_match_precrash": same_fingerprint(fp_rec, fp0),
           "unpaged_recover_s": unpaged_s,
           "fingerprint_match_unpaged": match_unpaged}
    del fp0, fp_rec
    pa.arena.close()
    del pa
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    label = f"paged budget {n_shards} shards {commit_mode} " \
            f"snapshot={snapshot}"
    if row["peak_resident_bytes"] > budget:
        raise AssertionError(f"{label}: peak resident "
                             f"{row['peak_resident_bytes']} > {budget}")
    if not (row["fingerprint_match_precrash"]
            and row["fingerprint_match_unpaged"]):
        raise AssertionError(f"{label}: recovered state differs "
                             f"(pre-crash {row['fingerprint_match_precrash']}"
                             f", unpaged {row['fingerprint_match_unpaged']})")
    if row["spills"]:
        raise AssertionError(f"{label}: {row['spills']} spills")
    if row["peak_pool_bytes"] > 2 * budget:
        raise AssertionError(f"{label}: pools peaked at "
                             f"{row['peak_pool_bytes']} B > 2 x {budget}")
    return row


def ttft_row(dev, model, params, paged: bool) -> dict:
    """The reference's ``--paged-slo`` component B (recovery_bench.py
    ``ttft_row``): an engine with a 4096-page pool serves four 24-token
    prompts two steps, then crash and recover (warm), then the first
    slot's admission after a crash (best of TTFT_REPEATS) plus one decode
    step (best of 5)."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import EngineConfig, ServingEngine
    ec = EngineConfig(max_batch=4, s_max=32, max_requests=16, n_pages=4096,
                      paged=paged)
    eng = ServingEngine(model, params, ec, device=dev)
    rng = np.random.default_rng(0)
    for rid in range(4):
        eng.add_request(100 + rid, rng.integers(1, model.cfg.vocab,
                                                24).astype(np.int64))
    for _ in range(2):
        eng.step()
    eng.crash()
    eng.recover()                     # warm
    admit = None
    for _ in range(TTFT_REPEATS):
        first = {}

        def on_ready(slots, tlen, admitted_s):
            torch.cuda.synchronize()
            first.setdefault("t", time.perf_counter() - t0)

        eng.crash()
        eng.on_slot_ready = on_ready
        t0 = time.perf_counter()
        sec = eng.recover()
        eng.on_slot_ready = None
        t = first.get("t", sec)
        admit = t if admit is None else min(admit, t)
    decode = None
    for _ in range(5):
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        decode = dt if decode is None else min(decode, dt)
    c = eng.paging.arena.cache
    row = {"paged": paged, "n_pages": 4096, "first_admission_s": admit,
           "first_decode_s": decode, "ttft_after_crash_s": admit + decode,
           "faults": int(c.faults) if c else 0,
           "spills": int(c.spills) if c else 0}
    eng.arena.close()
    eng.paging.arena.close()
    return row


def paged_ttft(dev) -> dict:
    """(c): the engine TTFT after a crash, paged against unpaged, on the
    full-width 2-layer llama3.2-3b of phases 11-13; gated <= 1.5x."""
    import torch
    from repro_torch.models.backbone import init_params
    from repro_torch.models.model import Model
    cfg = serve_config(layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)
    params = init_params(cfg, gen, dev)
    model = Model(cfg, compute_dtype=torch.float32)
    rows = [ttft_row(dev, model, params, p) for p in (False, True)]
    del params
    torch.cuda.empty_cache()
    ratio = rows[1]["ttft_after_crash_s"] / max(
        rows[0]["ttft_after_crash_s"], 1e-9)
    if ratio > TTFT_GATE:
        raise AssertionError(f"paged TTFT after a crash {ratio:.3f}x the "
                             f"unpaged > {TTFT_GATE}")
    return {"rows": rows, "ttft_ratio_paged": ratio}


def paged_phase(dev) -> dict:
    """Phase 14: the reference's two paging gates on the card.  (a) the
    ``--paged-parity`` shape (gated) and the same deletes on a 2**22 DLL
    with no modeled stall (reported); (b) ``paged_budget_report`` at factor
    10 (4,194,560 pages, 6554 blocks of 4 KiB), with snapshots on (the
    fast path) and off (the lru stage ranks the whole NEXT column, read
    through the cache, on the chain kernels); (c) the engine's TTFT after
    a crash, paged against unpaged; (d) (b)'s gates on a four-shard
    shadow allocator of 524,160 pages.  Throughout: ``pack_rows``
    launches = grouped gathers, and ``scatter_rows`` launches = fault
    batches wherever only paged arenas seat rows."""
    t_phase = time.perf_counter()
    out = {}
    with LaunchMeter() as m:
        out["parity"] = paged_parity(dev, **PARITY_SHAPE)
        out["parity_2_22"] = paged_parity(
            dev, PARITY_BIG_N, PARITY_SHAPE["n_ops"], PARITY_SHAPE["batch"],
            PARITY_SHAPE["group"], 0.0, 1, gated=False, build_batch=1 << 16)
    out["parity_launches"] = m.check_seats("phase 14 (a)")
    for label, snap in (("budget", None), ("budget_no_snapshot", False)):
        with LaunchMeter() as m:
            out[label] = paged_budget(dev, BUDGET_CACHE, snapshot=snap)
        out[label]["launches"] = m.check_seats(f"phase 14 ({label})")
    chain = {k: out["budget_no_snapshot"]["recover_launches"].get(k, 0)
             for k in CHAIN_KERNELS}
    if not any(chain.values()):
        raise AssertionError("phase 14: the snapshot-off recovery launched "
                             "no chain kernel")
    if out["budget"]["lru_chain"] != "snapshot":
        raise AssertionError(f"phase 14: the snapshot recovery took "
                             f"{out['budget']['lru_chain']}, not the fast "
                             f"path")
    out["budget_no_snapshot"]["chain_launches"] = chain
    out["ttft"] = paged_ttft(dev)
    out["sharded"] = paged_budget(dev, SHARDED_CACHE, n_shards=SHARDS,
                                  commit_mode="shadow")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


AB_ONE = r"""
import json, os, sys
os.environ["REPRO_INTEGRITY"] = "0"
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as C
from repro_torch.kernels import _build
CROSSOVER_ONLY = sys.argv[1:] == ["crossover"]
PAGED_ONLY = sys.argv[1:] == ["paged"]
_build.build(("pack_flush",) if CROSSOVER_ONLY or PAGED_ONLY
             else _build.SOURCES)
dev = torch.device("cuda", 0)
if PAGED_ONLY:
    # phase 14 (a)'s --paged-parity shape ungated (best of 3 a side, as
    # gated), then one more run a side under host spans: the drain's and
    # the commit's cache bookkeeping on the host clock, per epoch.  The
    # spans are defined here, so both trees take the same ones; a method
    # one tree lacks is left out of its profile.
    import importlib
    x = C.paged_parity(dev, **C.PARITY_SHAPE, gated=False)
    out = {"ratio": x["lines_per_s_ratio"],
           "flush_wall_ms": {("paged" if r["paged"] else "unpaged"):
                             r["flush_wall_s"] * 1e3 for r in x["rows"]}}
    targets = []
    for mod, cls, name in (
            ("repro_torch.core.paging", None, "drain_positions"),
            ("repro_torch.core.paging", "_BlockPool", "_positions"),
            ("repro_torch.core.paging", "_BlockPool", "_touch"),
            ("repro_torch.core.paging", "BlockCache", "hit_many"),
            ("repro_torch.core.paging", "_BlockPool", "_pin"),
            ("repro_torch.core.paging", "_BlockPool", "_unpin"),
            ("repro_torch.core.paging", "_BlockPool", "_note_flushed"),
            ("repro_torch.core.paging", "_BlockPool", "_seat"),
            ("repro_torch.core.writeset", "WriteSet", "gather"),
            ("repro_torch.core.writeset", "WriteSet", "_gather"),
            ("repro_torch.core.writeset", "WriteSet", "_write_phase"),
            ("repro_torch.core.writeset", "WriteSet", "_drain_snapshots"),
            ("repro_torch.core.writeset", "WriteSet", "flush"),
            ("repro_torch.core.arena", "Arena", "commit")):
        owner = importlib.import_module(mod)
        owner = getattr(owner, cls) if cls else owner
        if name in vars(owner):
            targets.append((owner, name))
    # parity_run's timed drains and commits alone, one run a side; where
    # a tree's parity_run takes no spans, the spans patched around the
    # whole call (build and deletes too) give one total
    import inspect
    per_epoch = "spans" in inspect.signature(C.parity_run).parameters
    shape = {k: v for k, v in C.PARITY_SHAPE.items() if k != "repeats"}
    key = "host_ms_per_epoch" if per_epoch else "host_ms_whole_run"
    out[key] = {}
    for paged in (False, True):
        with C.HostSpans(targets) as spans:
            C.parity_run(dev, paged, **shape,
                         **({"spans": spans} if per_epoch else {}))
        if not per_epoch:
            spans.epoch()
        out[key]["paged" if paged else "unpaged"] = {
            k.split(".")[-1]: v for k, v in spans.mean_ms().items()}
    print("AB " + json.dumps(out), flush=True)
    sys.exit(0)
if sys.argv[1:] == ["model"]:
    # phase 7's Model.decode_step, phase 10's bf16 step and phase 16's
    # gemma2-9b steps, each through its phase's own function
    from repro_torch.models.backbone import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = C.serve_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(C.SERVE_SEED)
    params = init_params(cfg, gen, dev)
    out = {"model_decode_ms": C.model_decode_ms(cfg, params, dev)}
    del params
    torch.cuda.empty_cache()
    out["train_bf16_step_ms"] = C.train_bf16(dev)["step_ms"]
    g2 = C.gemma_train_one(dev, "gemma2-9b")
    out["gemma2_step_ms"] = {d: g2[d]["step_ms"] for d in ("float32",
                                                          "bfloat16")}
    print("AB " + json.dumps(out), flush=True)
    sys.exit(0)
if CROSSOVER_ONLY:
    # the epochs' host walls without stalls (median over every epoch of
    # four rounds), then the crossover at one and four shards three times
    import statistics
    host = dict(C.CROSSOVER, synth_ns=0.0, synth_fence_ns=0.0)
    C.sweep_point(C.SHARDS, dev, shape=host, commit_mode="shadow")
    ep = {}
    for _ in range(4):
        for ns in (1, C.SHARDS):
            for mode in ("barrier", "shadow"):
                h = C.sweep_point(ns, dev, shape=host,
                                  commit_mode=mode)["host_profile"]
                ep.setdefault(f"{ns}/{mode}", []).extend(
                    d + c for d, c in zip(h["drain_ms"], h["commit_ms"]))
    out = {"host_epoch_ms": {k: statistics.median(v)
                             for k, v in ep.items()}, "crossover": []}
    for _ in range(3):
        x = C.shadow_crossover(dev, gated=False)
        out["crossover"].append({
            "x1": x["speedup"], "x4": x["speedup_4"],
            "wall_ms": {f"{r['n_shards']}/{r['commit_mode']}":
                        r["flush_wall_s"] * 1e3
                        for key in ("rows", "rows_4") for r in x[key]}})
    print("AB " + json.dumps(out), flush=True)
    sys.exit(0)
x = C.shadow_crossover(dev, shard_counts=(C.SHARDS,), gated=False)
out = {"x4": x["speedup_4"]}
for kind in ("dll", "hashmap"):
    for mode in ("full", "partly"):
        r = C.workload(kind, mode, 1 << 22, dev)
        out[kind + "_" + mode] = {k: r[k] for k in ("insert_s", "delete_s",
                                                     "recover_s")}
        del r
        torch.cuda.empty_cache()
print("AB " + json.dumps(out), flush=True)
"""


def ab_trees(parent: Path, rounds: int = 3, crossover: bool = False,
             model: bool = False, paged: bool = False) -> list:
    """``--ab-parent``: phase 13's four-shard crossover (ungated) and phase
    3's DLL and hashmap at 2**22, for the tree at ``parent`` and this one
    in turns (parent, this, this, parent, ...), one process each.  With
    ``crossover`` (``--ab-crossover``) each process instead times the
    crossover shape's epochs without stalls (drain + commit, the median
    epoch) and runs the crossover at one and four shards three times;
    with ``model`` (``--ab-model``) phase 7's ``Model.decode_step``
    (``model_decode_ms``), phase 10's bf16 step (``train_bf16``) and
    phase 16's gemma2-9b steps (``gemma_train_one``); with ``paged``
    (``--ab-paged``) phase 14 (a)'s ``paged_parity`` ungated, each side's
    flush wall and the ratio, then one run a side with the drain's and the
    commit's host code on the host clock per epoch (``HostSpans``)."""
    order = [parent, ROOT, ROOT, parent] * ((rounds + 1) // 2)
    mode = ["crossover"] if crossover else ["model"] if model else \
        ["paged"] if paged else []
    runs = []
    for tree in order[:2 * rounds]:
        p = subprocess.run([sys.executable, "-c", AB_ONE] + mode, cwd=tree,
                           capture_output=True, text=True)
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode or not line:
            raise AssertionError(f"A/B run in {tree} failed: "
                                 f"{p.stderr[-2000:]}")
        runs.append({"tree": "parent" if tree == parent else "this",
                     **json.loads(line[0][3:])})
        emit({"phase": "ab", **runs[-1]})
    return runs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--report", help="also write every phase's numbers to "
                   "this JSON file")
    p.add_argument("--crossover-study", action="store_true",
                   help="in phase 13, also time the shard pool's two rules "
                   "(pool_study) before each four-shard crossover gate")
    p.add_argument("--ab-parent", metavar="DIR",
                   help="instead of the phases: phase 13's four-shard "
                   "crossover and phase 3's DLL and hashmap, for the tree "
                   "at DIR and this one in turns (ab_trees)")
    p.add_argument("--ab-crossover", action="store_true",
                   help="with --ab-parent: only the crossover shape, its "
                   "epochs' host walls without stalls and the crossover at "
                   "one and four shards, three times a process")
    p.add_argument("--ab-paged", action="store_true",
                   help="with --ab-parent: phase 14 (a)'s paged parity "
                   "ungated, each side's flush wall and the ratio, and the "
                   "paged drain's host code per epoch")
    p.add_argument("--ab-model", action="store_true",
                   help="with --ab-parent: phase 7's Model.decode_step, "
                   "phase 10's bf16 training step and phase 16's gemma2-9b "
                   "steps")
    args = p.parse_args(argv)

    # cuBLAS reads its workspace setting when it starts, before phase 1's
    # first product: phase 10 runs with deterministic kernels and needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if args.ab_parent:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        runs = ab_trees(Path(args.ab_parent).resolve(),
                        crossover=args.ab_crossover, model=args.ab_model,
                        paged=args.ab_paged)
        if args.report:
            Path(args.report).parent.mkdir(parents=True, exist_ok=True)
            Path(args.report).write_text(json.dumps(runs, indent=1))
        return 0
    # phases 1-10 run without integrity sidecars, as they did before the
    # port had them, so their numbers stay comparable (phases 3-6 also pin
    # integrity=False); phase 4's integrity case pins it on, and phase 11
    # clears this pin for its own scope
    os.environ["REPRO_INTEGRITY"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.interop import image_of
    from repro_torch.core.writeset import WriteSet
    from repro_torch.kernels import (WRAPPERS, _build, launch_counts,
                                     launch_sizes, launch_steps,
                                     reset_launch_counts)

    report = {}
    dev = torch.device("cuda", 0)
    t_run = time.perf_counter()   # each phase's start goes out as a clock line
    # ---- phase 1: card and build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    per_source = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.library_path(name).with_suffix(
        ".log").read_text().splitlines() if "registers" in ln]
        for name in _build.SOURCES}
    report["build"] = {"seconds": build_s, "per_source": per_source,
                       "ptxas": ptxas, "flash_kernels": flash_build_report(),
                       "l2_bytes": torch.cuda.get_device_properties(
                           0).L2_cache_size}
    emit({"phase": "build", **report["build"]})
    # the D = 256 forward (gemma2), both designs: registers and spills
    emit({"phase": "flash_d256_ptxas",
          **{k: v for k, v in report["build"]["flash_kernels"].items()
             if "D=256" in k}})
    report["link"] = pinned_d2h(dev)
    emit({"phase": "pinned_d2h", **report["link"]})
    emit({"phase": "clock", "before": "2",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 2: kernel parity at main-path shapes
    t0 = time.perf_counter()
    probe_inp = probe_inputs()
    report["probe_inputs_s"] = time.perf_counter() - t0
    parity = kernel_parity(dev, probe_inp)
    report["kernel_parity"] = parity
    emit({"phase": "kernel_parity", "pack_rowbytes": parity["pack_rowbytes"],
          "contraction": parity["contraction"],
          "flash_attention": parity["flash_attention"],
          "flash_widths": parity["flash_widths"],
          "flash_edges": parity["flash_edges"],
          "flash_prefill_bf16": parity["flash_prefill_bf16"],
          "flash_bwd": parity["flash_bwd"],
          "flash_bwd_widths": parity["flash_bwd_widths"],
          "flash_bwd_edges": parity["flash_bwd_edges"],
          "flash_grad_on_card": parity["flash_grad_on_card"],
          "quantize_non_finite": parity["quantize_non_finite"],
          "probe": parity["probe"]})
    # the grouped gather over block pools and a fault batch's seating
    paged_k = paged_kernels(dev, l2_flusher(dev))
    for name in ("pack_rows", "scatter_rows"):
        parity["rows"][name]["paged"] = paged_k[name]
    emit({"phase": "paged_kernels", **paged_k})
    drains = drain_parity(dev, report["link"]["bytes_per_s"])
    report["drains"] = drains
    emit({"phase": "drain_parity", **drains})
    chain_steps = chain_steps_parity(dev)
    report["chain_steps"] = chain_steps
    emit({"phase": "chain_steps_parity", "rounds": chain_steps["rounds"],
          "hops": chain_steps["hops"]})
    for name, row in chain_steps["rows"].items():
        # the one-step rows (a round at 2**22, a hop of the verify) stay in
        # the report
        chain_steps[f"{name}_one_step"] = parity["rows"][name]
        parity["rows"][name] = row
    # the chain kernels on the shard-major packed layout, named under their
    # kernels in the kernels line
    packed = packed_parity(dev)
    report["packed"] = packed
    emit({"phase": "packed_parity", **packed})
    report["smallest_gapped"] = smallest_gapped(dev)
    emit({"phase": "smallest_gapped", **report["smallest_gapped"]})
    for name in CHAIN_KERNELS:
        parity["rows"][name]["packed"] = {
            key: {k: v for k, v in case[name].items()}
            for key, case in packed.items()}
    emit({"phase": "clock", "before": "3",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 3: the main path at real size
    reset_launch_counts()
    WriteSet.gathers = 0
    main_runs, phase3 = [], {}
    with chain_call_sites() as calls3:
        for kind in KINDS:
            by_mode = {}
            for mode in ("full", "partly"):
                r = workload(kind, mode, MAIN_N[kind], dev)
                del r["arena"], r["structure"]
                by_mode[mode] = phase3[kind, mode] = r
                torch.cuda.empty_cache()
            saved = 1 - by_mode["partly"]["lines"] / by_mode["full"]["lines"]
            row = {"phase": "main_path", "kind": kind, "n": MAIN_N[kind],
                   "lines_full": by_mode["full"]["lines"],
                   "lines_partly": by_mode["partly"]["lines"],
                   "saved": saved,
                   **{f"{m}_{t}": by_mode[m][t] for m in by_mode
                      for t in ("insert_s", "delete_s", "recover_s")}}
            main_runs.append(row)
            emit(row)
    launches3, sizes3 = launch_counts(), launch_sizes()
    steps3 = launch_steps()
    gathers3 = gathers_check("main_path", launches3, WriteSet.gathers)
    chain3 = chain_calls_check("main_path", calls3, launches3)
    report["main_path"] = {"runs": main_runs, "launches": launches3,
                           "launch_sizes": sizes3, "launch_steps": steps3,
                           "gathers": gathers3, "chain_calls": chain3}
    emit({"phase": "main_path_launches", **launches3})
    emit(gathers3)
    emit(chain3)
    emit({"phase": "main_path_launch_sizes", **sizes3})
    emit({"phase": "main_path_launch_steps", **steps3})
    # phase 2's contraction checks on the DLL chain phase 3 recovered
    from repro_torch.core import recovery as TR
    if calls3.chain is None:
        raise AssertionError("phase 3 never contracted a chain")
    nxt, head, count = calls3.chain
    want = TR.chain_order(nxt, head, count, method="double")
    report["contraction_dll"] = contraction_case(dev, nxt, head, count, want,
                                                 l2_flusher(dev))
    emit({"phase": "contraction_dll", **report["contraction_dll"]})
    del nxt, want
    calls3.chain = None
    torch.cuda.empty_cache()
    syncs = {"off": syncs_per_op(dev),
             "on": syncs_per_op(dev, SNAP_KINDS, snapshot=True)}
    report["syncs_per_op"] = syncs
    emit({"phase": "syncs_per_op", **syncs})
    emit({"phase": "clock", "before": "4",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 4: card vs CPU
    same = []
    for kind in KINDS:
        for mode in ("partly", "full"):
            out = {}
            for d in ("cuda", "cpu"):
                r = workload(kind, mode, PARITY_N, d, seed=3)
                out[d] = (hashlib.sha256(image_of(r["arena"])).hexdigest(),
                          r["stats"])
            if out["cuda"] != out["cpu"]:
                raise AssertionError(f"{kind} {mode}: card and CPU images "
                                     f"or FlushStats differ")
            same.append(f"{kind}.{mode}:{out['cuda'][0][:12]}")
    for kind in SNAP_KINDS:
        for mode in ("partly", "full"):
            out = {}
            for d in ("cuda", "cpu"):
                r = snapshot_workload(kind, mode, PARITY_N, d, seed=3)
                out[d] = (hashlib.sha256(image_of(r["arena"])).hexdigest(),
                          r["stats"], r["details"])
            if out["cuda"] != out["cpu"]:
                raise AssertionError(f"{kind} {mode} snapshots: card and "
                                     f"CPU images, FlushStats or stage "
                                     f"details differ")
            same.append(f"{kind}.{mode}.snapshot:{out['cuda'][0][:12]}")
    from repro_torch.core import policy as pol
    small = ckpt_state(ckpt_config(small=True), torch.device("cpu"), seed=3)
    small_dev = pol.tree_map(lambda t: t.to(dev), small)
    for name in ("FULLY_PERSISTENT", "PARTLY_PERSISTENT", "PARTLY_Q8",
                 "PARTLY_DROP"):
        out = {d: ckpt_files(st, getattr(pol, name),
                             ROOT / "build" / "chip_smoke_parity" / d)
               for d, st in (("cuda", small_dev), ("cpu", small))}
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"checkpoint {name}: card and CPU files "
                                 f"differ")
        same.append(f"ckpt.{name}:{len(out['cuda'])} files:"
                    f"{out['cuda']['manifest.json'][:12]}")
    del small, small_dev
    shutil.rmtree(ROOT / "build" / "chip_smoke_parity")
    for mode in ("partly", "full"):
        for journal in (True, False):
            out = {d: feature_small(mode, journal, d) for d in ("cuda",
                                                                "cpu")}
            if out["cuda"] != out["cpu"]:
                raise AssertionError(f"feature store {mode} journal="
                                     f"{journal}: card and CPU images, "
                                     f"FlushStats or vectors differ")
            same.append(f"feature_store.{mode}.journal_{journal}:"
                        f"{out['cuda'][0][:12]}")
    out = {d: index_small(d) for d in ("cuda", "cpu")}
    if out["cuda"] != out["cpu"]:
        raise AssertionError("sample index: card and CPU images, "
                             "FlushStats or lookups differ")
    same.append(f"sample_index:{out['cuda'][0][:12]}")
    for a, b in zip(ops_small(dev), ops_small("cpu")):
        if not torch.equal(a, b):
            raise AssertionError("ops.pack_rows/scatter_rows: card and CPU "
                                 "differ")
    same.append("ops.pack_rows+scatter_rows:D=100,256")
    # four-shard arenas: every shard image and the manifest, FlushStats
    # aggregate and per shard, integrity off and on
    for kind in KINDS:
        for mode in ("partly", "full"):
            for integ in (False, True):
                out = {d: sharded_small(kind, mode, integ, d)
                       for d in ("cuda", "cpu")}
                if out["cuda"] != out["cpu"]:
                    raise AssertionError(f"{kind} {mode} sharded integrity="
                                         f"{integ}: card and CPU shard "
                                         f"images, manifest or FlushStats "
                                         f"differ")
                same.append(f"{kind}.{mode}.shards_{SHARDS}.integrity_"
                            f"{integ}:{out['cuda'][0][:12]}")
    # integrity on: images with their sidecars, FlushStats, the scrub after
    # the same fault and the salvage report, per structure and mixed
    for kind in KINDS:
        for mode in ("partly", "full"):
            out = {d: integrity_small(kind, mode, d) for d in ("cuda",
                                                               "cpu")}
            if out["cuda"] != out["cpu"]:
                raise AssertionError(f"{kind} {mode} integrity: card and CPU "
                                     f"images, FlushStats, scrub or salvage "
                                     f"reports differ")
            same.append(f"{kind}.{mode}.integrity:{out['cuda'][0][:12]}")
    for mode in ("partly", "full"):
        out = {d: mixed_small(mode, d) for d in ("cuda", "cpu")}
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"mixed {mode} integrity: card and CPU "
                                 f"images, FlushStats, scrub or salvage "
                                 f"reports differ")
        same.append(f"mixed.{mode}.integrity:{out['cuda'][0][:12]}:"
                    f"quarantined={out['cuda'][3]['quarantined']}:"
                    f"degraded={out['cuda'][3]['degraded']}")
    # shadow commit on one arena: images with both banks and the meta
    # line, FlushStats and recovered state per structure; the mixed arena
    # with integrity on, faulted in remapped rows, scrubbed and salvaged
    for kind in KINDS:
        for mode in ("partly", "full"):
            out = {d: shadow_small(kind, mode, d) for d in ("cuda", "cpu")}
            if out["cuda"] != out["cpu"]:
                raise AssertionError(f"{kind} {mode} shadow: card and CPU "
                                     f"images, FlushStats or recovered "
                                     f"state differ")
            same.append(f"{kind}.{mode}.shadow:{out['cuda'][0][:12]}")
    for kind in KINDS:
        for mode in ("partly", "full"):
            for integ in (False, True):
                out = {d: sharded_shadow_small(kind, mode, integ, d)
                       for d in ("cuda", "cpu")}
                if out["cuda"] != out["cpu"]:
                    raise AssertionError(f"{kind} {mode} sharded shadow "
                                         f"integrity={integ}: card and CPU "
                                         f"shard images, manifest, "
                                         f"FlushStats or recovered state "
                                         f"differ")
                same.append(f"{kind}.{mode}.shadow.shards_{SHARDS}."
                            f"integrity_{integ}:{out['cuda'][0][:12]}")
    for mode in ("partly", "full"):
        out = {d: shadow_mixed_small(mode, d) for d in ("cuda", "cpu")}
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"mixed {mode} shadow integrity: card and "
                                 f"CPU images, FlushStats, scrub or salvage "
                                 f"reports differ")
        same.append(f"mixed.{mode}.shadow.integrity:{out['cuda'][0][:12]}:"
                    f"faulted={out['cuda'][2]}:"
                    f"quarantined={out['cuda'][4]['quarantined']}:"
                    f"degraded={out['cuda'][4]['degraded']}")
    # paged DLLs (one and three shards, both commit modes) and the paged
    # fault path's verification on a mixed integrity arena
    same.extend(paged_card_vs_cpu(dev))
    torch.cuda.empty_cache()
    serve = serve_card_vs_cpu(dev)
    same.append(f"serve:{serve['file_sha256']}")
    # bf16 checkpoint leaves and the reference's pack_flush_rows=
    same.extend(bf16_ckpt_card_vs_cpu(dev))
    same.extend(pack_flush_rows_small(dev))
    # the serving launcher's entry point, on the card (its default device):
    # llama3.2-3b, and gemma's two
    launcher = launch_serve("llama3.2-3b")
    launcher["gemma"] = [launch_serve(a) for a in GEMMA_SERVE]
    # reduced gemma3 and gemma2 trained on the card and on the CPU
    from repro_torch.configs import base as cbase, registry as creg
    gemma_cpu = [train_card_vs_cpu(dev, cbase.reduced(creg.get(a)))
                 for a in GEMMA_TRAIN]
    # reduced dbrx-132b and maverick served and trained (twins bitwise)
    # on the card and on the CPU, and both launchers for an MoE arch;
    # first the bf16 products the decode scores and the expert FFN use
    moe_cpu = {"bf16_products": bf16_products_card_vs_cpu(dev),
               "serve": [serve_card_vs_cpu(dev, cbase.reduced(creg.get(a)))
                         for a in MOE_SERVE],
               "train": [train_card_vs_cpu(dev, cbase.reduced(creg.get(a)),
                                           twins=True) for a in MOE_SERVE]}
    launcher["moe"] = launch_serve("dbrx-132b")
    moe_cpu["launch_train"] = launch_train_on_card(
        "llama4-maverick-400b-a17b")
    # the reduced context archs: a seeded context's prefill and decode,
    # trained, and their launchers on the card
    context_cpu = {"serve": [context_card_vs_cpu(dev, a)
                             for a in CONTEXT_SERVE],
                   "train": [train_card_vs_cpu(dev, cbase.reduced(
                       creg.get(a))) for a in CONTEXT_SERVE]}
    launcher["context"] = launch_serve("whisper-large-v3")
    context_cpu["launch_train"] = launch_train_on_card(
        "llama-3.2-vision-90b")
    # the reduced hymba served and trained (twins bitwise) on the card and
    # on the CPU, and both launchers for it on the card
    hymba_small = cbase.reduced(creg.get(HYMBA))
    hybrid_cpu = {"serve": serve_card_vs_cpu(dev, hymba_small),
                  "train": train_card_vs_cpu(dev, hymba_small, twins=True)}
    launcher["hybrid"] = launch_serve(HYMBA)
    hybrid_cpu["launch_train"] = launch_train_on_card(HYMBA)
    # the reduced xlstm likewise
    xlstm_small = cbase.reduced(creg.get(XLSTM))
    xlstm_cpu = {"serve": serve_card_vs_cpu(dev, xlstm_small),
                 "train": train_card_vs_cpu(dev, xlstm_small, twins=True)}
    launcher["xlstm"] = launch_serve(XLSTM)
    xlstm_cpu["launch_train"] = launch_train_on_card(XLSTM)
    report["card_vs_cpu"] = {"identical": same, "serve": serve,
                             "launch_serve": launcher,
                             "gemma_train": gemma_cpu, "moe": moe_cpu,
                             "context": context_cpu, "hybrid": hybrid_cpu,
                             "xlstm": xlstm_cpu}
    emit({"phase": "card_vs_cpu", "n": PARITY_N, "identical": same,
          "serve": serve, "launch_serve": launcher,
          "gemma_train": gemma_cpu, "moe": moe_cpu,
          "context": context_cpu, "hybrid": hybrid_cpu,
          "xlstm": xlstm_cpu})
    emit({"phase": "clock", "before": "5",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 5: snapshot recovery at full size
    reset_launch_counts()
    WriteSet.gathers = 0
    snap_runs = []
    with chain_call_sites() as calls5:
        for kind in SNAP_KINDS:
            for mode in ("full", "partly"):
                r = snapshot_workload(kind, mode, SNAP_N, dev)
                r.pop("arena")
                r.pop("details")
                snap_runs.append(r)
                emit({"phase": "snapshot_recovery", **r})
                torch.cuda.empty_cache()
    launches5, sizes5 = launch_counts(), launch_sizes()
    steps5 = launch_steps()
    gathers5 = gathers_check("snapshot_recovery", launches5,
                             WriteSet.gathers)
    chain5 = chain_calls_check("snapshot_recovery", calls5, launches5)
    report["snapshot_recovery"] = {"runs": snap_runs, "launches": launches5,
                                   "launch_sizes": sizes5,
                                   "launch_steps": steps5,
                                   "gathers": gathers5,
                                   "chain_calls": chain5}
    emit({"phase": "snapshot_recovery_launches", **launches5})
    emit(gathers5)
    emit(chain5)
    emit({"phase": "snapshot_recovery_launch_sizes", **sizes5})
    emit({"phase": "snapshot_recovery_launch_steps", **steps5})
    # launches x (time - bound) at the sizes phases 3 and 5 launched
    both = {k: {sz: sizes3[k].get(sz, 0) + sizes5[k].get(sz, 0)
                for sz in set(sizes3[k]) | set(sizes5[k])} for k in sizes3}
    both_steps = {k: {sz: {st: steps3[k].get(sz, {}).get(st, 0)
                           + steps5[k].get(sz, {}).get(st, 0)
                           for st in set(steps3[k].get(sz, {}))
                           | set(steps5[k].get(sz, {}))}
                      for sz in set(steps3[k]) | set(steps5[k])}
                  for k in steps3}
    report["size_ranking"] = size_ranking(
        dev, {k: launches3[k] + launches5[k] for k in launches3}, both,
        both_steps, calls3.walks + calls5.walks)
    report["size_ranking"].update(contraction_ranking(
        dev, calls3.contractions + calls5.contractions, l2_flusher(dev)))
    emit({"phase": "size_ranking", **report["size_ranking"]})
    emit({"phase": "clock", "before": "6",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 6: checkpoint save and restore at llama3.2-3b width
    ckpt = checkpoint_phase(dev)
    report["checkpoint"] = ckpt
    for rep in ckpt["saves"]:
        emit({"phase": "checkpoint_save", **rep})
    emit({"phase": "checkpoint", **{k: v for k, v in ckpt.items()
                                    if k != "saves"}})
    quant = ("quantize_blockwise", "dequantize_blockwise")
    served = ("flash_attention", "scatter_rows")
    probed = ("probe",)
    trained = ("flash_attention_bwd",)
    launches = {k: launches3[k] + launches5[k] for k in launches3
                if k not in quant + served + probed + trained}
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"phases 3 and 5 never launched {missing}")
    if launches5["gather_next"] == 0:
        raise AssertionError("phase 5 never launched gather_next")
    launches.update({k: ckpt["launches"][k] for k in quant})
    missing = [k for k in quant if launches[k] == 0]
    if missing:
        raise AssertionError(f"phase 6 never launched {missing}")
    emit({"phase": "clock", "before": "7",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 7: serving at llama3.2-3b full width and depth
    serving = serving_phase(dev)
    report["serving"] = serving
    emit({"phase": "serving", **{k: v for k, v in serving.items()
                                 if k != "stats"}})
    emit({"phase": "serving_flush", **serving["stats"]})
    launches.update({k: serving["launches"][k] for k in served})
    missing = [k for k in served if launches[k] == 0]
    if missing:
        raise AssertionError(f"phase 7 never launched {missing}")
    emit({"phase": "clock", "before": "8",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 8: hash_lookup at real size
    probe = probe_phase(dev, probe_inp)
    del probe_inp
    report["hash_lookup"] = probe
    emit({"phase": "hash_lookup", **probe})
    launches["probe"] = probe["launches"]["probe"]
    emit({"phase": "clock", "before": "9",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 9: the feature store and the sample index at real size
    with chain_call_sites() as calls9:
        feature = feature_phase(dev)
    if feature["launches"]["walk_segments"] != len(calls9.contractions):
        raise AssertionError(
            f"phase 9: {feature['launches']['walk_segments']} walk_segments "
            f"launches for {len(calls9.contractions)} contract_walk calls")
    feature["contract_walk_calls"] = len(calls9.contractions)
    report["feature_store"] = feature
    emit({"phase": "feature_store", **{k: v for k, v in feature.items()
                                       if k not in ("stats", "twin_stats",
                                                    "gathers",
                                                    "launch_sizes")}})
    emit({"phase": "feature_store_flush", "crashed": feature["stats"],
          "twin": feature["twin_stats"]})
    emit(feature["gathers"])
    emit({"phase": "feature_store_launch_sizes", **feature["launch_sizes"]})
    emit({"phase": "clock", "before": "10",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 10: training at llama3.2-3b's published widths
    train = train_phase(dev)
    report["train"] = train
    emit({"phase": "train", **train})
    launches["flash_attention_bwd"] = train["launches"]["flash_attention_bwd"]
    report["train_bf16"] = train_bf16(dev)
    emit({"phase": "train_bf16", **report["train_bf16"]})
    train_cpu = train_card_vs_cpu(dev)
    launcher = launch_train_on_card(own_process=True)
    report["train_card_vs_cpu"] = train_cpu
    report["launch_train"] = launcher
    emit({"phase": "train_card_vs_cpu", **train_cpu})
    emit({"phase": "launch_train", **launcher})
    torch.cuda.empty_cache()
    emit({"phase": "clock", "before": "11",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 11: integrity and salvage at the main path's size
    integ = integrity_phase(dev, phase3)
    report["integrity"] = integ
    for row in integ["drains"]["rows"]:
        emit({"phase": "integrity_drain", **row})
    emit({"phase": "integrity_gate", **integ["gate"]})
    emit(integ["gathers"])
    emit({"phase": "integrity_mixed", "runs": integ["mixed_runs"],
          "scrub_s": integ["mixed_scrub_s"],
          "fault_rows": integ["fault_rows"],
          "salvage_chain_launches": integ["salvage_chain_launches"]})
    for name, rec_ in integ["salvage"].items():
        emit({"phase": "integrity_salvage", "case": name, **rec_})
    for name in ("full_mode", "feature_store", "engine", "catalog"):
        emit({"phase": f"integrity_{name}", **integ[name]})
    emit({"phase": "integrity", "phase_s": integ["phase_s"]})
    torch.cuda.empty_cache()
    emit({"phase": "clock", "before": "12",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 12: sharded arenas at the main path's size
    reset_launch_counts()
    sharded = sharded_phase(dev, phase3)
    launches12 = launch_counts()
    report["sharded"] = sharded
    for row in sharded["structures"]["rows"]:
        emit({"phase": "sharded_structure", **row})
    emit({"phase": "sharded_packed_api",
          **sharded["structures"]["packed_api"]})
    emit({"phase": "sharded_commit_window", **sharded["commit_window"]})
    emit({"phase": "sharded_fatal", **sharded["fatal"]})
    emit({"phase": "sharded_serving", **sharded["serving"]})
    emit({"phase": "sharded_flush_gate", **sharded["flush_gate"]})
    emit({"phase": "sharded", "launches": launches12,
          **{k: v for k, v in sharded.items() if k.endswith("_s")}})
    missing = [k for k in CHAIN_KERNELS + ("pack_rows", "scatter_rows",
                                           "flash_attention")
               if launches12[k] == 0]
    if missing:
        raise AssertionError(f"phase 12 never launched {missing}")
    torch.cuda.empty_cache()
    emit({"phase": "clock", "before": "13",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 13: shadow commit, one arena and four shards
    reset_launch_counts()
    shadow = shadow_phase(dev, launches3, study=args.crossover_study)
    launches13 = launch_counts()
    report["shadow"] = shadow
    for row in shadow["structures"]["rows"]:
        emit({"phase": "shadow_structure", **row})
    emit({"phase": "shadow_torn", **shadow["torn"]})
    emit({"phase": "shadow_serving", **shadow["serving"]})
    for row in shadow["sharded_structures"]["rows"]:
        emit({"phase": "shadow_sharded_structure", **row})
    emit({"phase": "shadow_sharded_window", **shadow["sharded_window"]})
    emit({"phase": "shadow_sharded_serving", **shadow["sharded_serving"]})
    emit({"phase": "shadow_crossover", **shadow["crossover"]})
    emit({"phase": "shadow_crossover_late", **shadow["crossover_late"]})
    emit({"phase": "shadow", "launches": launches13,
          "chain_launches": shadow["structures"]["chain_launches"],
          "sharded_chain_launches":
              shadow["sharded_structures"]["chain_launches"],
          **{k: v for k, v in shadow.items() if k.endswith("_s")}})
    missing = [k for k in CHAIN_KERNELS + ("pack_rows", "scatter_rows",
                                           "flash_attention")
               if launches13[k] == 0]
    if missing:
        raise AssertionError(f"phase 13 never launched {missing}")
    torch.cuda.empty_cache()
    emit({"phase": "clock", "before": "14",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 14: paged regions and the block cache
    from repro_torch.core.paging import _BlockPool
    reset_launch_counts()
    WriteSet.gathers = 0
    _BlockPool.fault_batches = 0
    paged = paged_phase(dev)
    launches14 = launch_counts()
    gathers14 = gathers_check("paged", launches14, WriteSet.gathers)
    report["paged"] = paged
    for name in ("parity", "parity_2_22"):
        for row in paged[name]["rows"]:
            emit({"phase": f"paged_{name}", **row})
        emit({"phase": f"paged_{name}_ratio",
              "lines_per_s_ratio": paged[name]["lines_per_s_ratio"],
              "gated": paged[name]["gated"]})
    for name in ("budget", "budget_no_snapshot", "sharded"):
        emit({"phase": f"paged_{name}", **paged[name]})
    for row in paged["ttft"]["rows"]:
        emit({"phase": "paged_ttft", **row})
    emit(gathers14)
    emit({"phase": "paged", "launches": launches14,
          "fault_batches": _BlockPool.fault_batches,
          "parity_launches": paged["parity_launches"],
          "ttft_ratio_paged": paged["ttft"]["ttft_ratio_paged"],
          "phase_s": paged["phase_s"]})
    missing = [k for k in CHAIN_KERNELS + ("pack_rows", "scatter_rows")
               if launches14[k] == 0]
    if missing:
        raise AssertionError(f"phase 14 never launched {missing}")
    torch.cuda.empty_cache()
    emit({"phase": "clock", "before": "15",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 15: gemma3-27b and gemma2-9b served at full width
    reset_launch_counts()
    WriteSet.gathers = 0
    gemma = gemma_phase(dev)
    launches15 = launch_counts()
    gathers15 = gathers_check("gemma", launches15, WriteSet.gathers)
    report["gemma"] = gemma
    for arch in GEMMA_SERVE:
        emit({"phase": "gemma_serving", **gemma[arch]})
    emit(gathers15)
    emit({"phase": "gemma", "launches": launches15,
          "phase_s": gemma["phase_s"]})
    missing = [k for k in ("flash_attention", "pack_rows", "scatter_rows")
               if launches15[k] == 0]
    if missing:
        raise AssertionError(f"phase 15 never launched {missing}")
    emit({"phase": "clock", "before": "16",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 16: gemma3-27b and gemma2-9b trained at full width
    reset_launch_counts()
    gemma_train = gemma_train_phase(dev)
    launches16 = launch_counts()
    report["gemma_train"] = gemma_train
    for arch in GEMMA_TRAIN:
        emit({"phase": "gemma_train", **gemma_train[arch]})
    emit({"phase": "gemma_train_launch", **gemma_train["launch_train"]})
    emit({"phase": "gemma_train_phase", "launches": launches16,
          "phase_s": gemma_train["phase_s"]})
    missing = [k for k in ("flash_attention", "flash_attention_bwd")
               if launches16[k] == 0]
    if missing:
        raise AssertionError(f"phase 16 never launched {missing}")
    emit({"phase": "clock", "before": "17",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 17: dbrx-132b and maverick served at their published widths
    reset_launch_counts()
    WriteSet.gathers = 0
    moe = moe_phase(dev)
    launches17 = launch_counts()
    gathers17 = gathers_check("moe", launches17, WriteSet.gathers)
    report["moe"] = moe
    for arch in MOE_SERVE:
        emit({"phase": "moe_serving", **moe[arch]})
    emit({"phase": "moe_backward", **moe["backward"]})
    emit(gathers17)
    emit({"phase": "moe", "launches": launches17, "phase_s": moe["phase_s"]})
    missing = [k for k in ("flash_attention", "pack_rows", "scatter_rows")
               if launches17[k] == 0]
    if missing:
        raise AssertionError(f"phase 17 never launched {missing}")
    emit({"phase": "clock", "before": "18",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 18: llama-3.2-vision-90b and whisper-large-v3, contexts
    reset_launch_counts()
    context = context_phase(dev)
    launches18 = launch_counts()
    report["context"] = context
    for arch in CONTEXT_SERVE:
        emit({"phase": "context_serving", **context[arch]["serve"]})
        emit({"phase": "context_cross", "arch": arch,
              **context[arch]["cross"]})
    emit({"phase": "context_train", **context["train"]})
    emit({"phase": "context_layer_twins", **context["layer_twins"]})
    emit({"phase": "context", "launches": launches18,
          "phase_s": context["phase_s"]})
    missing = [k for k in ("flash_attention", "flash_attention_bwd",
                           "pack_rows", "scatter_rows")
               if launches18[k] == 0]
    if missing:
        raise AssertionError(f"phase 18 never launched {missing}")
    emit({"phase": "clock", "before": "19",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 19: hymba-1.5b's hybrid layers, whole
    reset_launch_counts()
    hymba = hymba_phase(dev)
    launches19 = launch_counts()
    report["hymba"] = hymba
    emit({"phase": "hymba_serving", **{k: v for k, v in
                                       hymba["serve"].items()
                                       if k != "scan"}})
    emit({"phase": "hymba_scan_share", **hymba["serve"]["scan"]})
    emit({"phase": "hymba_checks", **hymba["checks"]})
    emit({"phase": "hymba_train", **hymba["train"]})
    emit({"phase": "hymba", "launches": launches19,
          "init_params_s": hymba["init_params_s"],
          "phase_s": hymba["phase_s"]})
    missing = [k for k in ("flash_attention", "flash_attention_bwd",
                           "pack_rows", "scatter_rows")
               if launches19[k] == 0]
    if missing:
        raise AssertionError(f"phase 19 never launched {missing}")
    emit({"phase": "clock", "before": "20",
          "at_s": time.perf_counter() - t_run})
    # ---- phase 20: xlstm-1.3b's mLSTM and sLSTM layers, whole
    reset_launch_counts()
    xlstm = xlstm_phase(dev)
    launches20 = launch_counts()
    report["xlstm"] = xlstm
    emit({"phase": "xlstm_serving", **{k: v for k, v in
                                       xlstm["serve"].items()
                                       if k != "recurrences"}})
    emit({"phase": "xlstm_recurrence_share",
          **xlstm["serve"]["recurrences"]})
    emit({"phase": "xlstm_checks", **xlstm["checks"]})
    emit({"phase": "xlstm_train", **xlstm["train"]})
    emit({"phase": "xlstm", "launches": launches20,
          **{k: v for k, v in xlstm.items() if k.endswith("_s")}})
    missing = [k for k in ("pack_rows", "scatter_rows")
               if launches20[k] == 0]
    if missing:
        raise AssertionError(f"phase 20 never launched {missing}")
    attention = {k: launches20[k] for k in ("flash_attention",
                                            "flash_attention_bwd")
                 if launches20[k]}
    if attention:
        raise AssertionError(f"phase 20 (no attention layer) launched "
                             f"{attention}")
    emit({"phase": "clock", "before": "summary",
          "at_s": time.perf_counter() - t_run})
    # ---- summary
    kernels = []
    for name, row in parity["rows"].items():
        kernels.append({"name": name, "route": "cuda",
                        "launches": launches[name], "bound_by": "bytes",
                        "paged_launches": launches14[name],
                        "gemma_launches": launches15[name],
                        "gemma_train_launches": launches16[name],
                        "moe_launches": launches17[name],
                        "context_launches": launches18[name],
                        "hymba_launches": launches19[name],
                        "xlstm_launches": launches20[name], **row})
    if sorted(k["name"] for k in kernels) != sorted(WRAPPERS):
        raise AssertionError("the kernels line does not list every kernel")
    report["card"] = card
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1,
                                                default=str))
    emit({"phase": "clock", "before": "exit",
          "at_s": time.perf_counter() - t_run})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
