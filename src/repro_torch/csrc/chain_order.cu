// Chain ranking kernels: the device rounds of the recovery layer's list
// ranking (pointer doubling and contraction), all on int32 node ids.
//
// Every pointer these kernels read is range-checked before it is followed:
// a value outside [0, n) ends the chain like NULL (-1).  The wrappers narrow
// 64-bit NEXT columns to int32 only after a 64-bit range check, so a torn
// 2**32 + 3 has already become NULL here and cannot alias node 3.
//
// jump_double
//   Replaces src/repro/kernels/chain_order.py:94 jump_double (_double_kernel,
//   pallas_call at :133), one doubling round steered through a
//   scalar-prefetched pointer array.  One round computes
//   jump'[i] = jump[jump[i]] and cnt'[i] = cnt[i] + cnt[jump[i]] for live
//   lanes; NULL absorbs, out-of-range values become NULL.  A launch runs
//   `rounds` such rounds: every level of a binary-lifting table
//   (chain_tables, `keep`: level 0 the input, level s after s rounds) or
//   the whole absorb of a ranking (_absorb: n.bit_length() rounds, only
//   the last jump and cnt kept).
//   Bound at the main path's sizes: launches.  The rankings run on the
//   contracted chains (<= 2**18 nodes; 131,073 for a 2**22 chain): a round
//   moves 24 B per node (4.7 MB at 131,073 nodes, 1.4 us at 3.35 TB/s),
//   and all of it stays in the 50 MB L2, so one launch and one host call
//   per round (17-18 of each per ranking) cost more than the rounds.
//   Design: one persistent cooperative launch per call, the grid sized to
//   the blocks of 1024 threads that fit at once (occupancy x SMs, queried
//   once per device); each thread strides over nodes, and the rounds are
//   separated by cooperative_groups' grid.sync().  A round then costs
//   3-4 us at 2**16-2**17 nodes on an H100 (chip_smoke.py): two dependent
//   L2 round trips and the grid barrier, against 7-11 us of card time for
//   a launch of its own and more of the host's.  cnt ping-pongs between two
//   buffers, and so does jump when the levels are not kept; the buffers
//   are arranged so that the last round writes the returned ones.  Data
//   written by another block in an earlier round of the same launch is
//   read with __ldcg (L2, never a possibly stale L1 line and never the
//   non-coherent path); only the caller's input is read through __ldg.
//   Gather half: per node one 4 B and one 8 B load at a data-dependent
//   address, as random as the chain.
//
// walk_segments
//   Replaces src/repro/kernels/chain_order.py:198 walk_segments (inner
//   kern, pallas_call at :282), the fused local walk of contraction.  Per
//   lane, up to `budget` hops along nxt until a spine node (id % k == 0,
//   or the promoted head, whose spine index is n_mult; or a spine_pos
//   table lookup when one is given) or the chain end.  Returns the final
//   id, the spine index it arrived at (NULL if it did not) and the hops
//   taken; with a checkpoint buffer also every `stride`-th node of each
//   segment (below).
//   Bound: latency, and the L2's rate of random sectors.  Each hop is a
//   dependent 4 B load.  While most lanes walk (the first ~60 hops of a
//   random chain contracted by 32) the card has ~10**5 loads in flight
//   and the L2 queues them; then the longest segment (360-450 hops on a
//   random 2**22-node chain) finishes alone at one L2 hit per hop.  The
//   byte floor of hops * 4 B (or 32 B sectors) is a lower bound the walk
//   cannot reach.
//   Design: one launch walks a contraction to its end (the driver gives
//   the whole budget at once instead of rounds of 64 hops, each a launch,
//   a compaction and a sync).  nxt stays in the L2 without being asked:
//   the busy first hops touch nearly every sector of it (16 MiB at 2**22
//   nodes), so the long tail hits the 50 MB L2 even when the launch
//   starts with it evicted (measured equal to a launch that finds nxt
//   resident, chip_smoke.py phase 2; a pre-read or an evict_last policy
//   bought nothing, so none is set and nothing outlives the call).  Hops
//   load through the read-only path; a power-of-two k (CONTRACT_K = 32)
//   tests the spine with a mask and a shift, not a division.  A warp's
//   lanes step together (the loop runs while any lane walks), so the
//   checkpoint test at every `stride`-th hop is uniform across the warp.
//   Checkpoints: at hop t (t % stride == 0) a lane that walks on past t
//   records (lane, t, node).  A warp appends its records through one
//   atomicAdd of their count (a ballot, the first recording thread bumps
//   the 64-bit counter, a shuffle hands out the base).  The buffer holds
//   ceil(n / stride) + lanes records: where no node has two predecessors
//   (every chain the structures persist) the segments are disjoint, a
//   lane of w hops records floor((w - 1) / stride) nodes of its own, and
//   all lanes together at most n / stride, so a real chain cannot fill
//   it.  Torn pointers can merge segments (two nodes pointing at one);
//   then lanes share nodes and may record more.  The counter counts every
//   record, only those that fit are stored, and the expand plan walks its
//   segments again when the count exceeds the buffer.
//
// expand_segments
//   Replaces src/repro/kernels/chain_order.py:293 expand_segments (inner
//   kern, pallas_call at :357).  Lane i walks rem[i] hops from starts[i]
//   and writes each visited id at out[posn[i] + t].  The Pallas kernel
//   re-stores retired steps because its grid steps share one output block;
//   lanes here retire by leaving the loop, and each output slot is written
//   exactly once.
//   Bound: with one lane per segment, latency, as walk_segments: the
//   longest segment's 360-450 dependent hops.  The driver now splits every
//   segment at the walk's checkpoints, so no run is longer than `stride`
//   nodes; then the L2's rate of random sectors (one per hop, nxt
//   resident as in the walk) and the 8 B per position of the order
//   (32 MiB at 2**22 positions) are what is left.
//   Design: a warp takes 32 runs; each thread walks up to `chunk` hops of
//   its run and stages the ids in shared memory; then the warp stores the
//   staged runs with consecutive threads at consecutive positions (a run
//   of 16 ids is one 128 B line), where one thread per run touched 32
//   lines per store.  Runs longer than `chunk` take more rounds of the
//   same.  The stores stream (st.global.cs, evicted first), so 32 MiB of
//   order does not push nxt out of the L2.  Block size and grid come from
//   the occupancy API, the staging being dynamic shared memory.
//
// gather_next
//   Replaces src/repro/kernels/chain_order.py:152 gather_next
//   (_gather_kernel, pallas_call at :189), one prefetch-steered chain hop
//   per lane.  One hop computes out[i] = nxt[ids[i]] for 0 <= ids[i] < n,
//   else NULL.  ids are read at their own width (int64 or int32) and
//   range-checked before use, so a torn 2**32 + 3 gives NULL instead of
//   aliasing node 3.  The gathered value is returned as stored, as the
//   Pallas kernel returns it: callers sanitize nxt first.  A launch walks
//   `hops` hops: column t holds t + 1 applications of the hop, stored at
//   out[t * lanes + i], and a walk may also report its length: the
//   leading columns of (ids, out[0], ..., out[hops - 1]) that hold an id
//   in [0, n) in some lane.
//   Bound at the main path's sizes: launches and syncs.  chain_walk's
//   level-synchronous walks (the hashmap's unlink, 8192 lanes, about 6
//   columns) used to take one launch, one reduction and one blocking
//   read per column for 8192 dependent 4 B loads (0.04 us of bytes).
//   Design: one thread per lane keeps its id in a register and walks all
//   its hops (nxt is read-only, so __ldg); a warp's stores of one column
//   coalesce.  The length is reduced on the card: a warp max, a block max
//   in shared memory, one atomicMax per block into a device word; the
//   last block to finish stores the result into mapped pinned host memory
//   with a plain store (no atomics cross the bus) and re-arms the device
//   words for the next launch.  The caller synchronizes the stream once.
//   The snapshot verify (one hop, up to 2**23 lanes) is bound by bytes:
//   the ids read and the 4 B store stream, the nxt load is one 32 B
//   sector per lane while nxt misses the 50 MB L2.
// The shard-major packed layout (segments=, seg_rows=)
//   Replaces the `segments`/`seg_rows` form of the four Pallas kernels
//   above (src/repro/kernels/chain_order.py:94, :152, :198, :293) and
//   their closed-form translate packed_positions (:58).  A sharded
//   region's NEXT column arrives as the shards' persistent views
//   concatenated shard-major, while the pointer VALUES stay global ids.
//   Under the block-cyclic router of B rows over N shards, global id c
//   sits at packed position
//     segments[(c / B) % N] + (c / (B * N)) * B + c % B,
//   exact even when the last block is partial, because a shard's earlier
//   blocks are always full.  Every array these kernels index by a node id
//   (nxt; jump and cnt) is indexed through that translate, evaluated in
//   the kernel; ids, the values loaded and the values stored stay global,
//   and arrays indexed by lane or by position (jump's rows, the outputs)
//   stay as they are.  jump_double keeps the same translate across all
//   the rounds of its cooperative launch: its table rows sit at packed
//   positions and hold global ids.  The range checks stay on the global
//   id (0 <= c < n, n the total rows), so the torn-pointer contract is
//   the global layout's.
//   Design: a template case (kLayout: global, packed with B and N powers
//   of two, packed in general), as kTable and kPow2 are, so that an
//   unpacked launch compiles to the code it was.  The translate sits on
//   the dependent path of every hop, so it is kept to a few integer
//   operations and no memory access.  The offsets are the router's
//   partition of the n rows (the wrapper checks it), so they are closed
//   form too: with R = n / (B * N) full rounds and T = n - R * B * N rows
//   in the partial one, segments[s] = s * R * B + min(s * B, T); no table
//   is read (an offset table in device memory cost an L1 round trip a
//   hop, and a kernel parameter indexed at run time would be copied to
//   the stack).  B = 64 and N = 4 on the main path: powers of two, a
//   case of its own of shifts and masks in 32-bit arithmetic (positions
//   are below 2^31, and B * N below 2^31 is checked); N = 3 occurs: the
//   general case divides by a multiply-high by ceil(2^32 / N), used only
//   where it is exact for every segment index of the launch (else a
//   division).  A first design with two run-time divisions and the
//   offsets read from device memory ran the walk at 1.38-1.41x the
//   global layout's time on an H100 (chip_smoke phase 2).
// Offsets with gaps (kPackedGapped)
//   The reference's contract is any N + 1 non-decreasing offsets: a
//   shard's span may end in padding rows.  Such offsets are not closed
//   form, so they ride by value in a kernel parameter of their own
//   (Offsets, up to kMaxGappedShards + 1 of them), never in device
//   memory.  It is a __grid_constant__ parameter: indexed at run time, it
//   is read in place through the constant cache instead of being copied
//   to the stack.  For the other layouts that parameter is one unused
//   word and Packing is unchanged: giving every layout the offsets (in
//   Packing, then staged in shared memory) ran the partition's walk 8 %
//   and the global expand 11 % slower on an H100 (chip_smoke's packed
//   cases against the same cases before the gapped layout, in turns).
//   An id whose position falls past its shard's span addresses no row and
//   reads as NULL, like an id outside [0, n), wherever it appears: as an
//   input and as a value loaded.  So a gapped hop translates both the id
//   it follows and the value it loads.  The wrapper picks the layout once
//   per call.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kNull = -1;
constexpr int kMaxDevices = 64;
constexpr int kRoundThreads = 1024;  // the fewest blocks meet at a barrier

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSegmentThreads = 256;  // most threads per block of the walk
                                      // and the expand: small launches
                                      // still spread over the SMs

// Streaming multiprocessors of the current device, queried once per device.
int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < kMaxDevices) cached[dev] = sms;
  return sms;
}

// The layouts (kLayout): global, packed with B and N powers of two (the
// main path's), packed in general, packed at offsets with gaps.
constexpr int kGlobal = 0;
constexpr int kPackedPow2 = 1;
constexpr int kPackedAny = 2;
constexpr int kPackedGapped = 3;
constexpr int kMaxGappedShards = 64;  // MAX_GAPPED_SHARDS of the wrapper

// The shard-major packing of a launch over n rows (make_packing): B rows a
// segment, N shards, and what the translate needs precomputed.  Every
// position and B * N are below 2^31, so 32-bit arithmetic is exact.
struct Packing {
  uint32_t seg_rows;     // B
  uint32_t n_shards;     // N
  uint32_t seg_shift;    // log2(B) for a power of two, else 32
  uint32_t shard_shift;  // log2(N) for a power of two, else 32
  uint32_t magic;        // ceil(2^32 / N) where exact, else 0
  uint32_t round_rows;   // R * B: a shard's rows in the full rounds
  uint32_t tail;         // T: the rows of the partial round
  int layout;            // kGlobal, kPackedPow2, kPackedAny or kPackedGapped
};

// A launch's offsets with gaps: the N + 1 for kPackedGapped, one unused
// word for the other layouts.
template <int kLayout>
struct Offsets {
  uint32_t v[kLayout == kPackedGapped ? kMaxGappedShards + 1 : 1];
};

// Array position of global id c (0 <= c < n): c itself, or the packed
// position of the block-cyclic router.  At offsets with gaps (`gaps`, the
// launch's Offsets) a position past the shard's span gives -1.
template <int kLayout>
__device__ __forceinline__ int64_t at(const Packing& p, int32_t c,
                                      const uint32_t* gaps) {
  if (kLayout == kGlobal) return c;
  const uint32_t u = (uint32_t)c;
  uint32_t seg, off, round, shard;
  if (kLayout == kPackedPow2) {
    seg = u >> p.seg_shift;
    off = u & (p.seg_rows - 1);
    round = seg >> p.shard_shift;
    shard = seg & (p.n_shards - 1);
    return (int64_t)(shard * p.round_rows + min(shard << p.seg_shift, p.tail) +
                     (round << p.seg_shift) + off);
  }
  if (p.seg_shift < 32) {
    seg = u >> p.seg_shift;
    off = u & (p.seg_rows - 1);
  } else {
    seg = u / p.seg_rows;
    off = u - seg * p.seg_rows;
  }
  if (p.shard_shift < 32)
    round = seg >> p.shard_shift;
  else if (p.magic != 0)
    round = __umulhi(seg, p.magic);
  else
    round = seg / p.n_shards;
  shard = seg - round * p.n_shards;
  if (kLayout == kPackedGapped) {
    // below 2^32: the offsets are at most n and the local row at most c
    const uint32_t pos = gaps[shard] + round * p.seg_rows + off;
    return pos < gaps[shard + 1] ? (int64_t)pos : -1;
  }
  return (int64_t)(shard * p.round_rows + min(shard * p.seg_rows, p.tail) +
                   round * p.seg_rows + off);
}

// One chain hop: NULL for an id that addresses no row (outside [0, n), or
// past its shard's span at offsets with gaps) or a stored value that
// addresses none.  nxt is read-only for the whole launch: the read-only
// path (__ldg).
template <int kLayout>
__device__ __forceinline__ int32_t follow(const int32_t* __restrict__ nxt,
                                          int32_t cur, int64_t n,
                                          const Packing& p,
                                          const uint32_t* gaps) {
  if (cur < 0 || cur >= n) return kNull;
  const int64_t pc = at<kLayout>(p, cur, gaps);
  if (kLayout == kPackedGapped && pc < 0) return kNull;
  const int32_t v = __ldg(nxt + pc);
  if (v < 0 || v >= n) return kNull;
  if (kLayout == kPackedGapped && at<kLayout>(p, v, gaps) < 0) return kNull;
  return v;
}

// Threads per block and blocks resident on the device for a kernel, from
// the occupancy API with `smem_per_thread` bytes of dynamic shared memory
// per thread; queried once per device into `cache`.
struct LaunchShape {
  int block;
  int64_t resident;
};

template <typename Kernel>
cudaError_t launch_shape(Kernel kernel, int smem_per_thread,
                         LaunchShape* cache, LaunchShape* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev].block > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  int min_grid = 0, block = 0;
  err = cudaOccupancyMaxPotentialBlockSizeVariableSMem(
      &min_grid, &block, kernel,
      [smem_per_thread](int b) { return (size_t)b * smem_per_thread; },
      kSegmentThreads);
  if (err != cudaSuccess) return err;
  block &= ~31;  // whole warps: the kernels step warp by warp
  int per_sm = 0;
  if (block > 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, block, (size_t)block * smem_per_thread);
    if (err != cudaSuccess) return err;
  }
  if (block <= 0 || per_sm <= 0 || sm_count() <= 0)
    return cudaErrorInvalidConfiguration;
  out->block = block;
  out->resident = (int64_t)per_sm * sm_count();
  if (dev < kMaxDevices) cache[dev] = *out;
  return cudaSuccess;
}

// Blocks for `work` threads at the shape's block size, no more than fit.
unsigned blocks_for(const LaunchShape& s, int64_t work) {
  int64_t blocks = (work + s.block - 1) / s.block;
  if (blocks > s.resident) blocks = s.resident;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

// Buffers of one jump_double launch.  Round s (1-based) reads level s - 1
// and writes level s.  With `keep`, jbuf[0] is the (rounds + 1, n) table;
// otherwise round s writes jbuf[(rounds - s) & 1], so the last round writes
// jbuf[0], the returned jump.  cbuf alternates the same way.  Round 1 reads
// the caller's jump and cnt.
struct JumpRounds {
  const int32_t* jump;
  const int64_t* cnt;
  int32_t* jbuf[2];
  int64_t* cbuf[2];
  int64_t n;
  int rounds;
  Packing pack;
};

// kInput: the round reads the caller's arrays, which no block writes, so
// the read-only path is safe; later rounds read what other blocks wrote
// before the last grid.sync(), through L2 (__ldcg).
template <bool kInput>
__device__ __forceinline__ int32_t load(const int32_t* p) {
  return kInput ? __ldg(p) : __ldcg(p);
}

template <bool kInput>
__device__ __forceinline__ int64_t load(const int64_t* p) {
  const long long* q = reinterpret_cast<const long long*>(p);
  return (int64_t)(kInput ? __ldg(q) : __ldcg(q));
}

template <bool kInput, bool kKeep, bool kCnt, int kLayout>
__device__ __forceinline__ void jump_round(const JumpRounds& a,
                                           const int32_t* __restrict__ js,
                                           const int64_t* __restrict__ cs,
                                           int32_t* __restrict__ jd,
                                           int64_t* __restrict__ cd,
                                           const uint32_t* gaps) {
  const int64_t n = a.n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t j = load<kInput>(js + i);
    if (kKeep && kInput) a.jbuf[0][i] = j;  // level 0: the input as given
    bool live = j >= 0 && j < n;
    int32_t nj = kNull;
    int64_t pj = 0;
    if (live) {
      pj = at<kLayout>(a.pack, j, gaps);
      if (kLayout == kPackedGapped) live = pj >= 0;
    }
    if (live) {
      const int32_t v = load<kInput>(js + pj);
      if (v >= 0 && v < n &&
          (kLayout != kPackedGapped || at<kLayout>(a.pack, v, gaps) >= 0))
        nj = v;
    }
    jd[i] = nj;
    if (kCnt)
      cd[i] = load<kInput>(cs + i) + (live ? load<kInput>(cs + pj) : 0);
  }
}

template <bool kKeep, bool kCnt, int kLayout>
__global__ void __launch_bounds__(kRoundThreads)
    jump_double_kernel(const JumpRounds a,
                       const __grid_constant__ Offsets<kLayout> gaps) {
  const int r = a.rounds;
  // selected by a branch, not an index: a kernel parameter indexed at run
  // time is copied to the stack
  auto level = [&](int s) -> int32_t* {
    if (kKeep) return a.jbuf[0] + (int64_t)s * a.n;
    return ((r - s) & 1) ? a.jbuf[1] : a.jbuf[0];
  };
  auto counts = [&](int s) -> int64_t* {
    return ((r - s) & 1) ? a.cbuf[1] : a.cbuf[0];
  };
  jump_round<true, kKeep, kCnt, kLayout>(a, a.jump, a.cnt, level(1),
                                         counts(1), gaps.v);
  for (int s = 2; s <= r; ++s) {
    cg::this_grid().sync();
    jump_round<false, kKeep, kCnt, kLayout>(a, level(s - 1), counts(s - 1),
                                            level(s), counts(s), gaps.v);
  }
}

// Arguments of one walk_segments launch.  rec is null without
// checkpoints; otherwise rows lane, hop, node of `capacity` records and
// *total the records the walk made (zeroed before the launch).
struct WalkArgs {
  const int32_t* nxt;
  const int32_t* starts;
  const int32_t* spine_pos;  // null: arithmetic spine test
  int32_t* cur_out;
  int32_t* sp_out;
  int32_t* w_out;
  int32_t* rec;
  unsigned long long* total;
  int64_t n;
  int64_t lanes;
  int64_t capacity;
  int32_t k;
  int32_t head;
  int32_t n_mult;
  int32_t budget;
  int32_t shift;   // log2(k) when k is a power of two
  int32_t stride;  // a power of two
  int promoted;
  Packing pack;
};

// kPow2: k is a power of two (CONTRACT_K = 32): a mask and a shift, not a
// division, on every hop.
template <bool kTable, bool kPow2>
__device__ __forceinline__ int32_t spine_index(const WalkArgs& a,
                                               int32_t id) {
  if (kTable) return __ldg(a.spine_pos + id);
  int32_t s;
  if (kPow2)
    s = (id & (a.k - 1)) == 0 ? id >> a.shift : kNull;
  else
    s = (id % a.k == 0) ? id / a.k : kNull;
  if (a.promoted && id == a.head) s = a.n_mult;
  return s;
}

template <bool kTable, bool kPow2, int kLayout>
__global__ void __launch_bounds__(kSegmentThreads)
    walk_segments_kernel(const WalkArgs a,
                         const __grid_constant__ Offsets<kLayout> gaps) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  // a warp's 32 lanes together: every thread of the warp runs the loops
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane;
       base < a.lanes; base += step) {
    const int64_t i = base + lane;
    int32_t cur = i < a.lanes ? a.starts[i] : kNull;
    int32_t sp = kNull;
    int32_t w = 0;
    bool walking = cur >= 0 && a.budget > 0;
    for (int32_t t = 1; __any_sync(kFull, walking); ++t) {
      bool mark = false;
      if (walking) {
        cur = follow<kLayout>(a.nxt, cur, a.n, a.pack, gaps.v);
        w = t;
        walking = false;
        if (cur >= 0) {
          const int32_t s = spine_index<kTable, kPow2>(a, cur);
          if (s >= 0) {
            sp = s;
          } else if (t < a.budget) {  // walks on past hop t
            walking = true;
            mark = (t & (a.stride - 1)) == 0;
          }
        }
      }
      if (a.rec != nullptr && (t & (a.stride - 1)) == 0) {  // warp-uniform
        const unsigned m = __ballot_sync(kFull, mark);
        if (m) {
          const int first = __ffs(m) - 1;
          unsigned long long slot = 0;
          if ((int)lane == first)
            slot = atomicAdd(a.total, (unsigned long long)__popc(m));
          slot = __shfl_sync(kFull, slot, first) + __popc(m & below);
          if (mark && slot < (unsigned long long)a.capacity) {
            a.rec[slot] = (int32_t)i;
            a.rec[a.capacity + slot] = t;
            a.rec[2 * a.capacity + slot] = cur;
          }
        }
      }
    }
    if (i < a.lanes) {
      a.cur_out[i] = cur;
      a.sp_out[i] = sp;
      a.w_out[i] = w;
    }
  }
}

// Arguments of one expand_segments launch.
struct ExpandArgs {
  const int32_t* nxt;
  const int32_t* starts;
  const int32_t* posn;
  const int32_t* rem;
  long long* out;
  int64_t n;
  int64_t lanes;
  Packing pack;
};

// kChunk: ids a thread stages per round; a warp's staging is 32 runs of
// kChunk + 1 words (the pad word keeps the threads' writes on 32 banks).
template <int kChunk, int kLayout>
__global__ void __launch_bounds__(kSegmentThreads)
    expand_segments_kernel(const ExpandArgs a,
                           const __grid_constant__ Offsets<kLayout> gaps) {
  extern __shared__ int32_t staging[];
  const unsigned lane = threadIdx.x & 31;
  int32_t* warp_stage = staging + (threadIdx.x >> 5) * 32 * (kChunk + 1);
  int32_t* mine = warp_stage + lane * (kChunk + 1);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane;
       base < a.lanes; base += step) {
    const int64_t i = base + lane;
    int32_t cur = kNull;
    long long p = 0;
    int32_t r = 0;
    if (i < a.lanes) {
      cur = a.starts[i];
      p = a.posn[i];
      r = max(a.rem[i], 0);
    }
    while (__any_sync(kFull, r > 0)) {
      const int32_t len = min(r, kChunk);
      for (int32_t t = 0; t < len; ++t) {
        mine[t] = cur;
        if (t + 1 < r)
          cur = follow<kLayout>(a.nxt, cur, a.n, a.pack, gaps.v);
      }
      __syncwarp();
      // the warp's staged runs, run-major: consecutive threads store
      // consecutive positions of one run
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int idx = j * 32 + (int)lane;
        const int run = idx / kChunk;
        const int t = idx % kChunk;
        const int32_t run_len = __shfl_sync(kFull, len, run);
        const long long run_pos = __shfl_sync(kFull, p, run);
        if (t < run_len)
          __stcs(a.out + run_pos + t,
                 (long long)warp_stage[run * (kChunk + 1) + t]);
      }
      __syncwarp();
      p += len;
      r -= len;
    }
  }
}

// Device words of a walk's length reduction; zero between launches (the
// last block of each launch re-arms them).
struct WalkScratch {
  int max;
  unsigned done;
};

template <typename Id, int kLayout>
__global__ void gather_next_kernel(const int32_t* __restrict__ nxt,
                                   const Id* __restrict__ ids,
                                   int32_t* __restrict__ out, int64_t n,
                                   int64_t lanes, int hops, WalkScratch* walk,
                                   int* len_host, const Packing pack,
                                   const __grid_constant__ Offsets<kLayout>
                                       gaps) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int best = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += stride) {
    int64_t cur = (int64_t)ids[i];
    int t = 0;
    for (; t < hops && cur >= 0 && cur < n; ++t) {
      const int64_t pc = at<kLayout>(pack, (int32_t)cur, gaps.v);
      if (kLayout == kPackedGapped && pc < 0) break;  // past its span
      const int32_t v = __ldg(nxt + pc);
      out[(int64_t)t * lanes + i] = v;
      cur = v;
    }
    // leading ids of (ids[i], out[0][i], ...) that address a row: t, plus
    // the last column when the lane was still live after `hops` hops
    const bool live =
        cur >= 0 && cur < n &&
        (kLayout != kPackedGapped ||
         at<kLayout>(pack, (int32_t)cur, gaps.v) >= 0);
    const int len = t + live;
    for (; t < hops; ++t) out[(int64_t)t * lanes + i] = kNull;
    best = max(best, len);
  }
  if (walk == nullptr) return;
  __shared__ int warp_max[32];
  best = __reduce_max_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) best = max(best, warp_max[w]);
  if (best > 0) atomicMax(&walk->max, best);
  __threadfence();  // this block's max lands before its ticket
  if (atomicAdd(&walk->done, 1u) == gridDim.x - 1) {
    *len_host = atomicExch(&walk->max, 0);
    atomicExch(&walk->done, 0u);
    __threadfence_system();
  }
}

// The kernel parameter of a launch's offsets: the host's N + 1 offsets for
// the gapped layout (checked by make_packing), one zero word otherwise.
template <int kLayout>
Offsets<kLayout> offsets_of(const Packing& p, const int64_t* host) {
  Offsets<kLayout> o = {};
  if constexpr (kLayout == kPackedGapped) {
    for (uint32_t s = 0; s <= p.n_shards; ++s) o.v[s] = (uint32_t)host[s];
  }
  return o;
}

unsigned grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t resident = (int64_t)sm_count() * 16;  // 16 blocks per SM
  if (resident > 0 && blocks > resident) blocks = resident;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

template <bool kTable, bool kPow2, int kLayout>
int launch_walk(const WalkArgs& a, const int64_t* offsets,
                cudaStream_t stream) {
  static LaunchShape cache[kMaxDevices] = {};
  LaunchShape shape;
  const cudaError_t err = launch_shape(
      walk_segments_kernel<kTable, kPow2, kLayout>, 0, cache, &shape);
  if (err != cudaSuccess) return (int)err;
  walk_segments_kernel<kTable, kPow2, kLayout>
      <<<blocks_for(shape, a.lanes), shape.block, 0, stream>>>(
          a, offsets_of<kLayout>(a.pack, offsets));
  return (int)cudaGetLastError();
}

template <int kLayout>
int launch_walk_spine(const WalkArgs& a, const int64_t* offsets,
                      cudaStream_t stream) {
  if (a.spine_pos != nullptr)
    return launch_walk<true, false, kLayout>(a, offsets, stream);
  if ((a.k & (a.k - 1)) == 0)
    return launch_walk<false, true, kLayout>(a, offsets, stream);
  return launch_walk<false, false, kLayout>(a, offsets, stream);
}

template <int kChunk, int kLayout>
int launch_expand(const ExpandArgs& a, const int64_t* offsets,
                  cudaStream_t stream) {
  static LaunchShape cache[kMaxDevices] = {};
  constexpr int kStageBytes = (kChunk + 1) * 4;  // per thread
  LaunchShape shape;
  const cudaError_t err = launch_shape(expand_segments_kernel<kChunk, kLayout>,
                                       kStageBytes, cache, &shape);
  if (err != cudaSuccess) return (int)err;
  expand_segments_kernel<kChunk, kLayout>
      <<<blocks_for(shape, a.lanes), shape.block,
         (size_t)shape.block * kStageBytes, stream>>>(
          a, offsets_of<kLayout>(a.pack, offsets));
  return (int)cudaGetLastError();
}

template <int kLayout>
int launch_expand_chunk(const ExpandArgs& a, int chunk,
                        const int64_t* offsets, cudaStream_t stream) {
  switch (chunk) {
    case 8:
      return launch_expand<8, kLayout>(a, offsets, stream);
    case 16:
      return launch_expand<16, kLayout>(a, offsets, stream);
    case 32:
      return launch_expand<32, kLayout>(a, offsets, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of jump_double_kernel<kKeep, kCnt, kLayout> that fit on the device
// at once, the most a cooperative launch may have; queried once per device.
template <bool kKeep, bool kCnt, int kLayout>
cudaError_t cooperative_blocks(int* blocks) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, jump_double_kernel<kKeep, kCnt, kLayout>, kRoundThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sm_count();
  if (*blocks <= 0) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

template <bool kKeep, bool kCnt, int kLayout>
int launch_rounds(const JumpRounds& a, const int64_t* offsets,
                  cudaStream_t stream) {
  int most = 0;
  const cudaError_t err = cooperative_blocks<kKeep, kCnt, kLayout>(&most);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (a.n + kRoundThreads - 1) / kRoundThreads;
  if (blocks > most) blocks = most;
  Offsets<kLayout> gaps = offsets_of<kLayout>(a.pack, offsets);
  void* args[] = {const_cast<JumpRounds*>(&a), &gaps};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)jump_double_kernel<kKeep, kCnt, kLayout>,
      dim3((unsigned)blocks),
      dim3(kRoundThreads), args, 0, stream);
}

template <int kLayout>
int launch_rounds_for(const JumpRounds& a, bool keep, bool counts,
                      const int64_t* offsets, cudaStream_t s) {
  if (keep) {
    return counts ? launch_rounds<true, true, kLayout>(a, offsets, s)
                  : launch_rounds<true, false, kLayout>(a, offsets, s);
  }
  return counts ? launch_rounds<false, true, kLayout>(a, offsets, s)
                : launch_rounds<false, false, kLayout>(a, offsets, s);
}

uint32_t log2_exact(uint32_t x) {  // log2(x) for a power of two, else 32
  if (x == 0 || (x & (x - 1)) != 0) return 32;
  uint32_t k = 0;
  while ((1u << k) < x) ++k;
  return k;
}

// The packing of a launch over n rows from the C arguments: n_shards 0 is
// the global layout; otherwise n_shards >= 1, seg_rows >= 1, B * N and n
// below 2^31.  `offsets` (host memory, n_shards + 1 of them) is null for
// the router's partition of the n rows; otherwise they must be
// non-decreasing from 0 to at most n, for at most kMaxGappedShards shards,
// and the layout is kPackedGapped.
bool make_packing(int n_shards, int seg_rows, const int64_t* offsets,
                  int64_t n, Packing* p) {
  *p = Packing{};
  if (n_shards == 0) return offsets == nullptr;
  const uint64_t B = (uint64_t)seg_rows, N = (uint64_t)n_shards;
  if (n_shards < 1 || seg_rows < 1 || n < 0 || n >= (1ll << 31) ||
      B * N >= (1ull << 31))
    return false;
  p->seg_rows = (uint32_t)B;
  p->n_shards = (uint32_t)N;
  p->seg_shift = log2_exact((uint32_t)B);
  p->shard_shift = log2_exact((uint32_t)N);
  p->layout = p->seg_shift < 32 && p->shard_shift < 32 ? kPackedPow2
                                                       : kPackedAny;
  if (offsets != nullptr) {
    if (n_shards > kMaxGappedShards || offsets[0] != 0 || offsets[N] > n)
      return false;
    for (int s = 1; s <= n_shards; ++s)
      if (offsets[s] < offsets[s - 1]) return false;
    p->layout = kPackedGapped;
  }
  const uint64_t full = (uint64_t)n / (B * N);
  p->round_rows = (uint32_t)(full * B);
  p->tail = (uint32_t)((uint64_t)n - full * B * N);
  if (p->shard_shift == 32) {
    // seg * m / 2^32 floors to seg / N while seg * e < 2^32, e = m*N - 2^32
    const uint64_t m = ((1ull << 32) + N - 1) / N;
    const uint64_t e = m * N - (1ull << 32);
    const uint64_t max_seg = n > 0 ? (uint64_t)(n - 1) / B : 0;
    if (max_seg * e < (1ull << 32)) p->magic = (uint32_t)m;
  }
  return true;
}

}  // namespace

// Every entry point takes the packed layout last but for the stream:
// n_shards (0 for the global layout), seg_rows and the host offsets, null
// when they are the ("seg", seg_rows) router's partition of the n rows.
//
// jump_out: the returned jump, or with keep the (rounds + 1, n) table;
// jump_tmp and cnt_tmp: the second ping-pong buffers (null when rounds is 1
// or, for jump_tmp, with keep); cnt, cnt_out, cnt_tmp null without counts.
// A refused cooperative launch returns its error; nothing falls back.
extern "C" int jump_double_launch(const void* jump, const void* cnt,
                                  void* jump_out, void* jump_tmp,
                                  void* cnt_out, void* cnt_tmp, int64_t n,
                                  int rounds, int keep, int n_shards,
                                  int seg_rows, const int64_t* offsets,
                                  void* stream) {
  JumpRounds a;
  if (rounds < 1 || !make_packing(n_shards, seg_rows, offsets, n, &a.pack))
    return (int)cudaErrorInvalidValue;
  a.jump = static_cast<const int32_t*>(jump);
  a.cnt = static_cast<const int64_t*>(cnt);
  a.jbuf[0] = static_cast<int32_t*>(jump_out);
  a.jbuf[1] = static_cast<int32_t*>(jump_tmp);
  a.cbuf[0] = static_cast<int64_t*>(cnt_out);
  a.cbuf[1] = static_cast<int64_t*>(cnt_tmp);
  a.n = n;
  a.rounds = rounds;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool counts = cnt != nullptr;
  switch (a.pack.layout) {
    case kPackedPow2:
      return launch_rounds_for<kPackedPow2>(a, keep, counts, offsets, s);
    case kPackedAny:
      return launch_rounds_for<kPackedAny>(a, keep, counts, offsets, s);
    case kPackedGapped:
      return launch_rounds_for<kPackedGapped>(a, keep, counts, offsets, s);
    default:
      return launch_rounds_for<kGlobal>(a, keep, counts, offsets, s);
  }
}

// rec (3 * capacity int32) and total (one uint64, zeroed here) are null
// for a walk without checkpoints; stride is a power of two.
extern "C" int walk_segments_launch(const void* nxt, const void* starts,
                                    const void* spine_pos, void* cur_out,
                                    void* sp_out, void* w_out, void* rec,
                                    void* total, int64_t n, int64_t lanes,
                                    int64_t capacity, int k, int head,
                                    int n_mult, int promoted, int budget,
                                    int stride, int n_shards, int seg_rows,
                                    const int64_t* offsets, void* stream) {
  WalkArgs a;
  if (stride < 1 || (stride & (stride - 1)) != 0 || k < 1 ||
      (rec == nullptr) != (total == nullptr) ||
      !make_packing(n_shards, seg_rows, offsets, n, &a.pack))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  a.nxt = static_cast<const int32_t*>(nxt);
  a.starts = static_cast<const int32_t*>(starts);
  a.spine_pos = static_cast<const int32_t*>(spine_pos);
  a.cur_out = static_cast<int32_t*>(cur_out);
  a.sp_out = static_cast<int32_t*>(sp_out);
  a.w_out = static_cast<int32_t*>(w_out);
  a.rec = static_cast<int32_t*>(rec);
  a.total = static_cast<unsigned long long*>(total);
  a.n = n;
  a.lanes = lanes;
  a.capacity = capacity;
  a.k = k;
  a.head = head;
  a.n_mult = n_mult;
  a.budget = budget;
  a.stride = stride;
  a.promoted = promoted;
  a.shift = 0;
  while ((1 << a.shift) < k) ++a.shift;
  if (total != nullptr) {
    const cudaError_t err = cudaMemsetAsync(total, 0, 8, s);
    if (err != cudaSuccess) return (int)err;
  }
  switch (a.pack.layout) {
    case kPackedPow2:
      return launch_walk_spine<kPackedPow2>(a, offsets, s);
    case kPackedAny:
      return launch_walk_spine<kPackedAny>(a, offsets, s);
    case kPackedGapped:
      return launch_walk_spine<kPackedGapped>(a, offsets, s);
    default:
      return launch_walk_spine<kGlobal>(a, offsets, s);
  }
}

// chunk: ids a thread stages per round, 8, 16 or 32.
extern "C" int expand_segments_launch(const void* nxt, const void* starts,
                                      const void* posn, const void* rem,
                                      void* out, int64_t n, int64_t lanes,
                                      int chunk, int n_shards, int seg_rows,
                                      const int64_t* offsets, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ExpandArgs a;
  if (!make_packing(n_shards, seg_rows, offsets, n, &a.pack))
    return (int)cudaErrorInvalidValue;
  a.nxt = static_cast<const int32_t*>(nxt);
  a.starts = static_cast<const int32_t*>(starts);
  a.posn = static_cast<const int32_t*>(posn);
  a.rem = static_cast<const int32_t*>(rem);
  a.out = static_cast<long long*>(out);
  a.n = n;
  a.lanes = lanes;
  switch (a.pack.layout) {
    case kPackedPow2:
      return launch_expand_chunk<kPackedPow2>(a, chunk, offsets, s);
    case kPackedAny:
      return launch_expand_chunk<kPackedAny>(a, chunk, offsets, s);
    case kPackedGapped:
      return launch_expand_chunk<kPackedGapped>(a, chunk, offsets, s);
    default:
      return launch_expand_chunk<kGlobal>(a, chunk, offsets, s);
  }
}

// id_bytes: 8 for int64 ids, 4 for int32 ids.  out holds hops columns of
// `lanes`.  With walk (two zeroed device words, kept zero between launches
// on one stream) and len_host (mapped pinned host memory) the walk's length
// is stored at *len_host when the kernel ends; both null for no length.
namespace {

template <typename Id, int kLayout>
void launch_gather(const void* nxt, const void* ids, void* out, int64_t n,
                   int64_t lanes, int hops, WalkScratch* w, int* h,
                   const Packing& p, const int64_t* offsets, cudaStream_t s) {
  const int threads = 256;
  gather_next_kernel<Id, kLayout><<<grid_for(lanes, threads), threads, 0, s>>>(
      static_cast<const int32_t*>(nxt), static_cast<const Id*>(ids),
      static_cast<int32_t*>(out), n, lanes, hops, w, h, p,
      offsets_of<kLayout>(p, offsets));
}

template <typename Id>
void launch_gather_ids(const void* nxt, const void* ids, void* out, int64_t n,
                       int64_t lanes, int hops, WalkScratch* w, int* h,
                       const Packing& p, const int64_t* offsets,
                       cudaStream_t s) {
  switch (p.layout) {
    case kPackedPow2:
      return launch_gather<Id, kPackedPow2>(nxt, ids, out, n, lanes, hops, w,
                                            h, p, offsets, s);
    case kPackedAny:
      return launch_gather<Id, kPackedAny>(nxt, ids, out, n, lanes, hops, w,
                                           h, p, offsets, s);
    case kPackedGapped:
      return launch_gather<Id, kPackedGapped>(nxt, ids, out, n, lanes, hops,
                                              w, h, p, offsets, s);
    default:
      return launch_gather<Id, kGlobal>(nxt, ids, out, n, lanes, hops, w, h,
                                        p, offsets, s);
  }
}

}  // namespace

extern "C" int gather_next_launch(const void* nxt, const void* ids,
                                  int id_bytes, void* out, int64_t n,
                                  int64_t lanes, int hops, void* walk,
                                  void* len_host, int n_shards, int seg_rows,
                                  const int64_t* offsets, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Packing p;
  if (hops < 1 || (walk == nullptr) != (len_host == nullptr) ||
      !make_packing(n_shards, seg_rows, offsets, n, &p) ||
      (id_bytes != 8 && id_bytes != 4))
    return (int)cudaErrorInvalidValue;
  WalkScratch* w = static_cast<WalkScratch*>(walk);
  int* h = static_cast<int*>(len_host);
  if (id_bytes == 8)
    launch_gather_ids<int64_t>(nxt, ids, out, n, lanes, hops, w, h, p,
                               offsets, s);
  else
    launch_gather_ids<int32_t>(nxt, ids, out, n, lanes, hops, w, h, p,
                               offsets, s);
  return (int)cudaGetLastError();
}
