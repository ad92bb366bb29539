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
//   Replaces src/repro/kernels/chain_order.py:walk_segments (inner kern),
//   the fused local walk of contraction.  Per lane, up to `budget` hops
//   along nxt until a spine node (id % k == 0, or the promoted head, whose
//   spine index is n_mult; or a spine_pos table lookup when one is given)
//   or the chain end.  Returns the final id, the spine index it arrived at
//   (NULL if it did not) and the hops taken.
//   Bound: latency.  Each hop is a dependent 4 B load; the byte floor of
//   total hops * 32 B sectors / 3.35 TB/s is a lower bound the walk cannot
//   approach.  Design: one thread per lane, so the card keeps one load per
//   lane in flight and hides latency by the ~n/k lanes alone.
//
// expand_segments
//   Replaces src/repro/kernels/chain_order.py:expand_segments (inner kern).
//   Lane i walks rem[i] hops from starts[i] and writes each visited id at
//   out[posn[i] + t].  The Pallas kernel re-stores retired steps because its
//   grid steps share one output block; lanes here retire by leaving the
//   loop, and each output slot is written exactly once.
//   Bound: latency, as walk_segments; byte floor hops * 32 B plus the 8 B
//   output per position.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kNull = -1;
constexpr int kMaxDevices = 64;
constexpr int kRoundThreads = 1024;  // the fewest blocks meet at a barrier

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

__device__ __forceinline__ int32_t follow(const int32_t* __restrict__ nxt,
                                          int32_t cur, int64_t n) {
  if (cur < 0 || cur >= n) return kNull;
  const int32_t v = __ldg(nxt + cur);
  return (v >= 0 && v < n) ? v : kNull;
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

template <bool kInput, bool kKeep, bool kCnt>
__device__ __forceinline__ void jump_round(const JumpRounds& a,
                                           const int32_t* __restrict__ js,
                                           const int64_t* __restrict__ cs,
                                           int32_t* __restrict__ jd,
                                           int64_t* __restrict__ cd) {
  const int64_t n = a.n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t j = load<kInput>(js + i);
    if (kKeep && kInput) a.jbuf[0][i] = j;  // level 0: the input as given
    const bool live = j >= 0 && j < n;
    int32_t nj = kNull;
    if (live) {
      const int32_t v = load<kInput>(js + j);
      if (v >= 0 && v < n) nj = v;
    }
    jd[i] = nj;
    if (kCnt) cd[i] = load<kInput>(cs + i) + (live ? load<kInput>(cs + j) : 0);
  }
}

template <bool kKeep, bool kCnt>
__global__ void __launch_bounds__(kRoundThreads)
    jump_double_kernel(const JumpRounds a) {
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
  jump_round<true, kKeep, kCnt>(a, a.jump, a.cnt, level(1), counts(1));
  for (int s = 2; s <= r; ++s) {
    cg::this_grid().sync();
    jump_round<false, kKeep, kCnt>(a, level(s - 1), counts(s - 1), level(s),
                                   counts(s));
  }
}

__global__ void walk_segments_kernel(
    const int32_t* __restrict__ nxt, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ spine_pos, int32_t* __restrict__ cur_out,
    int32_t* __restrict__ sp_out, int32_t* __restrict__ w_out, int64_t n,
    int64_t lanes, int32_t k, int32_t head, int32_t n_mult, int promoted,
    int32_t budget) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += stride) {
    int32_t cur = starts[i];
    int32_t sp = kNull;
    int32_t w = 0;
    if (cur >= 0) {
      for (int32_t t = 0; t < budget; ++t) {
        cur = follow(nxt, cur, n);
        ++w;
        if (cur < 0) break;  // chain end
        int32_t s;
        if (spine_pos != nullptr) {
          s = __ldg(spine_pos + cur);
        } else {
          s = (cur % k == 0) ? cur / k : kNull;
          if (promoted && cur == head) s = n_mult;
        }
        if (s >= 0) {
          sp = s;
          break;
        }
      }
    }
    cur_out[i] = cur;
    sp_out[i] = sp;
    w_out[i] = w;
  }
}

__global__ void expand_segments_kernel(const int32_t* __restrict__ nxt,
                                       const int32_t* __restrict__ starts,
                                       const int32_t* __restrict__ posn,
                                       const int32_t* __restrict__ rem,
                                       int64_t* __restrict__ out, int64_t n,
                                       int64_t lanes) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += stride) {
    int32_t cur = starts[i];
    const int64_t p = posn[i];
    const int32_t r = rem[i];
    for (int32_t t = 0; t < r; ++t) {
      out[p + t] = cur;
      if (t + 1 < r) cur = follow(nxt, cur, n);
    }
  }
}

// Device words of a walk's length reduction; zero between launches (the
// last block of each launch re-arms them).
struct WalkScratch {
  int max;
  unsigned done;
};

template <typename Id>
__global__ void gather_next_kernel(const int32_t* __restrict__ nxt,
                                   const Id* __restrict__ ids,
                                   int32_t* __restrict__ out, int64_t n,
                                   int64_t lanes, int hops, WalkScratch* walk,
                                   int* len_host) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int best = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += stride) {
    int64_t cur = (int64_t)ids[i];
    int t = 0;
    for (; t < hops && cur >= 0 && cur < n; ++t) {
      const int32_t v = __ldg(nxt + cur);
      out[(int64_t)t * lanes + i] = v;
      cur = v;
    }
    // leading in-range ids of (ids[i], out[0][i], ...): t, plus the last
    // column when the lane was still live after `hops` hops
    const int len = t + (cur >= 0 && cur < n);
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

unsigned grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t resident = (int64_t)sm_count() * 16;  // 16 blocks per SM
  if (resident > 0 && blocks > resident) blocks = resident;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

// Blocks of jump_double_kernel<kKeep, kCnt> that fit on the device at once,
// the most a cooperative launch may have; queried once per device.
template <bool kKeep, bool kCnt>
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
      &per_sm, jump_double_kernel<kKeep, kCnt>, kRoundThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sm_count();
  if (*blocks <= 0) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

template <bool kKeep, bool kCnt>
int launch_rounds(const JumpRounds& a, cudaStream_t stream) {
  int most = 0;
  const cudaError_t err = cooperative_blocks<kKeep, kCnt>(&most);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (a.n + kRoundThreads - 1) / kRoundThreads;
  if (blocks > most) blocks = most;
  void* args[] = {const_cast<JumpRounds*>(&a)};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)jump_double_kernel<kKeep, kCnt>, dim3((unsigned)blocks),
      dim3(kRoundThreads), args, 0, stream);
}

}  // namespace

// jump_out: the returned jump, or with keep the (rounds + 1, n) table;
// jump_tmp and cnt_tmp: the second ping-pong buffers (null when rounds is 1
// or, for jump_tmp, with keep); cnt, cnt_out, cnt_tmp null without counts.
// A refused cooperative launch returns its error; nothing falls back.
extern "C" int jump_double_launch(const void* jump, const void* cnt,
                                  void* jump_out, void* jump_tmp,
                                  void* cnt_out, void* cnt_tmp, int64_t n,
                                  int rounds, int keep, void* stream) {
  if (rounds < 1) return (int)cudaErrorInvalidValue;
  JumpRounds a;
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
  if (keep) {
    return counts ? launch_rounds<true, true>(a, s)
                  : launch_rounds<true, false>(a, s);
  }
  return counts ? launch_rounds<false, true>(a, s)
                : launch_rounds<false, false>(a, s);
}

extern "C" int walk_segments_launch(const void* nxt, const void* starts,
                                    const void* spine_pos, void* cur_out,
                                    void* sp_out, void* w_out, int64_t n,
                                    int64_t lanes, int k, int head,
                                    int n_mult, int promoted, int budget,
                                    void* stream) {
  const int threads = 128;
  walk_segments_kernel<<<grid_for(lanes, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(spine_pos), static_cast<int32_t*>(cur_out),
      static_cast<int32_t*>(sp_out), static_cast<int32_t*>(w_out), n, lanes,
      k, head, n_mult, promoted, budget);
  return (int)cudaGetLastError();
}

extern "C" int expand_segments_launch(const void* nxt, const void* starts,
                                      const void* posn, const void* rem,
                                      void* out, int64_t n, int64_t lanes,
                                      void* stream) {
  const int threads = 128;
  expand_segments_kernel<<<grid_for(lanes, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(posn), static_cast<const int32_t*>(rem),
      static_cast<int64_t*>(out), n, lanes);
  return (int)cudaGetLastError();
}

// id_bytes: 8 for int64 ids, 4 for int32 ids.  out holds hops columns of
// `lanes`.  With walk (two zeroed device words, kept zero between launches
// on one stream) and len_host (mapped pinned host memory) the walk's length
// is stored at *len_host when the kernel ends; both null for no length.
extern "C" int gather_next_launch(const void* nxt, const void* ids,
                                  int id_bytes, void* out, int64_t n,
                                  int64_t lanes, int hops, void* walk,
                                  void* len_host, void* stream) {
  const int threads = 256;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hops < 1 || (walk == nullptr) != (len_host == nullptr))
    return (int)cudaErrorInvalidValue;
  WalkScratch* w = static_cast<WalkScratch*>(walk);
  int* h = static_cast<int*>(len_host);
  if (id_bytes == 8) {
    gather_next_kernel<int64_t><<<grid_for(lanes, threads), threads, 0, s>>>(
        static_cast<const int32_t*>(nxt), static_cast<const int64_t*>(ids),
        static_cast<int32_t*>(out), n, lanes, hops, w, h);
  } else if (id_bytes == 4) {
    gather_next_kernel<int32_t><<<grid_for(lanes, threads), threads, 0, s>>>(
        static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(ids),
        static_cast<int32_t*>(out), n, lanes, hops, w, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
