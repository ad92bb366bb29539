// probe: batched first-match search of a bucketed hash table, the device
// half of ops.hash_lookup (batched session lookups, embedding dedup).
//
// Replaces: src/repro/kernels/hash_probe.py:probe (_probe_kernel,
// pallas_call at :55), the Pallas kernel whose scalar-prefetched bucket ids
// steer a (1, 128) block of the key table per grid step and compare it in
// one vector op.  The reference hashes outside its kernel
// (repro/kernels/ops.py hash_lookup); here the hashed form computes
// hash32(q) % n_buckets inside the kernel.
//
// Computes: out[i] = b * 128 + j for the first lane j with keys[b, j] ==
// q[i], else -1, as int32, where b is bid[i] (probe) or hash32(q[i]) %
// n_buckets in uint32 arithmetic (the hashed form, bid == null).  A bucket
// id outside [0, n_buckets) is a caller error: the kernel answers -1 for it
// and reads nothing outside the table.
//
// Bound on an H100: bytes.  Bytes once: each DISTINCT bucket row read once
// (128 int32 = 512 contiguous bytes), each query and bucket id read once
// and each answer written once.  A kernel that reads one row per query
// instead pays the sector bound, Q * 512 B: at 2**22 uniform queries over
// 2**20 buckets about four queries share a row, and the table (512 MiB) is
// ten times the 50 MB L2, so that reading is 4.1 times the bytes-once
// one.  The compares are one instruction per word and bound nothing.
//
// Grouped design (probe_grouped_kernel): one cooperative launch, five
// stages separated by cooperative_groups' grid.sync() (all blocks
// resident: the grid is occupancy x SMs, queried once per device), after
// the counts are zeroed:
//   1. count: each query's bucket (hashed here, or its bid read), an
//      out-of-range id answered -1 at once and left out; lanes of a warp
//      that share a bucket (__match_any_sync) take one atomicAdd on its
//      count and their ranks from it, so a hot bucket costs one atomic per
//      warp, not per query.  The rank is stored (4 B, coalesced).
//   2. scan: each block scans its slice of the counts (a power of two of
//      buckets) into offsets within the slice and writes its total.
//   3. scatter: each block scans the few hundred totals in shared memory,
//      then writes each query's key to its position, its bucket's offset +
//      its rank, so the keys come out grouped by bucket (the order inside a
//      bucket is the atomics', which the answers do not depend on), and
//      keeps the position in place of the rank.  The key is the query
//      alone in the hashed form (the bucket is hashed again where needed),
//      the query and its bucket (8 B) in the other.
//   4. probe: a warp takes a window of 32 consecutive keys; while some are
//      unanswered it reads the row of the first one's bucket in one
//      coalesced 512 B request (int4 per lane) and answers every key of
//      that bucket in the window from the registers: a broadcast of the
//      query, 4 compares a lane, __ballot_sync, __ffs and a shuffle.  The
//      window's 32 answers are stored in key order, one 128 B store.  A row
//      is read once, plus once more for each window boundary that splits
//      its bucket (at most one extra per window); windows go to the warps
//      in order, so the rows stream through the table.  A hot bucket spans
//      many windows, each reading its row from the L2, so skew does not
//      serialise one warp.
//   5. gather: out[i] = answers[position of query i], coalesced in i.
// Why keys of 4-8 B and answers in key order, not one 16 B record {query,
// index, bucket} per query and a store to out[index] from the probe: on an
// H100 (chip_smoke.py phase 2) that form spent 0.29 ms scattering 64 MB of
// records (more than the L2 holds, each 16 B store alone in its sector)
// and 0.40 ms in the probe stage, whose 4 B stores to out land one to a
// sector; the keys (16 MB in the hashed form) stay in the L2 while they
// are scattered, and the answers' one random access per query is a read
// in the gather.  Streaming loads and stores (ld/st .cs) mark the arrays
// read or written once, so they leave the L2 first.
// Data written by another block earlier in the launch is read through the
// L2 (__ldcg), never the non-coherent path; a thread's own position, the
// queries and the ids are read with streaming loads, the table with
// __ldg.  The scratch (keys, answers, positions, counts, block
// totals) comes from the caller and nothing outlives the call.  With a
// stamp buffer, block 0 writes %globaltimer at the start and after each
// barrier (and a last barrier is added), so a caller can price each stage.
//
// Query-major design (probe_kernel): one warp per query reads its row with
// one int4 per lane and answers it the same way.  Rows shared by queries
// are read again (the sector bound), but it needs no scratch and no grid
// barriers, so small batches, where few queries share a row, take it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BUCKET = 128;
constexpr int WARPS_PER_BLOCK = 8;  // query-major kernel
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;       // grouped kernel: threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;       // 2048 threads an SM: rows in flight
constexpr int kMaxGrid = 2048;      // block totals scanned in shared memory
constexpr int kMaxDevices = 64;

// The reference's uint32 xorshift-multiply hash (repro/kernels/ops.py).
__device__ __forceinline__ uint32_t hash32(uint32_t u) {
  u = (u ^ (u >> 16)) * 0x7FEB352Du;
  u = (u ^ (u >> 15)) * 0x846CA68Bu;
  return u ^ (u >> 16);
}

// Query q's bucket: hashed (n_buckets > 0, checked by the host), or the
// caller's id, which may lie outside the table.  The ids are read once: a
// streaming load (.cs), which leaves the L2 first.
template <bool kHashed>
__device__ __forceinline__ int64_t bucket_of(const int32_t* __restrict__ bids,
                                             int32_t q, int64_t i,
                                             uint32_t n_buckets) {
  if (kHashed) return (int64_t)(hash32((uint32_t)q) % n_buckets);
  return (int64_t)__ldcs(bids + i);
}

// Lane of the first word of `row` (4 words a lane) equal to q: the answer
// of one query, uniform across the warp.
__device__ __forceinline__ int32_t first_match(const int4& row, int32_t q,
                                               int32_t b) {
  const int j = row.x == q ? 0 : row.y == q ? 1 : row.z == q ? 2
              : row.w == q ? 3 : 4;
  const unsigned hit = __ballot_sync(kFull, j < 4);
  const int first = hit ? __ffs(hit) - 1 : 0;
  const int jf = __shfl_sync(kFull, j, first);
  return hit ? b * BUCKET + first * 4 + jf : -1;
}

template <bool kHashed>
__global__ void probe_kernel(const int4* __restrict__ table,
                             const int32_t* __restrict__ queries,
                             const int32_t* __restrict__ bids,
                             int32_t* __restrict__ out, int64_t n_buckets,
                             int64_t n_queries) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // the query
  if (i >= n_queries) return;  // uniform across the warp
  const int32_t q = __ldg(queries + i);
  const int64_t b = bucket_of<kHashed>(bids, q, i, (uint32_t)n_buckets);
  if (b < 0 || b >= n_buckets) {  // uniform across the warp
    if (lane == 0) out[i] = -1;
    return;
  }
  const int4 row = __ldg(table + b * (BUCKET / 4) + lane);
  const int32_t ans = first_match(row, q, (int32_t)b);
  if (lane == 0) out[i] = ans;
}

// Buffers and sizes of one grouped launch.
struct Grouped {
  const int4* table;
  const int32_t* queries;
  const int32_t* bids;  // null in the hashed form
  int32_t* out;
  void* keys;           // (n_queries,) in bucket order: int32 q, or int2 (q, b)
  int32_t* answers;     // (n_queries,) in key order
  int32_t* pos;         // (n_queries,) rank in the bucket, then key position;
                        // -1 for an id outside the table
  int32_t* offsets;     // (n_buckets,) counts, then offsets in the slice
  int32_t* totals;      // (grid,) each block's slice total
  long long* stamps;    // null, or 7 %globaltimer readings: the start,
                        // after each barrier, the end
  int64_t n_queries;
  uint32_t n_buckets;
  int slice_shift;      // block k scans buckets [k << shift, (k+1) << shift)
};

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stamp(const Grouped& a, int k) {
  if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.stamps[k] = globaltimer();
}

// Exclusive scan of one value per thread across the block; *total gets the
// block's sum.  Every thread of the block calls it.
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* warp_sum,
                                              int32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sum[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  const int32_t before = (warp ? warp_sum[warp - 1] : 0) + x - v;
  *total = warp_sum[kWarps - 1];
  __syncthreads();  // warp_sum is written again by the next call
  return before;
}

template <bool kHashed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    probe_grouped_kernel(const Grouped a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int32_t base[kMaxGrid + 1];  // each block's first key
  __shared__ int32_t warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nq = a.n_queries;
  const int64_t nb = a.n_buckets;

  stamp(a, 0);
  for (int64_t b = tid; b < nb; b += threads) a.offsets[b] = 0;
  grid.sync();
  stamp(a, 1);

  // 1. count: ranks from one atomic per bucket per warp
  for (int64_t i = tid; i - lane < nq; i += threads) {  // uniform per warp
    const bool live = i < nq;
    int32_t key = -1;
    if (live) {
      const int64_t b =
          bucket_of<kHashed>(a.bids, __ldcs(a.queries + i), i, a.n_buckets);
      if (b >= 0 && b < nb)
        key = (int32_t)b;
      else
        __stcs(a.out + i, -1);
    }
    const unsigned peers = __match_any_sync(kFull, key);
    const int leader = __ffs(peers) - 1;
    int32_t first = 0;
    if (key >= 0 && lane == leader)
      first = atomicAdd(a.offsets + key, __popc(peers));
    first = __shfl_sync(kFull, first, leader);
    if (live)
      __stcs(a.pos + i,
             key >= 0 ? first + __popc(peers & ((1u << lane) - 1u)) : -1);
  }
  grid.sync();
  stamp(a, 2);

  // 2. scan: each block its slice of the counts, in place
  {
    const int64_t lo = (int64_t)blockIdx.x << a.slice_shift;
    const int64_t end = lo + ((int64_t)1 << a.slice_shift);
    const int64_t hi = end < nb ? end : nb;
    int32_t running = 0;
    for (int64_t c = lo; c < hi; c += kThreads) {  // uniform per block
      const int64_t b = c + threadIdx.x;
      const int32_t v = b < hi ? __ldcg(a.offsets + b) : 0;
      int32_t sum;
      const int32_t before = block_scan(v, warp_sum, &sum);
      if (b < hi) a.offsets[b] = running + before;
      running += sum;
    }
    if (threadIdx.x == 0) a.totals[blockIdx.x] = running;
  }
  grid.sync();
  stamp(a, 3);

  // 3. scatter: the block totals scanned here, then every key placed
  {
    int32_t running = 0;
    for (int c = 0; c < (int)gridDim.x; c += kThreads) {  // uniform
      const int k = c + threadIdx.x;
      const int32_t v = k < (int)gridDim.x ? __ldcg(a.totals + k) : 0;
      int32_t sum;
      const int32_t before = block_scan(v, warp_sum, &sum);
      if (k < (int)gridDim.x) base[k] = running + before;
      running += sum;
    }
    if (threadIdx.x == 0) base[gridDim.x] = running;
    __syncthreads();
  }
  for (int64_t i = tid; i < nq; i += threads) {
    const int32_t r = __ldcs(a.pos + i);
    if (r < 0) continue;
    const int32_t q = __ldcs(a.queries + i);
    const int32_t b = (int32_t)bucket_of<kHashed>(a.bids, q, i, a.n_buckets);
    const int32_t p = base[b >> a.slice_shift] + __ldcg(a.offsets + b) + r;
    if (kHashed)
      static_cast<int32_t*>(a.keys)[p] = q;
    else
      static_cast<int2*>(a.keys)[p] = make_int2(q, b);
    __stcs(a.pos + i, p);
  }
  grid.sync();
  stamp(a, 4);

  // 4. probe: windows of 32 keys, one row read per bucket in a window
  const int64_t n_valid = base[gridDim.x];
  const int64_t windows = (n_valid + 31) >> 5;
  for (int64_t w = tid >> 5; w < windows; w += threads >> 5) {
    const int64_t p = (w << 5) + lane;
    int32_t q = 0, b = -1;  // b = -1: no key in this lane
    if (p < n_valid) {
      if (kHashed) {
        q = __ldcg(static_cast<const int32_t*>(a.keys) + p);
        b = (int32_t)(hash32((uint32_t)q) % a.n_buckets);
      } else {
        const int2 k = __ldcg(static_cast<const int2*>(a.keys) + p);
        q = k.x;
        b = k.y;
      }
    }
    int32_t mine = -1;
    unsigned pending = __ballot_sync(kFull, b >= 0);
    while (pending) {
      const int32_t bb = __shfl_sync(kFull, b, __ffs(pending) - 1);
      const unsigned group = __ballot_sync(kFull, b == bb) & pending;
      const int4 row = __ldg(a.table + (int64_t)bb * (BUCKET / 4) + lane);
      for (unsigned g = group; g; g &= g - 1) {
        const int r = __ffs(g) - 1;
        const int32_t ans = first_match(row, __shfl_sync(kFull, q, r), bb);
        if (lane == r) mine = ans;
      }
      pending &= ~group;
    }
    if (p < n_valid) a.answers[p] = mine;
  }
  grid.sync();
  stamp(a, 5);

  // 5. gather: each answer back to its query
  for (int64_t i = tid; i < nq; i += threads) {
    const int32_t p = __ldcs(a.pos + i);
    if (p >= 0) __stcs(a.out + i, __ldcg(a.answers + p));
  }
  if (a.stamps != nullptr) {  // uniform: the last stage's end
    grid.sync();
    stamp(a, 6);
  }
}

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

// Blocks of probe_grouped_kernel<kHashed> that fit on the device at once,
// the most a cooperative launch may have (and at most kMaxGrid); queried
// once per device.
template <bool kHashed>
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
      &per_sm, probe_grouped_kernel<kHashed>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sm_count();
  if (*blocks > kMaxGrid) *blocks = kMaxGrid;
  if (*blocks <= 0) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

template <bool kHashed>
int launch_grouped(Grouped& a, char* scratch, cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = cooperative_blocks<kHashed>(&blocks);
  if (err != cudaSuccess) return (int)err;
  int shift = 0;
  while (((int64_t)blocks << shift) < (int64_t)a.n_buckets) ++shift;
  a.slice_shift = shift;
  a.keys = scratch;  // int2 in the bid form: 8 B a query either way
  a.answers = reinterpret_cast<int32_t*>(scratch + 8 * a.n_queries);
  a.pos = a.answers + a.n_queries;
  a.offsets = a.pos + a.n_queries;
  a.totals = a.offsets + a.n_buckets;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)probe_grouped_kernel<kHashed>, dim3((unsigned)blocks),
      dim3(kThreads), args, 0, stream);
}

}  // namespace

// table: (n_buckets, 128) int32, 16-byte aligned; queries, out: (n,) int32;
// bids: (n,) int32, or null to hash each query in the kernel (then
// n_buckets > 0).  n_buckets <= 2**24, so every global slot id fits in
// int32.  Query-major: one warp per query.
extern "C" int probe_launch(const void* table, const void* queries,
                            const void* bids, void* out, int64_t n_buckets,
                            int64_t n_queries, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (bids == nullptr && n_buckets <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32 * WARPS_PER_BLOCK;
  const int64_t blocks = (n_queries + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* t = static_cast<const int4*>(table);
  const int32_t* q = static_cast<const int32_t*>(queries);
  const int32_t* b = static_cast<const int32_t*>(bids);
  int32_t* o = static_cast<int32_t*>(out);
  if (b == nullptr)
    probe_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(t, q, b, o,
                                                            n_buckets,
                                                            n_queries);
  else
    probe_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(t, q, b, o,
                                                             n_buckets,
                                                             n_queries);
  return (int)cudaGetLastError();
}

// The grouped form, one cooperative launch.  scratch: at least
// 16 * n_queries + 4 * (n_buckets + 2048) bytes, 16-byte aligned (keys,
// answers, positions, counts, block totals); stamps: null or 7 int64.  A
// refused cooperative launch returns its error; nothing falls back.
extern "C" int probe_grouped_launch(const void* table, const void* queries,
                                    const void* bids, void* out,
                                    void* scratch, int64_t scratch_bytes,
                                    void* stamps, int64_t n_buckets,
                                    int64_t n_queries, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  if (n_queries > 0x7fffffffLL || n_buckets < 0 ||
      n_buckets > (1LL << 24) || (bids == nullptr && n_buckets == 0))
    return (int)cudaErrorInvalidValue;
  if (scratch_bytes < 16 * n_queries + 4 * (n_buckets + kMaxGrid) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return (int)cudaErrorInvalidValue;
  Grouped a = {};
  a.table = static_cast<const int4*>(table);
  a.queries = static_cast<const int32_t*>(queries);
  a.bids = static_cast<const int32_t*>(bids);
  a.out = static_cast<int32_t*>(out);
  a.stamps = static_cast<long long*>(stamps);
  a.n_queries = n_queries;
  a.n_buckets = (uint32_t)n_buckets;
  char* s = static_cast<char*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bids == nullptr ? launch_grouped<true>(a, s, st)
                         : launch_grouped<false>(a, s, st);
}
