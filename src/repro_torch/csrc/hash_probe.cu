// probe: batched first-match search of a bucketed hash table, the device
// half of ops.hash_lookup (batched session lookups, embedding dedup).
//
// Replaces: src/repro/kernels/hash_probe.py:probe (_probe_kernel), the
// Pallas kernel whose scalar-prefetched bucket ids steer a (1, 128) block
// of the key table per grid step and compare it in one vector op.
//
// Computes: out[i] = bid[i] * 128 + j for the first lane j with
// keys[bid[i], j] == q[i], else -1, as int32.  A bucket id outside
// [0, n_buckets) is a caller error: the kernel answers -1 for it and reads
// nothing outside the table.
//
// Bound on an H100: bytes.  Each query must read its bucket's row, 128
// int32 = 512 contiguous bytes, plus its query and bucket id, and write one
// int32: Q * (512 + 12) B at 3.35 TB/s.  A row is 16 whole 32-byte sectors,
// so the sector bound is the same.  The compare is one instruction per
// word and bounds nothing.
//
// Design: one warp per query.  Lane l loads words 4l..4l+3 of the row as
// one 16-byte int4, so the warp reads the whole 512 B row in one coalesced
// request and every row is read once.  Each lane finds its first matching
// word; __ballot_sync and __ffs give the first lane with a match, and a
// shuffle brings that lane's word index to lane 0, which writes the
// result.  Each warp reads its own query and bucket id (one broadcast load
// each); nothing is prefetched.  Many warps per SM keep enough rows in
// flight to cover the memory latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BUCKET = 128;
constexpr int WARPS_PER_BLOCK = 8;

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
  const int32_t b = __ldg(bids + i);
  if (b < 0 || (int64_t)b >= n_buckets) {  // uniform across the warp
    if (lane == 0) out[i] = -1;
    return;
  }
  const int4 w = __ldg(table + (int64_t)b * (BUCKET / 4) + lane);
  const int j = w.x == q ? 0 : w.y == q ? 1 : w.z == q ? 2 : w.w == q ? 3 : 4;
  const unsigned hit = __ballot_sync(0xffffffffu, j < 4);
  const int first = hit ? __ffs(hit) - 1 : 0;
  const int jf = __shfl_sync(0xffffffffu, j, first);
  if (lane == 0) out[i] = hit ? b * BUCKET + first * 4 + jf : -1;
}

}  // namespace

// table: (n_buckets, 128) int32, 16-byte aligned; queries, bids, out: (n,)
// int32.  n_buckets <= 2**24, so every global slot id fits in int32.
extern "C" int probe_launch(const void* table, const void* queries,
                            const void* bids, void* out, int64_t n_buckets,
                            int64_t n_queries, void* stream) {
  if (n_queries <= 0) return (int)cudaSuccess;
  const int threads = 32 * WARPS_PER_BLOCK;
  const int64_t blocks = (n_queries + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  probe_kernel<<<(unsigned)blocks, threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), static_cast<const int32_t*>(queries),
      static_cast<const int32_t*>(bids), static_cast<int32_t*>(out),
      n_buckets, n_queries);
  return (int)cudaGetLastError();
}
