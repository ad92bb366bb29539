// pack_rows: gather the dirty rows of up to 64 volatile regions into one
// staging buffer in one launch, the device half of every epoch drain.
// scatter_rows, its inverse, is at the end of this file.
//
// Replaces: src/repro/kernels/pack_flush.py:pack_rows (_gather_kernel), the
// Pallas kernel that steers one (1, bd) block per grid step through a
// scalar-prefetched row index, one region per call.
//
// Computes, for every region r of the launch:
//   out_r[i, :] = src_r[idx_r[i], :], a zero row where idx_r[i] is outside
//   [0, n_src_r) (the flush passes only valid rows; -1 is the padding
//   sentinel), with out_r at byte offset out_off_r of the staging buffer.
// Segments start 16-byte aligned; the 0-12 bytes between the end of one
// segment and the start of the next are written as zeros.  A single region
// (pack_rows) is the case G = 1.
//
// Bound on an H100: bytes.  Each region reads M_r rows and their M_r int32
// indices and writes M_r rows: sum_r (2 * M_r * rowbytes_r + 4 * M_r) at
// 3.35 TB/s.  There is no arithmetic to speak of.  A drain moves about
// 0.5-1 MB, 0.2-0.3 us at that rate, far below the fixed cost of a launch
// and the two dependent DRAM round trips (index, then row): so the design
// removes launches (one per drain, not one per region) and keeps every
// lane's loads in flight together.  The drain's own bound is the bus: the
// staging bytes must reach the host.  So the drain (core/writeset.py)
// hands the kernel a pinned host buffer as out (mapped into the card's
// address space under unified addressing), and the kernel's stores cross
// the bus directly: no device staging buffer and no separate download.
//
// Design:
// * Descriptors in the launch's parameter space: a __grid_constant__
//   struct of up to 64 region descriptors (48 B each, 3 KB of the 4 KB
//   parameter space), so no descriptor copy precedes the launch.
// * Region per block: the blocks of the grid are dealt to the regions in
//   order, ceil(M_r / (4 * R_r)) each (R_r rows per warp, below); a block
//   finds its region from the blocks' prefix (a scan of at most 64
//   constant loads, uniform across the block).  The chunk width (16, 8 or
//   4 bytes: the widest that divides the row) is then uniform within the
//   block: one switch, no divergence.
// * A warp owns R = clamp(128 / C, 1, 32) consecutive rows (C chunks per
//   row): 32 rows of 64 B or 8 B, 8 of 256 B, so every warp has about 128
//   chunks to move however wide the rows, and wide rows get as many warps
//   as narrow ones.  It loads its R indices with one coalesced load, and
//   each lane takes the index of the row it copies from the owner lane
//   with __shfl_sync.  Lane l copies chunks l, l + 32, ... of the warp's
//   R * C chunks, so neighbouring lanes read neighbouring 16-byte words of
//   a source row and write neighbouring words of the staging rows: 64 B
//   rows are 4 lanes per row, 8 rows per pass; 8 B rows one lane per row.
//   A pass is unrolled by 4, so all of a lane's source loads (up to 4;
//   rows wider than 2 KB take several passes) are in flight before its
//   first store.
// * No TMA: a drain is too small for it to pay.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroups = 64;
constexpr int kWarps = 4;                    // warps per block
constexpr int kWarpChunks = 128;             // chunks a warp aims to move
constexpr int kUnroll = kWarpChunks / 32;    // loads in flight per lane

// rows a warp owns: about kWarpChunks chunks, at most one per lane
__host__ __device__ inline int rows_per_warp(int rowbytes, int chunk) {
  const int per = kWarpChunks / (rowbytes / chunk);
  return per < 1 ? 1 : per > 32 ? 32 : per;
}

struct GroupDesc {
  const char* src;      // region's volatile rows
  int64_t n_src;        // rows of src
  int64_t out_off;      // byte offset of the segment in out (16-aligned)
  int64_t idx_off;      // first index of the region in idx
  int32_t m;            // rows to gather
  int32_t rowbytes;     // bytes per row, a multiple of 4
  int32_t chunk;        // 16, 8 or 4
  int32_t first_block;  // first block of the region
};

struct GroupParams {
  GroupDesc g[kMaxGroups];
  int32_t n_groups;
};

template <typename T>
__device__ __forceinline__ void gather_block(const GroupDesc& d,
                                             const int32_t* __restrict__ idx,
                                             char* __restrict__ out,
                                             int64_t row0, int rpw) {
  const int lane = threadIdx.x & 31;
  const int64_t wrow = row0 + (threadIdx.x >> 5) * rpw;  // warp's first row
  if (wrow >= d.m) return;                // whole warp: no shuffle partner
  const int64_t left = d.m - wrow;
  const int rows = left < rpw ? (int)left : rpw;
  const int32_t mine =
      lane < rows ? __ldg(idx + d.idx_off + wrow + lane) : -1;
  const int C = d.rowbytes / (int)sizeof(T);
  const int items = rows * C;
  const T* __restrict__ src = reinterpret_cast<const T*>(d.src);
  T* __restrict__ dst = reinterpret_cast<T*>(out + d.out_off) + wrow * C;
  for (int base = 0; base < items; base += 32 * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * 32 + lane;
      const int r = t / C;
      // every lane joins the shuffle; lanes past the tile discard it
      const int32_t s = __shfl_sync(0xffffffffu, mine, min(r, 31));
      v[u] = T{};
      if (t < items && s >= 0 && s < d.n_src)
        v[u] = __ldg(src + (int64_t)s * C + (t - r * C));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * 32 + lane;
      if (t < items) dst[t] = v[u];
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
pack_rows_grouped_kernel(const __grid_constant__ GroupParams p,
                         const int32_t* __restrict__ idx,
                         char* __restrict__ out) {
  int g = 0;
  while (g + 1 < p.n_groups && (int32_t)blockIdx.x >= p.g[g + 1].first_block)
    ++g;
  const GroupDesc& d = p.g[g];
  const int rpw = rows_per_warp(d.rowbytes, d.chunk);
  const int64_t row0 =
      (int64_t)((int32_t)blockIdx.x - d.first_block) * rpw * kWarps;
  switch (d.chunk) {
    case 16: gather_block<uint4>(d, idx, out, row0, rpw); break;
    case 8: gather_block<uint2>(d, idx, out, row0, rpw); break;
    default: gather_block<uint32_t>(d, idx, out, row0, rpw); break;
  }
  // the region's last block zeroes the pad up to the next 16-byte boundary
  if (threadIdx.x == 0 && row0 + rpw * kWarps >= d.m) {
    const int64_t end = d.out_off + (int64_t)d.m * d.rowbytes;
    for (int64_t b = end; b & 15; b += 4)
      *reinterpret_cast<uint32_t*>(out + b) = 0u;
  }
}

}  // namespace

// desc: (n_groups, 7) int64 on the host, one row per region:
//   src pointer, n_src, out byte offset, idx offset, m, rowbytes, chunk.
// Regions with m = 0 take no block.  The caller guarantees 16-byte-aligned
// segment offsets and chunk-aligned sources; rows of at most 256 MB (a
// warp counts its chunks in an int), m below 2**31, 1 <= n_groups <= 64.
extern "C" int pack_rows_grouped_launch(const int64_t* desc, int n_groups,
                                        const void* idx, void* out,
                                        void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  GroupParams p;
  p.n_groups = n_groups;
  int64_t blocks = 0;
  for (int i = 0; i < n_groups; ++i) {
    const int64_t* r = desc + 7 * i;
    GroupDesc& d = p.g[i];
    d.src = reinterpret_cast<const char*>(r[0]);
    d.n_src = r[1];
    d.out_off = r[2];
    d.idx_off = r[3];
    d.m = (int32_t)r[4];
    d.rowbytes = (int32_t)r[5];
    d.chunk = (int32_t)r[6];
    if (r[4] < 0 || r[4] > INT32_MAX || (r[6] != 16 && r[6] != 8 && r[6] != 4)
        || r[5] <= 0 || r[5] > (1 << 28) || r[5] % r[6] || (r[2] & 15))
      return (int)cudaErrorInvalidValue;
    d.first_block = (int32_t)blocks;
    const int64_t per_block = rows_per_warp(d.rowbytes, d.chunk) * kWarps;
    blocks += (r[4] + per_block - 1) / per_block;
  }
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  pack_rows_grouped_kernel<<<(unsigned)blocks, 32 * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t*>(idx), static_cast<char*>(out));
  return (int)cudaGetLastError();
}

// scatter_rows: dst[idx[i], :] = packed[i, :] for every i with
// 0 <= idx[i] < n_dst, in place; the restore-path inverse of pack_rows,
// used by the serving engine to seat a prefill group's cache rows.
//
// Replaces: src/repro/kernels/pack_flush.py:scatter_rows (_scatter_kernel),
// which builds an (N,) inverse map (dst row -> packed row or -1) in the
// wrapper and then writes every dst row block once, re-reading the rows it
// keeps.
//
// Bound on an H100: bytes.  Only the scattered rows move: M * rowbytes read
// and M * rowbytes written, plus the M indices, at 3.35 TB/s.  The rows the
// scatter does not touch are neither read nor written (the update is in
// place), where the TPU kernel rewrites all N.
//
// Design: two launches.  The first resolves duplicate indices into the
// (N,) int32 inverse map with atomicMax, so the LAST packed row naming a
// dst row wins, as the reference's sequential scatter keeps; the second
// copies each winning packed row in 16-byte chunks (8, 4, 2 or 1 bytes for
// rows whose width is not a multiple of 16), neighbouring threads on
// neighbouring chunks of one row, grid-stride over M * chunks.
namespace {

__global__ void scatter_winners_kernel(const int32_t* __restrict__ idx,
                                       int32_t* __restrict__ inv,
                                       int64_t n_dst, int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const int32_t r = idx[i];
    if (r >= 0 && r < n_dst) atomicMax(inv + r, (int32_t)i);
  }
}

template <typename T>
__global__ void scatter_rows_kernel(T* __restrict__ dst,
                                    const T* __restrict__ packed,
                                    const int32_t* __restrict__ idx,
                                    const int32_t* __restrict__ inv,
                                    int64_t n_dst, int64_t m,
                                    int64_t chunks) {
  const int64_t total = m * chunks;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t i = t / chunks;
    const int64_t c = t - i * chunks;
    const int32_t r = __ldg(idx + i);
    if (r < 0 || r >= n_dst || __ldg(inv + r) != (int32_t)i) continue;
    dst[(int64_t)r * chunks + c] = __ldg(packed + t);
  }
}

template <typename T>
cudaError_t launch_scatter(void* dst, const void* packed, const void* idx,
                           void* inv, int64_t n_dst, int64_t m,
                           int64_t rowbytes, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (m + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  scatter_winners_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(inv), n_dst,
      m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t chunks = rowbytes / (int64_t)sizeof(T);
  blocks = (m * chunks + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  scatter_rows_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<T*>(dst), static_cast<const T*>(packed),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(inv),
      n_dst, m, chunks);
  return cudaGetLastError();
}

}  // namespace

// inv: (n_dst,) int32 scratch filled with -1 by the caller.
extern "C" int scatter_rows_launch(void* dst, const void* packed,
                                   const void* idx, void* inv, int64_t n_dst,
                                   int64_t m, int64_t rowbytes,
                                   int chunk_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk_bytes) {
    case 16: return (int)launch_scatter<uint4>(dst, packed, idx, inv, n_dst,
                                                m, rowbytes, s);
    case 8: return (int)launch_scatter<uint2>(dst, packed, idx, inv, n_dst,
                                               m, rowbytes, s);
    case 4: return (int)launch_scatter<uint32_t>(dst, packed, idx, inv,
                                                  n_dst, m, rowbytes, s);
    case 2: return (int)launch_scatter<uint16_t>(dst, packed, idx, inv,
                                                  n_dst, m, rowbytes, s);
    case 1: return (int)launch_scatter<uint8_t>(dst, packed, idx, inv, n_dst,
                                                 m, rowbytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
