// pack_rows: gather the dirty rows of a volatile region into one staging
// buffer, the device half of every epoch drain.  scatter_rows, its inverse,
// is at the end of this file.
//
// Replaces: src/repro/kernels/pack_flush.py:pack_rows (_gather_kernel), the
// Pallas kernel that steers one (1, bd) block per grid step through a
// scalar-prefetched row index.
//
// Computes: out[i, :] = src[idx[i], :]; a zero row where idx[i] is outside
// [0, n_src) (the flush passes only valid rows; -1 is the padding sentinel).
//
// Bound on an H100: bytes.  The gather must read M rows and write M rows,
// plus the M int32 indices: (2 * M * rowbytes + 4 * M) / 3.35 TB/s.  There is
// no arithmetic to speak of.
//
// Design: one thread per 16-byte chunk of an output row (4, 8 or 16 threads
// for 64, 128 or 256 B rows), grid-stride over M * chunks, so neighbouring
// threads read neighbouring 16-byte words of one source row and write
// neighbouring words of the staging row: every warp issues full 128-byte
// transactions on both sides.  Rows whose width is a multiple of 8 or 4
// bytes but not of 16 fall back to 8- or 4-byte chunks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void pack_rows_kernel(const T* __restrict__ src,
                                 const int32_t* __restrict__ idx,
                                 T* __restrict__ out, int64_t n_src,
                                 int64_t m, int64_t chunks) {
  const int64_t total = m * chunks;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t i = t / chunks;
    const int64_t c = t - i * chunks;
    const int32_t r = __ldg(idx + i);
    T v{};
    if (r >= 0 && r < n_src) v = __ldg(src + (int64_t)r * chunks + c);
    out[t] = v;
  }
}

template <typename T>
cudaError_t launch_pack(const void* src, const void* idx, void* out,
                        int64_t n_src, int64_t m, int64_t rowbytes,
                        cudaStream_t stream) {
  const int64_t chunks = rowbytes / (int64_t)sizeof(T);
  const int64_t total = m * chunks;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident blocks per SM
  pack_rows_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const int32_t*>(idx),
      static_cast<T*>(out), n_src, m, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pack_rows_launch(const void* src, const void* idx, void* out,
                                int64_t n_src, int64_t m, int64_t rowbytes,
                                int chunk_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk_bytes) {
    case 16:
      return (int)launch_pack<uint4>(src, idx, out, n_src, m, rowbytes, s);
    case 8:
      return (int)launch_pack<uint2>(src, idx, out, n_src, m, rowbytes, s);
    case 4:
      return (int)launch_pack<uint32_t>(src, idx, out, n_src, m, rowbytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
