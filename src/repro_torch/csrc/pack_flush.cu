// pack_rows: gather the dirty rows of a volatile region into one staging
// buffer, the device half of every epoch drain.
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
cudaError_t launch(const void* src, const void* idx, void* out, int64_t n_src,
                   int64_t m, int64_t rowbytes, cudaStream_t stream) {
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
    case 16: return (int)launch<uint4>(src, idx, out, n_src, m, rowbytes, s);
    case 8: return (int)launch<uint2>(src, idx, out, n_src, m, rowbytes, s);
    case 4:
      return (int)launch<uint32_t>(src, idx, out, n_src, m, rowbytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
