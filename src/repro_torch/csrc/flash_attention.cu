// flash_attention: online-softmax attention over (heads, Sq, D) with the
// K/V of each query head read from its KV head (grouped-query attention).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel), the Pallas kernel whose grid (H, Sq/bq, Skv/bk) keeps the
// running max m, sum l and accumulator acc of one q block in VMEM scratch
// across the KV axis, relying on the TPU's sequential minor-axis order.
//
// Computes, for query head h and KV head h / group:
//   s = (q * scale) . k^T in f32, masked where kpos > qpos (causal) or where
//   kpos >= Skv (the ragged tile edge); m_new = max(m, rowmax s);
//   p = exp(s - m_new) where s > 0.5 * NEG_INF, else 0;
//   l = l * exp(m - m_new) + rowsum p; acc = acc * exp(m - m_new) + p . v;
//   out = acc / max(l, 1e-30), in q's dtype.
// With group == 1 this is exactly the TPU kernel's function.
//
// Bound on an H100: operations.  4 * H * Sq * Skv * D flops (halved when
// causal) against the f32 rate (67 TFLOP/s, no tensor cores) for f32 inputs
// and 989 TFLOP/s for bf16; the bytes (q, k, v, o once) are far below.
//
// Design: one block of 128 threads owns a 64-row q tile and loops over the
// KV tiles of 32 keys that its rows can see (the causal prefix only), so
// m, l and acc never leave the block: acc (64 x D) lives in registers, 8
// rows x D/16 columns per thread.  Q (pre-scaled, f32), the K tile, the V
// tile and the probability tile sit in shared memory as f32 (bf16 inputs
// are widened on load).  The 16 threads that share a row group are one
// half-warp, so the row max and row sum are half-warp shuffles and the P
// tile needs only __syncwarp.  K rows are padded to D + 1 floats so the 16
// threads of a half-warp read 16 banks.  Scalar FMA in f32: no wgmma, no
// TMA, no tensor cores; those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float x, float* p) { *p = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
                 int group, int causal, float scale) {
  constexpr int CW = D / 16;            // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                     // BQ x (D + 1), scaled q
  float* ks = qs + BQ * (D + 1);        // BK x (D + 1)
  float* vs = ks + BK * (D + 1);        // BK x D
  float* ps = vs + BK * D;              // BQ x (BK + 1), probabilities

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;              // rows rg*8 .. rg*8+7
  const int cg = tid & 15;              // key cg + 16j, out column cg + 16c
  const T* qh = q + (int64_t)h * sq * D;
  const T* kh = k + (int64_t)(h / group) * skv * D;
  const T* vh = v + (int64_t)(h / group) * skv * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int qr = q0 + r;
    qs[r * (D + 1) + c] =
        qr < sq ? widen(qh[(int64_t)qr * D + c]) * scale : 0.f;
  }

  float m[8], l[8], acc[8][CW];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // Q visible; the previous tile's K, V, P reads done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const int kr = k0 + r;
      const bool in = kr < skv;
      ks[r * (D + 1) + c] = in ? widen(kh[(int64_t)kr * D + c]) : 0.f;
      vs[r * D + c] = in ? widen(vh[(int64_t)kr * D + c]) : 0.f;
    }
    __syncthreads();

    float s[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0v = ks[cg * (D + 1) + d];
      const float k1v = ks[(cg + 16) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float qv = qs[(rg * 8 + i) * (D + 1) + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qp = q0 + rg * 8 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + cg + 16 * j;
        if (kp >= skv || (causal && kp > qp)) s[i][j] = NEG_INF;
      }
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p0 = s[i][0] > 0.5f * NEG_INF ? expf(s[i][0] - m_new) : 0.f;
      const float p1 = s[i][1] > 0.5f * NEG_INF ? expf(s[i][1] - m_new) : 0.f;
      float rs = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
      ps[(rg * 8 + i) * (BK + 1) + cg] = p0;
      ps[(rg * 8 + i) * (BK + 1) + cg + 16] = p1;
    }
    __syncwarp();  // a row group's P is written and read by one half-warp

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float vv[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) vv[c] = vs[j * D + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = ps[(rg * 8 + i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  T* oh = o + (int64_t)h * sq * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qr = q0 + rg * 8 + i;
    if (qr >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CW; ++c)
      narrow(acc[i][c] / denom, oh + (int64_t)qr * D + cg + 16 * c);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t h, int64_t sq, int64_t skv, int group, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)h);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)sq, (int)skv, group,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, int64_t h, int64_t sq, int64_t skv, int group,
                     int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, h, sq, skv, group, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, h, sq, skv, group, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, h, sq, skv, group, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, h, sq, skv, group, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (h, sq, d); k, v: (h / group, skv, d); all contiguous, one dtype
// (f32 when is_bf16 == 0, bf16 otherwise).  Returns the CUDA error code.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t h,
                                      int64_t sq, int64_t skv, int d,
                                      int group, int causal, float scale,
                                      int is_bf16, void* stream) {
  if (h <= 0 || sq <= 0 || h > 65535 || group <= 0 || h % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? (int)dispatch<__nv_bfloat16>(d, q, k, v, o, h, sq, skv,
                                                group, causal, scale, s)
                 : (int)dispatch<float>(d, q, k, v, o, h, sq, skv, group,
                                        causal, scale, s);
}
