// flash_attention_bwd: the gradient of flash_attention (csrc/
// flash_attention.cu) with respect to q, k and v, for grouped-query
// attention, deterministic.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// its jnp blockwise_attention (src/repro/models/layers.py:200) and has no
// Pallas backward.  This is the function jax.grad of that layer computes,
// for query head h reading KV head h / group, causal (top-left, kpos <=
// qpos) or not.  Given q, o, dO: (H, Sq, D), k, v: (H / group, Skv, D) and
// the forward's lse: (H, Sq) f32 (ln sum exp of a row's scaled scores, +inf
// for a row with no visible key):
//   Di = rowsum(dO * o)
//   P  = exp(q.k^T * scale - lse), 0 where kpos >= Skv or (causal) kpos >
//        qpos: the forward's mask
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Di)
//   dK = scale * dS^T Q,  dQ = scale * dS K
// with every product and sum in f32, whatever the input type (f32 or
// bf16); the outputs are rounded to the input type.
//
// Bound on an H100: operations, 10 * H * Sq * Skv * D flops (about halved
// when causal) at 67 TFLOP/s f32 or 989 TFLOP/s bf16; the bytes are far
// below.
//
// Design: two launches, no float atomics, so two runs give the same bits
// (a resumed run's losses equal an uninterrupted one's only so).
//   dkdv: one block per (KV head, tile of 64 keys) holds K and V in shared
//         memory and dK, dV in registers, and walks, in a fixed order, the
//         group's query heads and, for each, the 64-row query tiles that
//         can see its keys (causal: from the tile of its first key on).
//   dq:   one block per (query head, tile of 64 rows) holds Q, dO and dQ
//         and walks the key tiles up to its diagonal (causal: the longest
//         rows first, as the forward does).
// Both recompute S and dP for a 64 x 64 tile in one pass over D (each
// thread 4 x 4 of each, rows ty + 16 i and keys tx + 16 j, float4 reads),
// then P and dS go through shared memory (rows padded to 65 floats) to the
// accumulating product, where 4 threads share a key (dkdv) or a row (dq),
// each owning every fourth float4 of D.  Di is a dot of dO and o per row
// (4 threads a row, two shuffles).  Tiles are widened to f32 on load
// (rows padded to D + 4 floats); rows past Sq and keys past Skv load as 0
// and are masked, so any Sq and Skv work.  This is a SIMT kernel, simple
// and right first: the tensor cores (wgmma on TMA tiles) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;          // query rows of a tile
constexpr int BN = 64;          // keys of a tile (== BM: a key tile's first
                                // query tile is the one of the same index)
constexpr int THREADS = 256;
constexpr int PS = BN + 1;      // row stride of the P and dS tiles

template <int D>
struct Shape {
  static constexpr int RS = D + 4;     // row stride of the q, dO, k, v tiles
  static constexpr int CH = D / 16;    // float4s of a row each thread owns
  static constexpr size_t SMEM =
      sizeof(float) * (2 * BM * RS + 2 * BN * RS + 2 * BM * PS + 2 * BM);
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// four consecutive elements of T as floats (16-byte or 8-byte aligned)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&a);
    w.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = w;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// rows [r0, r0 + 64) of a (n, D) matrix of T into a float tile of stride
// RS; rows at or past n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, int tid) {
  constexpr int C4 = D / 4;
  for (int i = tid; i < 64 * C4; i += THREADS) {
    const int r = i / C4, c = (i - r * C4) * 4;
    float4 x = zero4();
    if (r0 + r < n) x = load4<T>(src + (int64_t)(r0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * Shape<D>::RS + c) = x;
  }
}

// Di = rowsum(dO * o) of the tile's rows: row tid / 4, the four threads of
// a row summing every fourth float4 and then each other's sums
template <typename T, int D>
__device__ __forceinline__ void row_delta(float* di_s, const float* dos,
                                          const T* oh, int m0, int sq,
                                          int tid) {
  const int row = tid >> 2, part = tid & 3;
  float acc = 0.f;
  if (m0 + row < sq) {
#pragma unroll
    for (int c = 0; c < Shape<D>::CH; ++c) {
      const int col = 4 * (part + 4 * c);
      const float4 ov = load4<T>(oh + (int64_t)(m0 + row) * D + col);
      const float4 dv =
          *reinterpret_cast<const float4*>(dos + row * Shape<D>::RS + col);
      acc = dot4(ov, dv, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) di_s[row] = acc;
}

// S = Q K^T and dP = dO V^T for the thread's 4 x 4 of the 64 x 64 tile:
// rows ty + 16 i, keys tx + 16 j
template <int D>
__device__ __forceinline__ void scores(float (&s)[4][4], float (&dp)[4][4],
                                       const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       int tx, int ty) {
  constexpr int RS = Shape<D>::RS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[4], dv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * RS + d);
      dv[i] = *reinterpret_cast<const float4*>(dos + (ty + 16 * i) * RS + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * RS + d);
      vv[j] = *reinterpret_cast<const float4*>(vs + (tx + 16 * j) * RS + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = dot4(qv[i], kv[j], s[i][j]);
        dp[i][j] = dot4(dv[i], vv[j], dp[i][j]);
      }
  }
}

// P and dS of the tile into shared memory (ps may be null: dq needs dS
// only)
__device__ __forceinline__ void probs(float* ps, float* dss,
                                      const float (&s)[4][4],
                                      const float (&dp)[4][4],
                                      const float* lse_s, const float* di_s,
                                      int m0, int n0, int sq, int skv,
                                      int causal, float scale, int tx,
                                      int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i, qp = m0 + row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = tx + 16 * j, kp = n0 + key;
      const bool valid = qp < sq && kp < skv && !(causal && kp > qp);
      const float p = valid ? expf(fmaf(s[i][j], scale, -lse_s[row])) : 0.f;
      if (ps != nullptr) ps[row * PS + key] = p;
      dss[row * PS + key] = p * (dp[i][j] - di_s[row]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ o,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   T* __restrict__ dk, T* __restrict__ dv, int sq, int skv,
                   int group, int causal, float scale) {
  using S = Shape<D>;
  constexpr int RS = S::RS;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // BM x RS
  float* dos = qs + BM * RS;        // BM x RS
  float* ks = dos + BM * RS;        // BN x RS
  float* vs = ks + BN * RS;         // BN x RS
  float* ps = vs + BN * RS;         // BM x PS
  float* dss = ps + BM * PS;        // BM x PS
  float* lse_s = dss + BM * PS;     // BM
  float* di_s = lse_s + BM;         // BM

  const int hk = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int key = tid >> 2, part = tid & 3;   // accumulate: key, float4s
  const int64_t kvoff = (int64_t)hk * skv * D;

  load_tile<T, D>(ks, k + kvoff, n0, skv, tid);
  load_tile<T, D>(vs, v + kvoff, n0, skv, tid);
  float4 dk_acc[S::CH], dv_acc[S::CH];
#pragma unroll
  for (int c = 0; c < S::CH; ++c) dk_acc[c] = dv_acc[c] = zero4();

  const int m_first = causal ? n0 / BM : 0;
  const int n_mt = (sq + BM - 1) / BM;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t qoff = (int64_t)h * sq * D;
    for (int mt = m_first; mt < n_mt; ++mt) {
      const int m0 = mt * BM;
      __syncthreads();   // the previous tile's readers are done
      load_tile<T, D>(qs, q + qoff, m0, sq, tid);
      load_tile<T, D>(dos, dout + qoff, m0, sq, tid);
      if (tid < BM)
        lse_s[tid] = m0 + tid < sq ? lse[(int64_t)h * sq + m0 + tid]
                                   : INFINITY;
      __syncthreads();
      row_delta<T, D>(di_s, dos, o + qoff, m0, sq, tid);
      float s[4][4], dp[4][4];
      scores<D>(s, dp, qs, dos, ks, vs, tx, ty);
      __syncthreads();   // Di and lse of every row are in
      probs(ps, dss, s, dp, lse_s, di_s, m0, n0, sq, skv, causal, scale, tx,
            ty);
      __syncthreads();
      // dV[key] += sum_m P[m][key] dO[m];  dK[key] += sum_m dS[m][key] Q[m]
#pragma unroll 4
      for (int m = 0; m < BM; ++m) {
        const float p = ps[m * PS + key], ds = dss[m * PS + key];
#pragma unroll
        for (int c = 0; c < S::CH; ++c) {
          const int col = 4 * (part + 4 * c);
          dv_acc[c] = axpy4(
              p, *reinterpret_cast<const float4*>(dos + m * RS + col),
              dv_acc[c]);
          dk_acc[c] = axpy4(
              ds, *reinterpret_cast<const float4*>(qs + m * RS + col),
              dk_acc[c]);
        }
      }
    }
  }
  if (n0 + key < skv) {
    T* dkh = dk + kvoff + (int64_t)(n0 + key) * D;
    T* dvh = dv + kvoff + (int64_t)(n0 + key) * D;
#pragma unroll
    for (int c = 0; c < S::CH; ++c) {
      const int col = 4 * (part + 4 * c);
      float4 a = dk_acc[c];
      a.x *= scale;
      a.y *= scale;
      a.z *= scale;
      a.w *= scale;
      store4<T>(dkh + col, a);
      store4<T>(dvh + col, dv_acc[c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 T* __restrict__ dq, int sq, int skv, int group, int causal,
                 float scale) {
  using S = Shape<D>;
  constexpr int RS = S::RS;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + BM * RS;
  float* ks = dos + BM * RS;
  float* vs = ks + BN * RS;
  float* dss = vs + BN * RS + BM * PS;   // the P tile is not needed here
  float* lse_s = dss + BM * PS;
  float* di_s = lse_s + BM;

  const int h = blockIdx.x;
  // causal: the longest rows first, so the short ones fill the tail
  const int qb = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int m0 = qb * BM;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row = tid >> 2, part = tid & 3;   // accumulate: row, float4s
  const int64_t qoff = (int64_t)h * sq * D;
  const int64_t kvoff = (int64_t)(h / group) * skv * D;

  load_tile<T, D>(qs, q + qoff, m0, sq, tid);
  load_tile<T, D>(dos, dout + qoff, m0, sq, tid);
  if (tid < BM)
    lse_s[tid] = m0 + tid < sq ? lse[(int64_t)h * sq + m0 + tid] : INFINITY;
  __syncthreads();
  row_delta<T, D>(di_s, dos, o + qoff, m0, sq, tid);

  float4 dq_acc[S::CH];
#pragma unroll
  for (int c = 0; c < S::CH; ++c) dq_acc[c] = zero4();
  const int kv_end = causal ? min(skv, m0 + BM) : skv;
  const int n_nt = (kv_end + BN - 1) / BN;
  for (int nt = 0; nt < n_nt; ++nt) {
    const int n0 = nt * BN;
    __syncthreads();   // the previous tile's readers are done, Di is in
    load_tile<T, D>(ks, k + kvoff, n0, skv, tid);
    load_tile<T, D>(vs, v + kvoff, n0, skv, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(s, dp, qs, dos, ks, vs, tx, ty);
    probs(nullptr, dss, s, dp, lse_s, di_s, m0, n0, sq, skv, causal, scale,
          tx, ty);
    __syncthreads();
    // dQ[row] += sum_n dS[row][n] K[n]
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      const float ds = dss[row * PS + n];
#pragma unroll
      for (int c = 0; c < S::CH; ++c)
        dq_acc[c] = axpy4(
            ds,
            *reinterpret_cast<const float4*>(ks + n * RS +
                                             4 * (part + 4 * c)),
            dq_acc[c]);
    }
  }
  if (m0 + row < sq) {
    T* dqh = dq + qoff + (int64_t)(m0 + row) * D;
#pragma unroll
    for (int c = 0; c < S::CH; ++c) {
      float4 a = dq_acc[c];
      a.x *= scale;
      a.y *= scale;
      a.z *= scale;
      a.w *= scale;
      store4<T>(dqh + 4 * (part + 4 * c), a);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           int64_t h, int64_t sq, int64_t skv, int group, int causal,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 g1((unsigned)(h / group), (unsigned)((skv + BN - 1) / BN));
  flash_bwd_dkdv<T, D><<<g1, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dk), static_cast<T*>(dv), (int)sq, (int)skv, group,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((unsigned)h, (unsigned)((sq + BM - 1) / BM));
  flash_bwd_dq<T, D><<<g2, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), (int)sq, (int)skv, group, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* dq, void* dk,
                 void* dv, int64_t h, int64_t sq, int64_t skv, int d,
                 int group, int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, dq, dk, dv, h, sq, skv, group, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, dq, dk, dv, h, sq, skv, group, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, h, sq, skv, group, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, h, sq, skv, group, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: (h, sq, d); k, v, dk, dv: (h / group, skv, d); lse: (h,
// sq) f32; all contiguous and 16-byte aligned, the tensors other than lse
// of one dtype (f32 when is_bf16 == 0, bf16 otherwise).  Launches the dK/dV
// kernel, then the dQ kernel, on the stream; returns 0 or a CUDA runtime
// error code.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    int64_t h, int64_t sq, int64_t skv, int d, int group, int causal,
    float scale, int is_bf16, void* stream) {
  if (h <= 0 || sq <= 0 || skv <= 0 || group <= 0 || h % group ||
      (sq + BM - 1) / BM > 65535 || (skv + BN - 1) / BN > 65535 ||
      sq > INT32_MAX || skv > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_width<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, h,
                                       sq, skv, d, group, causal, scale, s);
  return launch_width<float>(q, k, v, o, dout, lse, dq, dk, dv, h, sq, skv,
                             d, group, causal, scale, s);
}

// dynamic shared memory of the kernels of head width d (ptxas reports
// static shared memory only); -1 for a width they lack
extern "C" int flash_attention_bwd_smem_bytes(int d) {
  switch (d) {
    case 16: return (int)Shape<16>::SMEM;
    case 32: return (int)Shape<32>::SMEM;
    case 64: return (int)Shape<64>::SMEM;
    case 128: return (int)Shape<128>::SMEM;
    default: return -1;
  }
}
