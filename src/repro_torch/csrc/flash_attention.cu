// flash_attention: online-softmax attention over (heads, Sq, D) with the
// K/V of each query head read from its KV head (grouped-query attention).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel), the Pallas kernel whose grid (H, Sq/bq, Skv/bk) keeps the
// running max m, sum l and accumulator acc of one q block in VMEM scratch
// across the KV axis, relying on the TPU's sequential minor-axis order.
//
// Computes, for query head h and KV head h / group:
//   s = q . k^T * scale in f32; with softcap > 0, s = softcap *
//   tanh(s / softcap) (gemma2's score cap, before the mask, as the
//   reference's layer applies it: src/repro/models/layers.py:128); masked
//   where kpos > qpos (causal), where qpos - kpos >= window (window > 0, a
//   sliding window; one-sided, on top of causal or not, as the reference's
//   mask at layers.py:258) or where kpos >= Skv (the ragged tile edge);
//   m_new = max(m, rowmax s);
//   p = exp(s - m_new) where s > 0.5 * NEG_INF, else 0;
//   l = l * exp(m - m_new) + rowsum p; acc = acc * exp(m - m_new) + p . v;
//   out = acc / max(l, 1e-30), in q's dtype; rows >= Sq are not written;
//   when an lse pointer is given, also lse = m + log(l) in f32 per row
//   (natural units of s), +inf for a row whose l is 0, which the backward
//   (csrc/flash_attention_bwd.cu) reads to rebuild P.  Serving passes null
//   and gets the kernels as they were.
// With group == 1, window 0 and softcap 0 this is exactly the TPU kernel's
// function; the window and the cap are what the reference computes for
// gemma's layers in XLA (layers.py:200-285), which its Pallas kernel
// lacks.  Both kernels
// give a masked score -inf and exponentiate a row that has no visible key
// yet against 0, which excludes it as the s > 0.5 * NEG_INF test does.
//
// Bound on an H100: operations, 4 * D flops per (query, key) pair the mask
// keeps (H * Sq * Skv in all, about halved when causal, about H * Sq *
// window under a window); the bytes (q, k, v, o once) are far below.
//
// Sliding window: a block's KV loop starts at the tile holding its first
// row's first visible key, max(0, q0 - window + 1): tiles below the band
// are skipped, not masked, so a local layer's work grows with S * window,
// not S^2 / 2.  The element mask runs only on tiles that cross the band's
// lower edge, the diagonal or the ragged edge.  Softcap: one tanhf per f32
// score, before the running max, so the lse the kernel writes is that of
// the capped scores.  One C entry point, two kernels, one per input type:
//
// bf16, on the tensor cores (989 TFLOP/s).  A block owns 128 q rows of one
// head: two consumer warpgroups of 64 rows and one producer warp.  The
// producer loads Q once and the K and V tiles of 128 keys through TMA into
// a two-stage ring in shared memory (bf16, never widened), each tile
// described as a 3-D (D, S, heads) tensor so that rows past S are zero
// filled and never the next head's; an mbarrier per stage reports K, V and
// the release of the stage.  A consumer computes S = Q.K^T as a chain of
// wgmma m64nBKk16 (both operands K-major in shared memory), scales the f32
// scores after the product (Q stays unscaled bf16, so no rounding is added
// before the product), runs the online softmax on the accumulator fragments
// in log2 units, one ex2 per score (row max and row sum are quad shuffles;
// l stays a per-thread partial until the end), rounds P to bf16 in
// registers and feeds it as wgmma's register-sourced A for O += P.V, with V
// read MN-major from shared memory (the transpose bit).  With D = 128 a
// row is 256 B, past the 128 B that a 128-byte-swizzled TMA box may hold,
// so every tile is two 64-column slabs and the descriptors walk the same
// two.  D = 32 and 16 use the 64 B and 32 B swizzles.  Causal: KV tiles
// above a block's diagonal are never loaded, a warpgroup skips the product
// on a tile wholly above its own 64 rows, and only tiles that cross the
// diagonal or the ragged edge are masked.  The output is stored from
// registers, rows >= Sq masked.  A barrier wait that never ends traps
// rather than hanging the card.  The mbarrier, TMA, descriptor and wgmma
// helpers are in csrc/hopper.cuh, which the backward shares.  D = 256
// (gemma2) takes KV tiles of 64 keys: Q (64 KB) and a two-stage ring of K
// and V tiles (4 x 32 KB) fill 193 KB of shared memory, and each thread
// holds its 128 f32 output accumulators, 32 scores and P's 16 words
// (O += P.V is one wgmma m64n256k16 per 16 keys, four 64-column slabs).
//
// f32, on the FMA units (67 TFLOP/s; the reference's products are f32 and
// its 1e-4 tolerance rules out TF32).  A block of 128 threads owns 64 q
// rows and walks KV tiles of 32 keys; cp.async double-buffers K and V so
// the next tile's copy overlaps this tile's products.  A plain loop is
// bound by shared-memory reads, not FMAs: a warp's float4 read delivers
// 512 B at the SM's 128 B per clock.  So both products are register-
// blocked like a SIMT SGEMM.  A score is split over a pair of lanes, each
// summing every other float4 of D for 4 rows x 8 keys (12 reads for 128
// FMAs), and the pair swaps halves with one shuffle each; a thread's
// output is 8 rows x D / 16 columns from float4 reads of P and V (16 reads
// for 256 FMAs at D = 128).  Q and K rows are padded to D + 8 floats and
// P rows to 36, so the reads of a warp fall in distinct 16-byte bank
// groups.  Q is scaled in f32 on load, as the TPU kernel does; P and each
// row's rescale pass through shared memory between the two products.
// At D = 256 one block needs 205 KB of shared memory, so one block (four
// warps) runs on an SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------- f32 path
namespace f32p {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;

template <int D>
struct Shape {
  static constexpr int QS = D + 8;                  // q and k row stride
  static constexpr int PS = BK + 4;                 // p row stride
  static constexpr int VEC = D >= 64 ? 4 : D / 16;  // o columns per read
  static constexpr int NCH = D / 16 / VEC;          // reads per key and row
  static constexpr size_t SMEM =
      sizeof(float) *
      (BQ * QS + 2 * BK * QS + 2 * BK * D + BQ * PS + 2 * BQ);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // a chunk past Skv is zero filled (src-size 0): its V row must be finite
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int D>
__device__ __forceinline__ void load_kv(float* ks, float* vs, const float* kh,
                                        const float* vh, int k0, int skv,
                                        int tid) {
  constexpr int C4 = D / 4;
#pragma unroll
  for (int i = tid; i < BK * C4; i += THREADS) {
    const int r = i / C4, c = (i - r * C4) * 4;
    const bool in = k0 + r < skv;
    const int64_t off = (int64_t)(in ? k0 + r : 0) * D + c;
    cp_async16(ks + r * Shape<D>::QS + c, kh + off, in);
    cp_async16(vs + r * D + c, vh + off, in);
  }
}

template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  else if constexpr (N == 2)
    *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
  else
    dst[0] = *src;
}

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float (&src)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  else if constexpr (N == 2)
    *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
  else
    *dst = src[0];
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int sq, int skv, int group,
              int causal, float scale, int window, float softcap) {
  using S = Shape<D>;
  constexpr int OC = S::NCH * S::VEC;   // o columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // BQ x QS, scaled q
  float* ks = qs + BQ * S::QS;          // 2 x BK x QS
  float* vs = ks + 2 * BK * S::QS;      // 2 x BK x D
  float* ps = vs + 2 * BK * D;          // BQ x PS, probabilities
  float* alpha_s = ps + BQ * S::PS;     // BQ: this tile's rescale per row
  float* l_s = alpha_s + BQ;            // BQ: the running sum per row

  const int h = blockIdx.x;
  // causal: the longest q blocks first, so the short ones fill the tail
  const int qb = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qb * BQ;
  const int tid = threadIdx.x, lane = tid & 31;
  // scores: the pair (lane, lane ^ 16) shares 4 rows x 8 keys, each
  // summing every other float4 of D (dh); rows rg + 16 i, keys kg + 4 j
  const int dh = lane >> 4;
  const int rg = (tid >> 5) * 4 + ((lane >> 2) & 3);
  const int kg = lane & 3;
  // output: rows og + 8 i, columns c * 64 + ocg * VEC + e
  const int og = tid >> 4, ocg = tid & 15;
  const float* qh = q + (int64_t)h * sq * D;
  const float* kh = k + (int64_t)(h / group) * skv * D;
  const float* vh = v + (int64_t)(h / group) * skv * D;
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  // the tiles below the window's band hold no key any row of the block sees
  const int t_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  if (t_first < n_tiles) {
    load_kv<D>(ks, vs, kh, vh, t_first * BK, skv, tid);
    cp_async_commit();
  }
  if (tid < BQ) l_s[tid] = 0.f;   // a row that sees no key sums to 0
  for (int i = tid; i < BQ * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq)
      x = *reinterpret_cast<const float4*>(qh + (int64_t)(q0 + r) * D + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(qs + r * S::QS + c) = x;
  }

  float m[4], l[4], acc[8][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  for (int t = t_first; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int buf = (t - t_first) & 1;
    cp_async_wait0();    // this tile's copies have landed ...
    __syncthreads();     // ... for every thread, and tile t - 1 is done
    if (t + 1 < n_tiles) {
      load_kv<D>(ks + (buf ^ 1) * BK * S::QS, vs + (buf ^ 1) * BK * D, kh,
                 vh, k0 + BK, skv, tid);
      cp_async_commit();
    }
    const float* kt = ks + buf * BK * S::QS;
    const float* vt = vs + buf * BK * D;

    // partial scores over this thread's half of D
    float sp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 4 * dh; d < D; d += 8) {
      float4 kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + (kg + 4 * j) * S::QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * S::QS + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sp[i][j] = fmaf(qv.x, kv[j].x, sp[i][j]);
          sp[i][j] = fmaf(qv.y, kv[j].y, sp[i][j]);
          sp[i][j] = fmaf(qv.z, kv[j].z, sp[i][j]);
          sp[i][j] = fmaf(qv.w, kv[j].w, sp[i][j]);
        }
      }
    }
    // reduce-scatter over the pair: this thread keeps keys
    // kg + 4 jj + 16 dh, jj < 4, and hands its partner the other four
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float mine = dh ? sp[i][jj + 4] : sp[i][jj];
        const float theirs = dh ? sp[i][jj] : sp[i][jj + 4];
        s[i][jj] = mine + __shfl_xor_sync(0xffffffffu, theirs, 16);
      }
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[i][jj] = softcap * tanhf(s[i][jj] / softcap);
    }

    // a masked key is -inf; a row with no visible key yet keeps m = -inf
    // and exponentiates against 0, so its p are 0 (the TPU kernel's
    // s > 0.5 * NEG_INF exclusion)
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg + 16 * i;
      if (edge) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kp = k0 + kg + 4 * jj + 16 * dh;
          if (kp >= skv || (causal && kp > q0 + row) ||
              (window > 0 && q0 + row - kp >= window))
            s[i][jj] = -INFINITY;
        }
      }
      // a row's 32 keys lie on the 8 lanes that differ in bits 0, 1, 4
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[i], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float p[4], rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        p[jj] = __expf(s[i][jj] - base);
        rs += p[jj];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 16);
      const float alpha = __expf(m[i] - base);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      if (kg == 0 && dh == 0) {
        alpha_s[row] = alpha;
        l_s[row] = l[i];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ps[row * S::PS + kg + 4 * jj + 16 * dh] = p[jj];
    }
    __syncthreads();   // P and the rescales are visible to every warp

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = alpha_s[og + 8 * i];
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= a;
    }
#pragma unroll 2
    for (int j4 = 0; j4 < BK; j4 += 4) {
      float pv[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(pv[i]) =
            *reinterpret_cast<const float4*>(ps + (og + 8 * i) * S::PS + j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vt + (j4 + jj) * D + ocg * S::VEC;
#pragma unroll
        for (int c = 0; c < S::NCH; ++c) {
          float vv[S::VEC];
          load_vec(vv, vrow + c * 64);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < S::VEC; ++e)
              acc[i][c * S::VEC + e] =
                  fmaf(pv[i][jj], vv[e], acc[i][c * S::VEC + e]);
        }
      }
    }
  }
  __syncthreads();   // l_s is final (also when the block saw no tile)

  float* oh = o + (int64_t)h * sq * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qr = q0 + og + 8 * i;
    if (qr >= sq) continue;
    const float denom = fmaxf(l_s[og + 8 * i], 1e-30f);
#pragma unroll
    for (int c = 0; c < S::NCH; ++c) {
      float out[S::VEC];
#pragma unroll
      for (int e = 0; e < S::VEC; ++e) out[e] = acc[i][c * S::VEC + e] / denom;
      store_vec(oh + (int64_t)qr * D + c * 64 + ocg * S::VEC, out);
    }
  }
  // every lane of a row's group holds its m and l; one of them writes
  if (lse != nullptr && kg == 0 && dh == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + rg + 16 * i;
      if (qr < sq)
        lse[(int64_t)h * sq + qr] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int64_t h, int64_t sq, int64_t skv, int group,
                   int causal, float scale, int window, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)h, (unsigned)((sq + BQ - 1) / BQ));
  flash_f32<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, (int)sq,
      (int)skv, group, causal, scale, window, softcap);
  return cudaGetLastError();
}

}  // namespace f32p

// ------------------------------------------------------------ bf16 path
namespace bf16p {

constexpr int BQ = 128;                 // two consumer warpgroups of 64 rows
constexpr int STAGES = 2;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32; // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Shape {
  // keys a KV tile holds: 64 at D = 256, where tiles of 128 would not fit
  static constexpr int BK = D > 128 ? 64 : 128;
  static constexpr int ROWB = (D < 64 ? D : 64) * 2;  // bytes of a swizzled row
  static constexpr int SLABS = D * 2 / ROWB;          // 64-column slabs
  static constexpr int KPS = ROWB / 32;               // k16 steps per slab
  // wgmma layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t SWZ = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int QBYTES = BQ * D * 2;
  static constexpr int KBYTES = BK * D * 2;
  // + 1024 to align the ring to the swizzle period, + the barriers
  static constexpr size_t SMEM =
      QBYTES + 2 * STAGES * KBYTES + 1024 + 8 * (1 + 3 * STAGES);
};

// S (64 x BK) (+)= Q . K^T, both K-major in shared memory
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BK == 128)
    wgmma_ss_n128(d, da, db, 1);
  else
    wgmma_ss_n64(d, da, db, 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int sq,
               int skv, int group, int causal, float scale, int window,
               float softcap) {
  using S = Shape<D>;
  constexpr int ROWB = S::ROWB;
  constexpr int BK = S::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + S::QBYTES;                 // STAGES x KBYTES
  uint8_t* vs = ks + STAGES * S::KBYTES;        // STAGES x KBYTES
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vs + STAGES * S::KBYTES);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  const int h = blockIdx.x;
  const int qb = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qb * BQ;
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  // the tiles below the window's band hold no key any row of the block
  // sees: neither loaded nor waited for
  const int t_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    if (tid == CONSUMERS) {
      const int hk = h / group;
      mbar_expect_tx(qfull, S::QBYTES);
      for (int c = 0; c < S::SLABS; ++c)
        tma_load(qs + c * BQ * ROWB, &tq, qfull, c * 64, q0, h);
      for (int t = t_first; t < n_tiles; ++t) {
        const int j = t - t_first;   // the ring's count of tiles
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(empty + st, (j / STAGES - 1) & 1);
        uint8_t* kd = ks + st * S::KBYTES;
        uint8_t* vd = vs + st * S::KBYTES;
        mbar_expect_tx(kfull + st, S::KBYTES);
        for (int c = 0; c < S::SLABS; ++c)
          tma_load(kd + c * BK * ROWB, &tk, kfull + st, c * 64, t * BK, hk);
        mbar_expect_tx(vfull + st, S::KBYTES);
        for (int c = 0; c < S::SLABS; ++c)
          tma_load(vd + c * BK * ROWB, &tv, vfull + st, c * 64, t * BK, hk);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns block rows wg * 64 .. wg * 64 + 63
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int row0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int qp0 = q0 + row0, qp1 = qp0 + 8;   // this thread's two rows
  const int wg_first = q0 + wg * 64;
  const bool rows_dead = wg_first >= sq;
  const uint32_t qaddr = smem_u32(qs) + wg * 64 * ROWB;

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(qfull, 0);
  for (int t = t_first; t < n_tiles; ++t) {
    const int st = (t - t_first) % STAGES;
    const int par = ((t - t_first) / STAGES) & 1;
    const int k0 = t * BK;
    // a tile wholly above this warpgroup's rows, wholly below their window
    // band, or over rows past Sq, is only waited for, so the stage is
    // released in order
    const bool dead = rows_dead || (causal && k0 > wg_first + 63) ||
                      (window > 0 && wg_first - (k0 + BK - 1) >= window);
    mbar_wait(kfull + st, par);
    if (!dead) {
      // S = Q . K^T, f32, 64 x BK per warpgroup
      float sacc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
      const uint32_t kaddr = smem_u32(ks + st * S::KBYTES);
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int slab = kk / S::KPS, sub = (kk % S::KPS) * 32;
        wgmma_qk<BK>(
            sacc,
            smem_desc(qaddr + slab * BQ * ROWB + sub, 16, 8 * ROWB, S::SWZ),
            smem_desc(kaddr + slab * BK * ROWB + sub, 16, 8 * ROWB, S::SWZ));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sacc);

      // online softmax on the fragments: sacc[i] is row qp0 (i & 2: qp1),
      // key k0 + 8 (i / 4) + 2 (lane & 3) + (i & 1).  Scores, m and the
      // exponents are in log2 units (x = s * scale * log2 e, p = 2^(x - m));
      // a masked key is -inf, and a row with no visible key yet keeps
      // m = -inf and exponentiates against 0, so its p are 0: the TPU
      // kernel's s > 0.5 * NEG_INF exclusion, without a compare per score.
      // A capped score is capped in natural units, then taken to log2 ones
      const float c = scale * LOG2E;
      const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > wg_first) ||
                        (window > 0 && wg_first + 63 - k0 >= window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = softcap > 0.f
                      ? softcap * tanhf(sacc[i] * scale / softcap) * LOG2E
                      : sacc[i] * c;
        if (edge) {
          const int kp = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int qp = (i & 2) ? qp1 : qp0;
          if (kp >= skv || (causal && kp > qp) ||
              (window > 0 && qp - kp >= window))
            x = -INFINITY;
        }
        sacc[i] = x;
        if (i & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float b0 = mn0 == -INFINITY ? 0.f : mn0;
      const float b1 = mn1 == -INFINITY ? 0.f : mn1;
      const float a0 = ex2(m0 - b0), a1 = ex2(m1 - b1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = ex2(sacc[i] - ((i & 2) ? b1 : b0));
        sacc[i] = p;
        if (i & 2)
          rs1 += p;
        else
          rs0 += p;
      }
      l0 = l0 * a0 + rs0;   // a per-thread partial of the row sum
      l1 = l1 * a1 + rs1;
      uint32_t pa[BK / 16][4];   // P in bf16, wgmma's A fragment layout
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        pa[kt][0] = pack_bf16(sacc[8 * kt + 0], sacc[8 * kt + 1]);
        pa[kt][1] = pack_bf16(sacc[8 * kt + 2], sacc[8 * kt + 3]);
        pa[kt][2] = pack_bf16(sacc[8 * kt + 4], sacc[8 * kt + 5]);
        pa[kt][3] = pack_bf16(sacc[8 * kt + 6], sacc[8 * kt + 7]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] *= (i & 2) ? a1 : a0;

      // O += P . V: V (keys x D) is MN-major; 16 keys per step, the next
      // 64-column slab BK * ROWB bytes on
      mbar_wait(vfull + st, par);
      const uint32_t vaddr = smem_u32(vs + st * S::KBYTES);
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        wgmma_pv<D>(oacc, pa[kt],
                    smem_desc(vaddr + kt * 16 * ROWB, BK * ROWB, 8 * ROWB,
                              S::SWZ));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(oacc);
    } else {
      mbar_wait(vfull + st, par);
    }
    mbar_arrive(empty + st);
  }
  if (rows_dead) return;

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // m is in log2 units: lse = ln(2^m * l) = (m + log2 l) * ln 2
  if (lse != nullptr && (lane & 3) == 0) {
    float* lh = lse + (int64_t)h * sq;
    if (qp0 < sq) lh[qp0] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : INFINITY;
    if (qp1 < sq) lh[qp1] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : INFINITY;
  }
  // one reciprocal per row: the output is rounded to bf16 after it
  const float r0 = 1.f / fmaxf(l0, 1e-30f), r1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* oh = o + (int64_t)h * sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (qp0 < sq)
      *reinterpret_cast<uint32_t*>(oh + (int64_t)qp0 * D + col) =
          pack_bf16(oacc[4 * j] * r0, oacc[4 * j + 1] * r0);
    if (qp1 < sq)
      *reinterpret_cast<uint32_t*>(oh + (int64_t)qp1 * D + col) =
          pack_bf16(oacc[4 * j + 2] * r1, oacc[4 * j + 3] * r1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t h, int64_t sq, int64_t skv, int group, int causal,
           float scale, int window, float softcap, cudaStream_t stream) {
  using S = Shape<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  CUresult res = make_map(encode, &tq, q, D, sq, h, BQ, S::ROWB);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &tk, k, D, skv, h / group, S::BK, S::ROWB);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &tv, v, D, skv, h / group, S::BK, S::ROWB);
  if (res != CUDA_SUCCESS) return ENCODE_ERROR + (int)res;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)h, (unsigned)((sq + BQ - 1) / BQ));
  flash_bf16<D><<<grid, THREADS, S::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, (int)sq, (int)skv,
      group, causal, scale, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace bf16p

}  // namespace

// q, o: (h, sq, d); k, v: (h / group, skv, d); all contiguous, 16-byte
// aligned, one dtype (f32 when is_bf16 == 0, bf16 otherwise); lse null or
// (h, sq) f32; window 0 (none) or the keys a row sees back to itself;
// softcap 0 (none) or the score cap.  Returns 0, a CUDA runtime error
// code, or 10000 + the driver's CUresult when a tensor map cannot be
// encoded.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse_out,
                                      int64_t h, int64_t sq, int64_t skv,
                                      int d, int group, int causal,
                                      float scale, int window, float softcap,
                                      int is_bf16, void* stream) {
  if (h <= 0 || sq <= 0 || skv <= 0 || group <= 0 || h % group ||
      window < 0 || !(softcap >= 0.f) ||
      sq > (int64_t)f32p::BQ * 65535 || sq > INT32_MAX || skv > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
#define FLASH_ARGS \
  q, k, v, o, lse, h, sq, skv, group, causal, scale, window, softcap, s
  if (is_bf16) {
    switch (d) {
      case 16: return bf16p::launch<16>(FLASH_ARGS);
      case 32: return bf16p::launch<32>(FLASH_ARGS);
      case 64: return bf16p::launch<64>(FLASH_ARGS);
      case 128: return bf16p::launch<128>(FLASH_ARGS);
      case 256: return bf16p::launch<256>(FLASH_ARGS);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (d) {
    case 16: return (int)f32p::launch<16>(FLASH_ARGS);
    case 32: return (int)f32p::launch<32>(FLASH_ARGS);
    case 64: return (int)f32p::launch<64>(FLASH_ARGS);
    case 128: return (int)f32p::launch<128>(FLASH_ARGS);
    case 256: return (int)f32p::launch<256>(FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

// dynamic shared memory of the kernel that takes head width d in the given
// type (ptxas reports static shared memory only); -1 for a width it lacks
extern "C" int flash_attention_smem_bytes(int d, int is_bf16) {
  switch (d) {
    case 16: return (int)(is_bf16 ? bf16p::Shape<16>::SMEM : f32p::Shape<16>::SMEM);
    case 32: return (int)(is_bf16 ? bf16p::Shape<32>::SMEM : f32p::Shape<32>::SMEM);
    case 64: return (int)(is_bf16 ? bf16p::Shape<64>::SMEM : f32p::Shape<64>::SMEM);
    case 128: return (int)(is_bf16 ? bf16p::Shape<128>::SMEM : f32p::Shape<128>::SMEM);
    case 256: return (int)(is_bf16 ? bf16p::Shape<256>::SMEM : f32p::Shape<256>::SMEM);
    default: return -1;
  }
}
