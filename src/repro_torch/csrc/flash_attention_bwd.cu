// flash_attention_bwd: the gradient of flash_attention (csrc/
// flash_attention.cu) with respect to q, k and v, for grouped-query
// attention, with the forward's sliding window and score softcap,
// deterministic.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// its jnp blockwise_attention (src/repro/models/layers.py:200) and has no
// Pallas backward.  This is the function jax.grad of that layer computes,
// for query head h reading KV head h / group, causal (top-left, kpos <=
// qpos) or not, with a window (qpos - kpos >= window hidden, one-sided as
// in the forward) and a softcap or without.  Given q, o, dO: (H, Sq, D),
// k, v: (H / group, Skv, D) and the forward's lse: (H, Sq) f32 (ln sum exp
// of a row's scaled, capped scores, +inf for a row with no visible key):
//   Di = rowsum(dO * o)
//   s_raw = q.k^T * scale;  t = tanh(s_raw / softcap), s = softcap * t
//        (s = s_raw without a cap)
//   P  = exp(s - lse), 0 where kpos >= Skv, (causal) kpos > qpos or
//        (window) qpos - kpos >= window: the forward's mask
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Di) * (1 - t^2)
//        (the cap's chain rule factor; 1 without a cap)
//   dK = scale * dS^T Q,  dQ = scale * dS K
// with every product and sum in f32 (bf16 inputs: bf16 operands, f32
// accumulation, P and dS rounded to bf16 before the products they feed,
// dS after the cap's factor); the outputs are rounded to the input type.
// The scores are recomputed as the forward computes them (the cap as
// softcap * tanhf(s_raw / softcap) in f32, taken to log2 units after it in
// bf16), so P agrees with the forward's lse.
//
// Bound on an H100: operations, 10 * D flops per (query, key) pair the
// mask keeps (H * Sq * Skv, about halved when causal, about H * Sq *
// window under a window) at 67 TFLOP/s f32 or 989 TFLOP/s bf16; the bytes
// are far below.  This design recomputes S and dP in both of its main
// kernels, 14 flops per pair and width (22 at D = 256, whose column halves
// each recompute them): its own floor is 1.4x (2.2x) the bound.
//
// Three launches a call, no float atomics, every sum in an order fixed by
// the shapes, so two runs give the same bits (a resumed run's losses equal
// an uninterrupted one's only so):
//   delta: Di once, into an (H, Sq) f32 scratch the wrapper allocates: a
//          group of lanes a row, each summing its 16-byte chunks of dO * o,
//          then a butterfly of shuffles.  Both main kernels read Di as they
//          read lse.
//   dkdv:  one block per (KV head, tile of keys) holds K and V and owns dK
//          and dV, walking its group's query heads and, for each, the query
//          tiles that can see its keys, in that fixed order.
//   dq:    one block per (query head, tile of rows) holds Q and dO and owns
//          dQ, walking the key tiles its rows can see (causal: the longest
//          rows first, as the forward does).
// The other deterministic dQ, the dK/dV block adding its dS K partial to an
// f32 workspace in key-tile order behind a turn counter per (head, query
// tile), would save the recompute (10 flops a pair instead of 14), but its
// waiting blocks depend on the order the card schedules blocks in; it is
// not taken.
//
// Window and cap.  A key tile is seen by the query tiles from its own
// first (causal) through the tile holding its last key + window - 1; a
// tile of rows reads key tiles from the one holding max(0, q0 - window +
// 1), the forward's first tile.  Tiles outside the band are neither
// loaded nor computed, so a local layer's backward grows with S * window;
// a tile that the band holds whole for a warpgroup is not masked, only the
// ones crossing the diagonal, the band's lower edge or the ragged edge.
// The cap costs one tanhf per score: P and the factor 1 - t^2 come from the
// same t.  The bf16 kernels take the cap as a template argument, so the
// uncapped ones carry none of its code and keep their registers; the f32
// ones branch on it at run time.
//
// Head width 256 (gemma2).  Neither design's D = 128 tiling fits: the bf16
// dK/dV block's resident 128 keys and three-stage ring would need 320 KB
// of shared memory and its warpgroups 2 x 128 accumulators a thread; the
// f32 kernels' four 64 x 264-float tiles 270 KB.  So at D = 256 a block
// keeps 64 keys (dkdv) or 64 rows (dq), and its output columns are split
// in two 128-column halves: in bf16 the two consumer warpgroups each
// compute the tile's full S and dP (K-major over all of D) and accumulate
// their own half (dK, dV or dQ of 64 x 128: as many accumulators as at
// D = 128), with a two-stage ring (194 KB in all); in f32 a grid axis of
// two picks the half a block owns, and the block streams each tile's
// other half of the columns first, then its own, through tiles of 128 + 8
// floats, so the products read the half still in shared memory (175 KB,
// as at D = 128).  The score work is done twice, the price of fitting.
//
// bf16, on the tensor cores (989 TFLOP/s).  Each main kernel is one
// producer warpgroup and two consumer warpgroups (setmaxnreg moves the
// producer's registers to the consumers: 24 and 240 a thread).  One
// producer warp keeps a TMA ring full (three stages, two at D = 256), an
// mbarrier per stage for "loaded" and one for "released"; tiles are the
// forward's 3-D (D, S, heads) tensor maps with its 32/64/128 B swizzles
// (csrc/hopper.cuh), so rows past S are zero filled and never the next
// head's.  Nothing is transposed in memory:
//   dkdv: 128 keys a block, 64 a consumer warpgroup (D = 256: 64 keys,
//         both), K and V resident; the ring streams 64-query tiles of Q and
//         dO, and the producer warp stores each tile's lse (in log2 units)
//         and Di beside them.  A warpgroup computes S^T = K.Q^T and dP^T =
//         V.dO^T (wgmma m64n64k16, both operands K-major), then P^T =
//         2^(capped S^T in log2 units - lse log2e) and dS^T on the
//         accumulator fragments, masked only on edge tiles, rounds both to
//         bf16 in registers as wgmma's A operand, and accumulates dV +=
//         P^T.dO and dK += dS^T.Q in f32 registers, B read MN-major with
//         the transpose bit, as the forward reads V.  A tile outside a
//         warpgroup's band is only waited for and released.
//   dq:   128 rows a block, 64 a consumer warpgroup (D = 256: 64 rows,
//         both), Q and dO resident; the ring streams 64-key tiles of K and V
//         over the band.  S = Q.K^T and dP = dO.V^T, dS on the fragments (a
//         row's lse and Di sit in the thread's registers), rounded to bf16,
//         dQ += dS.K with K read MN-major.  Tiles outside a warpgroup's band
//         are skipped; only edge tiles are masked.
// dK and dQ are scaled in f32 at the end, so the scale adds no rounding.
// A barrier wait that never ends traps instead of hanging the card.
//
// f32, on the FMA units (67 TFLOP/s; the reference's 1e-4 tolerance rules
// out TF32).  256 threads, tiles of 64 keys by 64 queries, each row padded
// to C + 8 floats in shared memory (C = D, or 128 at D = 256).  A plain
// loop is bound by shared-memory reads (a warp's float4 read is 512 B at
// the SM's 128 B a clock), so both kinds of product are register-blocked
// like a SIMT SGEMM, each float4 read feeding 16 FMAs at D = 128:
//   scores: threads 0-127 compute one 64 x 64 score tile (S^T = K.Q^T in
//           dkdv, S = Q.K^T in dq), threads 128-255 the dP tile, a pair of
//           lanes sharing 8 x 8 outputs, each summing every other float4 of
//           D (16 reads for 256 FMAs), then swapping halves with one
//           shuffle each.  P, then dS, go to shared memory (rows of 68
//           floats) in the layout the next product reads.
//   products: a thread accumulates 8 rows by C / 16 columns from two
//           float4 reads of P or dS and C / 64 reads of the other operand a
//           step (4 reads for 64 FMAs).  In dkdv threads 0-127 own dV and
//           128-255 dK; in dq the two halves sum the tile's two 32-key
//           halves of dQ, added in a fixed order at the end.
// Row strides of C + 8 floats put the reads of a warp in distinct 16-byte
// bank groups.  Shared memory would hold two blocks an SM at D <= 64, but
// registers do not (two blocks of 256 threads leave 128 a thread; the
// kernels need 200-254 at D >= 64 and spill at 128 at D <= 32): one block
// of 8 warps an SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------- Di pass
constexpr int DELTA_THREADS = 256;

template <typename T>
__device__ __forceinline__ float dot16(uint4 a, uint4 b) {
  if constexpr (std::is_same<T, float>::value) {
    float acc = __uint_as_float(a.x) * __uint_as_float(b.x);
    acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
    acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
    return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
  } else {
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
    const uint32_t wb[4] = {b.x, b.y, b.z, b.w};
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wa[i]));
      const float2 y =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wb[i]));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
    return acc;
  }
}

// Di[row] = sum of dO[row] * o[row] over D, rows = H * Sq: the row's
// 16-byte chunks over min(chunks, 32) lanes, a lane summing its chunks
// (two, LANES apart, for f32 at D = 256) in order, then a butterfly of
// shuffles
template <typename T, int D>
struct DeltaShape {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int CHUNKS = D / VEC;
  static constexpr int LANES = CHUNKS < 32 ? CHUNKS : 32;
  static constexpr int PER = CHUNKS / LANES;
};

template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS)
    flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ di, int64_t rows) {
  using S = DeltaShape<T, D>;
  const int64_t g = (int64_t)blockIdx.x * DELTA_THREADS + threadIdx.x;
  const int64_t row = g / S::LANES;
  const int part = (int)(g % S::LANES);
  float acc = 0.f;
  if (row < rows) {
#pragma unroll
    for (int i = 0; i < S::PER; ++i) {
      const int64_t at = row * D + (part + i * S::LANES) * S::VEC;
      const float x = dot16<T>(*reinterpret_cast<const uint4*>(o + at),
                               *reinterpret_cast<const uint4*>(dout + at));
      acc = i ? acc + x : x;
    }
  }
#pragma unroll
  for (int off = S::LANES / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) di[row] = acc;
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* di, int64_t rows,
                 cudaStream_t stream) {
  constexpr int LANES = DeltaShape<T, D>::LANES;
  const int64_t blocks = (rows * LANES + DELTA_THREADS - 1) / DELTA_THREADS;
  flash_bwd_delta<T, D><<<(unsigned)blocks, DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), di, rows);
  return (int)cudaGetLastError();
}

// is the pair (query qp, key kp) hidden by the causal mask or the window?
__device__ __forceinline__ bool hidden(int qp, int kp, int causal,
                                       int window) {
  return (causal && kp > qp) || (window > 0 && qp - kp >= window);
}

// ------------------------------------------------------------- f32 path
namespace f32p {

constexpr int BT = 64;          // keys (dkdv) or rows (dq) a block, and the
                                // streamed tile's rows
constexpr int THREADS = 256;
constexpr int CS = BT + 4;      // row stride of the P and dS tiles

template <int D>
struct Shape {
  // columns a tile holds in shared memory: all of D up to 128; at D = 256
  // one 128-column half at a time, and a block owns one half of its output
  static constexpr int DC = D > 128 ? 128 : D;
  static constexpr int NH = D / DC;                  // halves of D
  static constexpr int RS = DC + 8;                  // tile row stride
  static constexpr int VEC = DC >= 64 ? 4 : DC / 16; // columns per read
  static constexpr int NCH = DC / 16 / VEC;          // reads per step
  static constexpr int OC = DC / 16;                 // columns per thread
  static constexpr size_t SMEM =
      sizeof(float) * (4 * BT * RS + 2 * BT * CS + 2 * BT);
};

template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  else if constexpr (N == 2)
    *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
  else
    dst[0] = *src;
}

// rows [r0, r0 + 64) of the C columns at src of an (n, ld) f32 matrix into a
// tile of stride C + 8; rows at or past n are zero
template <int C>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int n, int ld, int tid) {
  constexpr int C4 = C / 4;
#pragma unroll 4
  for (int i = tid; i < BT * C4; i += THREADS) {
    const int r = i / C4, c = (i - r * C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      x = *reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * ld + c);
    *reinterpret_cast<float4*>(dst + r * Shape<C>::RS + c) = x;
  }
}

// The score layout of thread t (0..127) of a half: the lane pair (lane,
// lane ^ 16) shares a-rows a + 4 i and b-rows b + 4 j, i, j < 8, each lane
// summing the float4s of D with index parity dh; after the swap a lane
// keeps b-rows b + 4 (j + 4 dh), j < 4
struct ScoreAt {
  int a, b, dh;
  __device__ ScoreAt(int t) {
    const int lane = t & 31, w = t >> 5;
    a = (w & 1) * 32 + ((lane >> 2) & 3);
    b = (w >> 1) * 32 + (lane & 3);
    dh = lane >> 4;
  }
  __device__ int kept_b(int j) const { return b + 4 * (j + 4 * dh); }
};

// sp[i][j] += a[at.a + 4 i] . b[at.b + 4 j] over this lane's float4s of the
// C columns the tiles hold
template <int C>
__device__ __forceinline__ void score_part(float (&sp)[8][8], const float* a,
                                           const float* b, const ScoreAt& at) {
  constexpr int RS = Shape<C>::RS;
#pragma unroll 2
  for (int d = 4 * at.dh; d < C; d += 8) {
    float4 bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (at.b + 4 * j) * RS + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(a + (at.a + 4 * i) * RS + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sp[i][j] = fmaf(av.x, bv[j].x, sp[i][j]);
        sp[i][j] = fmaf(av.y, bv[j].y, sp[i][j]);
        sp[i][j] = fmaf(av.z, bv[j].z, sp[i][j]);
        sp[i][j] = fmaf(av.w, bv[j].w, sp[i][j]);
      }
    }
  }
}

// out[i][j] = a[at.a + 4 i] . b[at.kept_b(j)]: each of the pair keeps four
// b-rows and hands its partner the other four
__device__ __forceinline__ void score_swap(float (&out)[8][4],
                                           const float (&sp)[8][8],
                                           const ScoreAt& at) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mine = at.dh ? sp[i][j + 4] : sp[i][j];
      const float theirs = at.dh ? sp[i][j] : sp[i][j + 4];
      out[i][j] = mine + __shfl_xor_sync(0xffffffffu, theirs, 16);
    }
}

// P = exp(s - lse) of the raw product x = q.k: scaled, capped as the
// forward caps it; *fac is the cap's chain-rule factor 1 - tanh^2 (1
// without a cap)
__device__ __forceinline__ float prob(float x, float scale, float lse,
                                      float softcap, float* fac) {
  if (softcap > 0.f) {
    const float t = tanhf(x * scale / softcap);
    *fac = 1.f - t * t;
    return expf(softcap * t - lse);
  }
  *fac = 1.f;
  return expf(fmaf(x, scale, -lse));
}

// acc[r][c] += sum over k in [k0, k1) of ct[k][i0 + r] * b[k][col c], the
// columns c * 64 + cg * VEC + e of a C-column tile
template <int C>
__device__ __forceinline__ void accumulate(float (&acc)[8][Shape<C>::OC],
                                           const float* ct, const float* b,
                                           int i0, int cg, int k0, int k1) {
  using S = Shape<C>;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float cv[8];
    *reinterpret_cast<float4*>(cv) =
        *reinterpret_cast<const float4*>(ct + k * CS + i0);
    *reinterpret_cast<float4*>(cv + 4) =
        *reinterpret_cast<const float4*>(ct + k * CS + i0 + 4);
#pragma unroll
    for (int c = 0; c < S::NCH; ++c) {
      float bv[S::VEC];
      load_vec(bv, b + k * S::RS + c * 64 + cg * S::VEC);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < S::VEC; ++e)
          acc[r][c * S::VEC + e] =
              fmaf(cv[r], bv[e], acc[r][c * S::VEC + e]);
    }
  }
}

// rows i0 + r (< n, scaled) of acc into the C columns at dst of an (n, ld)
// f32 matrix
template <int C>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[8][Shape<C>::OC],
                                           int row0, int n, int cg,
                                           float scale, int ld) {
  using S = Shape<C>;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (row0 + r >= n) break;
#pragma unroll
    for (int c = 0; c < S::NCH; ++c) {
      float out[S::VEC];
#pragma unroll
      for (int e = 0; e < S::VEC; ++e) out[e] = acc[r][c * S::VEC + e] * scale;
      float* p = dst + (int64_t)(row0 + r) * ld + c * 64 + cg * S::VEC;
      if constexpr (S::VEC == 4)
        *reinterpret_cast<float4*>(p) = *reinterpret_cast<float4*>(out);
      else if constexpr (S::VEC == 2)
        *reinterpret_cast<float2*>(p) = *reinterpret_cast<float2*>(out);
      else
        *p = out[0];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, float* __restrict__ dk,
                       float* __restrict__ dv, int sq, int skv, int group,
                       int causal, float scale, int window, float softcap) {
  using S = Shape<D>;
  constexpr int DC = S::DC, NH = S::NH, RS = S::RS;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // BT x RS
  float* vs = ks + BT * RS;         // BT x RS
  float* qs = vs + BT * RS;         // BT x RS
  float* dos = qs + BT * RS;        // BT x RS
  float* pt = dos + BT * RS;        // P^T as [query][key], BT x CS
  float* dst = pt + BT * CS;        // dP^T, then dS^T, [query][key]
  float* lse_s = dst + BT * CS;     // BT
  float* di_s = lse_s + BT;         // BT

  const int hk = blockIdx.x;
  const int n0 = blockIdx.y * BT;
  const int own = blockIdx.z;       // the half of D this block's dK, dV hold
  const int tid = threadIdx.x;
  const int half = tid >> 7, t = tid & 127;
  const ScoreAt at(t);
  // products: keys i0 .. i0 + 7, column group cg
  const int i0 = ((t >> 5) * 2 + ((t & 31) >> 4)) * 8, cg = t & 15;
  const int64_t kvoff = (int64_t)hk * skv * D;

  if constexpr (NH == 1) {
    load_tile<DC>(ks, k + kvoff, n0, skv, D, tid);
    load_tile<DC>(vs, v + kvoff, n0, skv, D, tid);
  }
  float acc[8][S::OC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < S::OC; ++c) acc[r][c] = 0.f;

  // the query tiles that see a key of the block: causal, from the tile of
  // its first key; under a window, up to the tile of its last key +
  // window - 1
  const int n_mt = (sq + BT - 1) / BT;
  const int m_first = causal ? n0 / BT : 0;
  const int m_end =
      window > 0 ? min(n_mt, (min(n0 + BT, skv) - 1 + window - 1) / BT + 1)
                 : n_mt;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t qoff = (int64_t)h * sq * D;
    for (int mt = m_first; mt < m_end; ++mt) {
      const int m0 = mt * BT;
      // S^T (keys x queries) in half 0, dP^T in half 1, over D in NH
      // passes, this block's own half of the columns last, so that its Q
      // and dO stay for the products
      float sp[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sp[i][j] = 0.f;
#pragma unroll
      for (int c = 0; c < NH; ++c) {
        const int col = ((own + 1 + c) % NH) * DC;
        __syncthreads();   // the previous readers of the tiles are done
        if constexpr (NH > 1) {
          load_tile<DC>(ks, k + kvoff + col, n0, skv, D, tid);
          load_tile<DC>(vs, v + kvoff + col, n0, skv, D, tid);
        }
        load_tile<DC>(qs, q + qoff + col, m0, sq, D, tid);
        load_tile<DC>(dos, dout + qoff + col, m0, sq, D, tid);
        if (c == 0 && tid < BT) {
          const bool in = m0 + tid < sq;
          lse_s[tid] = in ? lse[(int64_t)h * sq + m0 + tid] : INFINITY;
          di_s[tid] = in ? di[(int64_t)h * sq + m0 + tid] : 0.f;
        }
        __syncthreads();
        score_part<DC>(sp, half ? vs : ks, half ? dos : qs, at);
      }
      float sc[8][4];
      score_swap(sc, sp, at);
      // a query past Sq has lse +inf, so its P is 0; only tiles crossing
      // the diagonal or the window's edge are masked
      const bool edge = (causal && n0 + BT - 1 > m0) ||
                        (window > 0 && m0 + BT - 1 - n0 >= window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = at.a + 4 * i, qr = at.kept_b(j);
          if (half == 0) {
            float fac;
            float p = prob(sc[i][j], scale, lse_s[qr], softcap, &fac);
            if (edge && hidden(m0 + qr, n0 + key, causal, window)) p = 0.f;
            sc[i][j] = p * fac;
            pt[qr * CS + key] = p;
          } else {
            dst[qr * CS + key] = sc[i][j];
          }
        }
      __syncthreads();
      if (half == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = at.a + 4 * i, qr = at.kept_b(j);
            dst[qr * CS + key] = sc[i][j] * (dst[qr * CS + key] - di_s[qr]);
          }
      }
      __syncthreads();
      // dV[key] += sum_q P^T[key][q] dO[q] (half 0); dK likewise from dS^T
      // and Q (half 1), over this block's columns
      accumulate<DC>(acc, half ? dst : pt, half ? qs : dos, i0, cg, 0, BT);
    }
  }
  store_rows<DC>((half ? dk : dv) + kvoff + own * DC, acc, n0 + i0, skv, cg,
                 half ? scale : 1.f, D);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_f32(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dq,
                     int sq, int skv, int group, int causal, float scale,
                     int window, float softcap) {
  using S = Shape<D>;
  constexpr int DC = S::DC, NH = S::NH, RS = S::RS;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // BT x RS
  float* dos = qs + BT * RS;        // BT x RS
  float* ks = dos + BT * RS;        // BT x RS
  float* vs = ks + BT * RS;         // BT x RS
  float* dst = vs + BT * RS + BT * CS;   // dP, then dS, as [key][row]
  float* lse_s = dst + BT * CS;     // BT
  float* di_s = lse_s + BT;         // BT

  const int h = blockIdx.x;
  // causal: the longest rows first, so the short ones fill the tail
  const int qb = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int m0 = qb * BT;
  const int own = blockIdx.z;       // the half of D this block's dQ holds
  const int tid = threadIdx.x;
  const int half = tid >> 7, t = tid & 127;
  const ScoreAt at(t);
  const int i0 = ((t >> 5) * 2 + ((t & 31) >> 4)) * 8, cg = t & 15;
  const int64_t qoff = (int64_t)h * sq * D;
  const int64_t kvoff = (int64_t)(h / group) * skv * D;

  if constexpr (NH == 1) {
    load_tile<DC>(qs, q + qoff, m0, sq, D, tid);
    load_tile<DC>(dos, dout + qoff, m0, sq, D, tid);
  }
  if (tid < BT) {
    const bool in = m0 + tid < sq;
    lse_s[tid] = in ? lse[(int64_t)h * sq + m0 + tid] : INFINITY;
    di_s[tid] = in ? di[(int64_t)h * sq + m0 + tid] : 0.f;
  }
  float acc[8][S::OC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < S::OC; ++c) acc[r][c] = 0.f;

  // key tiles up to the diagonal (causal), from the tile of the first
  // row's first key in the window
  const int kv_end = causal ? min(skv, m0 + BT) : skv;
  const int n_nt = (kv_end + BT - 1) / BT;
  const int nt_first = window > 0 ? max(0, m0 - window + 1) / BT : 0;
  for (int nt = nt_first; nt < n_nt; ++nt) {
    const int k0 = nt * BT;
    // S (rows x keys) in half 0, dP in half 1, over D in NH passes, the
    // block's own half of the columns last, so that its K stays
    float sp[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sp[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      const int col = ((own + 1 + c) % NH) * DC;
      __syncthreads();   // the previous readers of the tiles are done
      if constexpr (NH > 1) {
        load_tile<DC>(qs, q + qoff + col, m0, sq, D, tid);
        load_tile<DC>(dos, dout + qoff + col, m0, sq, D, tid);
      }
      load_tile<DC>(ks, k + kvoff + col, k0, skv, D, tid);
      load_tile<DC>(vs, v + kvoff + col, k0, skv, D, tid);
      __syncthreads();
      score_part<DC>(sp, half ? dos : qs, half ? vs : ks, at);
    }
    float sc[8][4];
    score_swap(sc, sp, at);
    const bool edge = k0 + BT > skv || (causal && k0 + BT - 1 > m0) ||
                      (window > 0 && m0 + BT - 1 - k0 >= window);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = at.a + 4 * i, key = at.kept_b(j);
        if (half == 0) {
          float fac;
          float p = prob(sc[i][j], scale, lse_s[row], softcap, &fac);
          if (edge && (k0 + key >= skv ||
                       hidden(m0 + row, k0 + key, causal, window)))
            p = 0.f;
          sc[i][j] = p * fac;
        } else {
          dst[key * CS + row] = sc[i][j];
        }
      }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = at.a + 4 * i, key = at.kept_b(j);
          dst[key * CS + row] = sc[i][j] * (dst[key * CS + row] - di_s[row]);
        }
    }
    __syncthreads();
    // dQ[row] += sum_key dS[row][key] K[key]: half 0 the tile's first 32
    // keys, half 1 the last 32
    accumulate<DC>(acc, dst, ks, i0, cg, half * (BT / 2),
                   half * (BT / 2) + BT / 2);
  }
  // the two halves' sums, added in a fixed order through shared memory
  __syncthreads();
  float* part = ks;   // BT x RS, free now
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < S::OC; ++c)
        part[(i0 + r) * RS + (c / S::VEC) * 64 + cg * S::VEC + c % S::VEC] =
            acc[r][c];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < S::OC; ++c)
        acc[r][c] +=
            part[(i0 + r) * RS + (c / S::VEC) * 64 + cg * S::VEC + c % S::VEC];
    store_rows<DC>(dq + qoff + own * DC, acc, m0 + i0, sq, cg, scale, D);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* di, void* dq, void* dk,
           void* dv, int64_t h, int64_t sq, int64_t skv, int group,
           int causal, float scale, int window, float softcap, int parts,
           cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::SMEM;
  constexpr unsigned NH = Shape<D>::NH;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  int rc = 0;
  if (parts & 1) rc = launch_delta<float, D>(o, dout, di, h * sq, stream);
  if (rc == 0 && (parts & 2)) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(h / group), (unsigned)((skv + BT - 1) / BT),
                    NH);
    flash_bwd_dkdv_f32<D><<<grid, THREADS, smem, stream>>>(
        fq, fk, fv, fdo, lse, di, static_cast<float*>(dk),
        static_cast<float*>(dv), (int)sq, (int)skv, group, causal, scale,
        window, softcap);
    rc = (int)cudaGetLastError();
  }
  if (rc == 0 && (parts & 4)) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)h, (unsigned)((sq + BT - 1) / BT), NH);
    flash_bwd_dq_f32<D><<<grid, THREADS, smem, stream>>>(
        fq, fk, fv, fdo, lse, di, static_cast<float*>(dq), (int)sq,
        (int)skv, group, causal, scale, window, softcap);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

}  // namespace f32p

// ------------------------------------------------------------ bf16 path
namespace bf16p {

constexpr int BT = 64;          // rows of a streamed tile (queries or keys)
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;   // and a producer warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

template <int D>
struct Shape {
  // up to D = 128 the two consumer warpgroups own 64 keys (rows) each, all
  // D columns; at D = 256 they share the block's 64 and own one 128-column
  // half of the output each, so their accumulators stay 2 x 64 floats
  static constexpr int NSPLIT = D > 128 ? 2 : 1;
  static constexpr int DO = D / NSPLIT;               // output columns a wg
  static constexpr int BN = 128 / NSPLIT;             // keys of a dkdv block
  static constexpr int QR = 128 / NSPLIT;             // rows of a dq block
  static constexpr int STAGES = D > 128 ? 2 : 3;      // ring depth
  static constexpr int ROWB = (D < 64 ? D : 64) * 2;  // bytes of a swizzled row
  static constexpr int SLABS = D * 2 / ROWB;          // 64-column slabs
  static constexpr int KPS = ROWB / 32;               // k16 steps per slab
  // wgmma layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t SWZ = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int TBYTES = BT * D * 2;           // a streamed tile
  static constexpr int RBYTES = BN * D * 2;           // a resident tile
  // + 1024 to align the tiles to the swizzle period, + the barriers
  static constexpr size_t SMEM_DKDV = 2 * RBYTES + 2 * STAGES * TBYTES +
                                      2 * STAGES * BT * 4 + 1024 +
                                      8 * (1 + 2 * STAGES);
  static constexpr size_t SMEM_DQ =
      2 * RBYTES + 2 * STAGES * TBYTES + 1024 + 8 * (1 + 2 * STAGES);
};

// K-major operand descriptor of k16 step kk over a tile of `rows` rows
template <int D>
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int rows, int kk) {
  using S = Shape<D>;
  return smem_desc(base + (kk / S::KPS) * rows * S::ROWB + (kk % S::KPS) * 32,
                   16, 8 * S::ROWB, S::SWZ);
}

// MN-major B descriptor of rows 16 kt .. 16 kt + 15 of a tile of `rows`
// rows, from column col0 (a multiple of 64 when col0 > 0) on
template <int D>
__device__ __forceinline__ uint64_t ndesc(uint32_t base, int rows, int kt,
                                          int col0) {
  using S = Shape<D>;
  return smem_desc(base + (col0 / 64) * rows * S::ROWB + kt * 16 * S::ROWB,
                   rows * S::ROWB, 8 * S::ROWB, S::SWZ);
}

// a warpgroup's N output columns of rows r0 and r1 (this thread's) into a
// bf16 matrix of row stride ld
template <int N>
__device__ __forceinline__ void store_frag(__nv_bfloat16* base, int64_t r0,
                                           int64_t r1, bool ok0, bool ok1,
                                           const float (&acc)[N / 2],
                                           float scale, int lane, int ld) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (ok0)
      *reinterpret_cast<uint32_t*>(base + r0 * ld + col) =
          pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (ok1)
      *reinterpret_cast<uint32_t*>(base + r1 * ld + col) =
          pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// x = the score of the raw product q.k in log2 units as the forward
// computes it (scaled, capped in natural units), then P = 2^(x - lse2);
// *fac is the cap's chain-rule factor 1 - tanh^2 (1 without a cap).  The
// cap is a template argument: its tanhf and factor would otherwise cost
// the uncapped kernels registers (the dK/dV kernel spills at D = 128)
template <bool CAP>
__device__ __forceinline__ float prob2(float acc, float scale, float lse2,
                                       float softcap, float* fac) {
  if constexpr (CAP) {
    const float t = tanhf(acc * scale / softcap);
    *fac = 1.f - t * t;
    return ex2(softcap * t * LOG2E - lse2);
  }
  *fac = 1.f;
  return ex2(fmaf(acc, scale * LOG2E, -lse2));
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ di,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int sq, int skv,
                        int group, int causal, float scale, int window,
                        float softcap) {
  using S = Shape<D>;
  constexpr int ROWB = S::ROWB, BN = S::BN, STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* vs = ks + S::RBYTES;                 // BN keys, resident
  uint8_t* qs = vs + S::RBYTES;                 // STAGES x TBYTES
  uint8_t* dos = qs + STAGES * S::TBYTES;       // STAGES x TBYTES
  float* lse_s = reinterpret_cast<float*>(dos + STAGES * S::TBYTES);
  float* di_s = lse_s + STAGES * BT;            // STAGES x BT each
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(di_s + STAGES * BT);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + STAGES;

  const int hk = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  // the query tiles that see a key of the block: causal, from the tile of
  // its first key; under a window, up to the tile of its last key +
  // window - 1
  const int n_mt = (sq + BT - 1) / BT;
  const int m_first = causal ? n0 / BT : 0;
  const int m_end =
      window > 0 ? min(n_mt, (min(n0 + BN, skv) - 1 + window - 1) / BT + 1)
                 : n_mt;
  const int per_head = max(0, m_end - m_first);
  const int n_tiles = group * per_head;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 32);   // the producer warp's lanes
      mbar_init(empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one warp keeps the ring full, lane 0 issues the TMA
    regs_dec<PRODUCER_REGS>();
    const int lane = tid - CONSUMERS;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(kvfull, 2 * S::RBYTES);
        for (int c = 0; c < S::SLABS; ++c) {
          tma_load(ks + c * BN * ROWB, &tk, kvfull, c * 64, n0, hk);
          tma_load(vs + c * BN * ROWB, &tv, kvfull, c * 64, n0, hk);
        }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int h = hk * group + t / per_head;
        const int m0 = (m_first + t % per_head) * BT;
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(empty + st, (t / STAGES - 1) & 1);
        // this tile's lse (log2 units: +inf past Sq, so P is 0 there) and Di
        for (int r = lane; r < BT; r += 32) {
          const bool in = m0 + r < sq;
          const int64_t at = (int64_t)h * sq + m0 + r;
          lse_s[st * BT + r] = in ? lse[at] * LOG2E : INFINITY;
          di_s[st * BT + r] = in ? di[at] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * S::TBYTES);
          uint8_t* qd = qs + st * S::TBYTES;
          uint8_t* dd = dos + st * S::TBYTES;
          for (int c = 0; c < S::SLABS; ++c) {
            tma_load(qd + c * BT * ROWB, &tq, full + st, c * 64, m0, h);
            tma_load(dd + c * BT * ROWB, &tdo, full + st, c * 64, m0, h);
          }
        } else {
          mbar_arrive(full + st);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys kb .. kb + 63, and of them
    // the output columns col0 .. col0 + DO - 1
    regs_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int kw = S::NSPLIT == 1 ? wg * 64 : 0;
    const int col0 = S::NSPLIT == 1 ? 0 : wg * S::DO;
    const int kb = n0 + kw;
    const int kp0 = kb + ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int kp1 = kp0 + 8;   // this thread's two keys
    const uint32_t kaddr = smem_u32(ks) + kw * ROWB;
    const uint32_t vaddr = smem_u32(vs) + kw * ROWB;

    float dk_acc[S::DO / 2], dv_acc[S::DO / 2];
#pragma unroll
    for (int i = 0; i < S::DO / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kvfull, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int m0 = (m_first + t % per_head) * BT;
      const int st = t % STAGES;
      mbar_wait(full + st, (t / STAGES) & 1);
      // a tile wholly above this warpgroup's keys, or wholly past their
      // window, is only released
      if (!((causal && kb > m0 + BT - 1) ||
            (window > 0 && m0 - (kb + 63) >= window))) {
        const uint32_t qa = smem_u32(qs + st * S::TBYTES);
        const uint32_t da = smem_u32(dos + st * S::TBYTES);
        // S^T = K.Q^T and dP^T = V.dO^T, 64 keys x 64 queries, f32
        float sacc[32], pacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
        fence_regs(sacc);
        fence_regs(pacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sacc, kdesc<D>(kaddr, BN, kk), kdesc<D>(qa, BT, kk),
                       1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(pacc, kdesc<D>(vaddr, BN, kk), kdesc<D>(da, BT, kk),
                       1);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sacc);
        fence_regs(pacc);

        // sacc[i] is key kp0 (i & 2: kp1), query m0 + 8 (i / 4) + 2 (lane &
        // 3) + (i & 1); P^T and dS^T rounded to bf16 as wgmma A fragments,
        // dS^T after the cap's factor
        const bool edge = (causal && kb + 63 > m0) ||
                          (window > 0 && m0 + BT - 1 - kb >= window);
        const float* ls = lse_s + st * BT;
        const float* ds = di_s + st * BT;
        uint32_t pa[4][4], sa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
          float p[4], s[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float fac;
            float x = prob2<CAP>(sacc[i], scale, (e & 1) ? l2.y : l2.x, softcap,
                            &fac);
            if (edge && hidden(m0 + col + (e & 1), (e & 2) ? kp1 : kp0,
                               causal, window))
              x = 0.f;
            p[e] = x;
            s[e] = x * (pacc[i] - ((e & 1) ? d2.y : d2.x)) * fac;
          }
          pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
          pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
          sa[j / 2][(j & 1) * 2] = pack_bf16(s[0], s[1]);
          sa[j / 2][(j & 1) * 2 + 1] = pack_bf16(s[2], s[3]);
        }

        // dV += P^T.dO, dK += dS^T.Q over this warpgroup's columns: B
        // (queries x DO) MN-major
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < BT / 16; ++kt)
          wgmma_pv<S::DO>(dv_acc, pa[kt], ndesc<D>(da, BT, kt, col0));
#pragma unroll
        for (int kt = 0; kt < BT / 16; ++kt)
          wgmma_pv<S::DO>(dk_acc, sa[kt], ndesc<D>(qa, BT, kt, col0));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      mbar_arrive(empty + st);
    }
    const int64_t off = (int64_t)hk * skv;
    store_frag<S::DO>(dk + col0, off + kp0, off + kp1, kp0 < skv, kp1 < skv,
                      dk_acc, scale, lane, D);
    store_frag<S::DO>(dv + col0, off + kp0, off + kp1, kp0 < skv, kp1 < skv,
                      dv_acc, 1.f, lane, D);
  }
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ di,
                      __nv_bfloat16* __restrict__ dq, int sq, int skv,
                      int group, int causal, float scale, int window,
                      float softcap) {
  using S = Shape<D>;
  constexpr int ROWB = S::ROWB, QR = S::QR, STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* dos = qs + S::RBYTES;                // QR rows, resident
  uint8_t* ks = dos + S::RBYTES;                // STAGES x TBYTES
  uint8_t* vs = ks + STAGES * S::TBYTES;        // STAGES x TBYTES
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vs + STAGES * S::TBYTES);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x;
  // causal: the longest rows first, so the short ones fill the tail
  const int qb = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qb * QR;
  // key tiles up to the block's diagonal (causal), from the tile of its
  // first row's first key in the window: the ring counts from t_first
  const int kv_end = causal ? min(skv, q0 + QR) : skv;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / BT : 0;
  const int n_tiles = max(0, (kv_end + BT - 1) / BT - t_first);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      const int hk = h / group;
      mbar_expect_tx(qfull, 2 * S::RBYTES);
      for (int c = 0; c < S::SLABS; ++c) {
        tma_load(qs + c * QR * ROWB, &tq, qfull, c * 64, q0, h);
        tma_load(dos + c * QR * ROWB, &tdo, qfull, c * 64, q0, h);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const int k0 = (t_first + t) * BT;
        if (t >= STAGES) mbar_wait(empty + st, (t / STAGES - 1) & 1);
        mbar_expect_tx(full + st, 2 * S::TBYTES);
        uint8_t* kd = ks + st * S::TBYTES;
        uint8_t* vd = vs + st * S::TBYTES;
        for (int c = 0; c < S::SLABS; ++c) {
          tma_load(kd + c * BT * ROWB, &tk, full + st, c * 64, k0, hk);
          tma_load(vd + c * BT * ROWB, &tv, full + st, c * 64, k0, hk);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows wg_first .. wg_first + 63, and
    // of them the output columns col0 .. col0 + DO - 1
    regs_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int rw = S::NSPLIT == 1 ? wg * 64 : 0;
    const int col0 = S::NSPLIT == 1 ? 0 : wg * S::DO;
    const int wg_first = q0 + rw;
    const int qp0 = wg_first + ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int qp1 = qp0 + 8;   // this thread's two rows
    const bool rows_dead = wg_first >= sq;
    const uint32_t qaddr = smem_u32(qs) + rw * ROWB;
    const uint32_t daddr = smem_u32(dos) + rw * ROWB;
    const int64_t hrow = (int64_t)h * sq;
    // lse in log2 units (+inf past Sq: P is 0 there) and Di of the two rows
    const float l0 = qp0 < sq ? lse[hrow + qp0] * LOG2E : INFINITY;
    const float l1 = qp1 < sq ? lse[hrow + qp1] * LOG2E : INFINITY;
    const float d0 = qp0 < sq ? di[hrow + qp0] : 0.f;
    const float d1 = qp1 < sq ? di[hrow + qp1] : 0.f;

    float dq_acc[S::DO / 2];
#pragma unroll
    for (int i = 0; i < S::DO / 2; ++i) dq_acc[i] = 0.f;

    mbar_wait(qfull, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      const int k0 = (t_first + t) * BT;
      mbar_wait(full + st, (t / STAGES) & 1);
      // a tile wholly above this warpgroup's rows, wholly below their
      // window band, or over rows past Sq, is only released
      if (!(rows_dead || (causal && k0 > wg_first + 63) ||
            (window > 0 && wg_first - (k0 + BT - 1) >= window))) {
        const uint32_t ka = smem_u32(ks + st * S::TBYTES);
        const uint32_t va = smem_u32(vs + st * S::TBYTES);
        // S = Q.K^T and dP = dO.V^T, 64 rows x 64 keys, f32
        float sacc[32], pacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
        fence_regs(sacc);
        fence_regs(pacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sacc, kdesc<D>(qaddr, QR, kk), kdesc<D>(ka, BT, kk),
                       1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(pacc, kdesc<D>(daddr, QR, kk), kdesc<D>(va, BT, kk),
                       1);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sacc);
        fence_regs(pacc);

        // sacc[i] is row qp0 (i & 2: qp1), key k0 + 8 (i / 4) + 2 (lane &
        // 3) + (i & 1); dS after the cap's factor, rounded to bf16 as wgmma
        // A fragments
        const bool edge = k0 + BT > skv ||
                          (causal && k0 + BT - 1 > wg_first) ||
                          (window > 0 && wg_first + 63 - k0 >= window);
        uint32_t sa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float s[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float fac;
            float x = prob2<CAP>(sacc[i], scale, (e & 2) ? l1 : l0, softcap, &fac);
            if (edge) {
              const int kp = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
              if (kp >= skv ||
                  hidden((e & 2) ? qp1 : qp0, kp, causal, window))
                x = 0.f;
            }
            s[e] = x * (pacc[i] - ((e & 2) ? d1 : d0)) * fac;
          }
          sa[j / 2][(j & 1) * 2] = pack_bf16(s[0], s[1]);
          sa[j / 2][(j & 1) * 2 + 1] = pack_bf16(s[2], s[3]);
        }

        // dQ += dS.K over this warpgroup's columns: B (keys x DO) MN-major
        fence_regs(dq_acc);
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < BT / 16; ++kt)
          wgmma_pv<S::DO>(dq_acc, sa[kt], ndesc<D>(ka, BT, kt, col0));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dq_acc);
      }
      mbar_arrive(empty + st);
    }
    if (!rows_dead)
      store_frag<S::DO>(dq + col0, hrow + qp0, hrow + qp1, qp0 < sq,
                        qp1 < sq, dq_acc, scale, lane, D);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* di, void* dq, void* dk,
           void* dv, int64_t h, int64_t sq, int64_t skv, int group,
           int causal, float scale, int window, float softcap, int parts,
           cudaStream_t stream) {
  using S = Shape<D>;
  const int64_t hk = h / group;
  int rc = 0;
  if (parts & 1)
    rc = launch_delta<__nv_bfloat16, D>(o, dout, di, h * sq, stream);
  if (rc != 0 || !(parts & 6)) return rc;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // Q and dO in tiles of BT rows (dkdv) and QR rows (dq), K and V in tiles
  // of BN rows (dkdv) and BT rows (dq)
  CUtensorMap q_t, do_t, k_r, v_r, q_r, do_r, k_t, v_t;
  CUresult res = make_map(encode, &q_t, q, D, sq, h, BT, S::ROWB);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &do_t, dout, D, sq, h, BT, S::ROWB);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &k_r, k, D, skv, hk, S::BN, S::ROWB);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &v_r, v, D, skv, hk, S::BN, S::ROWB);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &q_r, q, D, sq, h, S::QR, S::ROWB);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &do_r, dout, D, sq, h, S::QR, S::ROWB);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &k_t, k, D, skv, hk, BT, S::ROWB);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &v_t, v, D, skv, hk, BT, S::ROWB);
  if (res != CUDA_SUCCESS) return ENCODE_ERROR + (int)res;
  const bool cap = softcap > 0.f;
  if (parts & 2) {
    auto kern = cap ? flash_bwd_dkdv_bf16<D, true>
                    : flash_bwd_dkdv_bf16<D, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM_DKDV);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)hk, (unsigned)((skv + S::BN - 1) / S::BN));
    kern<<<grid, THREADS, S::SMEM_DKDV, stream>>>(
        q_t, k_r, v_r, do_t, lse, di, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), (int)sq, (int)skv, group, causal,
        scale, window, softcap);
    rc = (int)cudaGetLastError();
  }
  if (rc == 0 && (parts & 4)) {
    auto kern = cap ? flash_bwd_dq_bf16<D, true> : flash_bwd_dq_bf16<D, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM_DQ);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)h, (unsigned)((sq + S::QR - 1) / S::QR));
    kern<<<grid, THREADS, S::SMEM_DQ, stream>>>(
        q_r, k_t, v_t, do_r, lse, di, static_cast<__nv_bfloat16*>(dq),
        (int)sq, (int)skv, group, causal, scale, window, softcap);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

}  // namespace bf16p

template <int D>
int launch_width(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* di, void* dq,
                 void* dk, void* dv, int64_t h, int64_t sq, int64_t skv,
                 int group, int causal, float scale, int window,
                 float softcap, int is_bf16, int parts, cudaStream_t s) {
  if (is_bf16)
    return bf16p::launch<D>(q, k, v, o, dout, lse, di, dq, dk, dv, h, sq, skv,
                            group, causal, scale, window, softcap, parts, s);
  return f32p::launch<D>(q, k, v, o, dout, lse, di, dq, dk, dv, h, sq, skv,
                         group, causal, scale, window, softcap, parts, s);
}

}  // namespace

// q, o, dout, dq: (h, sq, d); k, v, dk, dv: (h / group, skv, d); lse, di:
// (h, sq) f32, di a scratch the Di pass writes and the other two kernels
// read; all contiguous and 16-byte aligned, the tensors other than lse and
// di of one dtype (f32 when is_bf16 == 0, bf16 otherwise).  window and
// softcap are the forward's (0: none).  parts selects the kernels
// launched, in this order on the stream: 1 the Di pass, 2 the dK/dV
// kernel, 4 the dQ kernel (7 for the gradient).  Returns 0, a CUDA runtime
// error code, or 10000 + the driver's CUresult when a tensor map cannot
// be encoded.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* di, void* dq, void* dk,
    void* dv, int64_t h, int64_t sq, int64_t skv, int d, int group,
    int causal, float scale, int window, float softcap, int is_bf16,
    int parts, void* stream) {
  if (h <= 0 || sq <= 0 || skv <= 0 || group <= 0 || h % group ||
      window < 0 || !(softcap >= 0.f) ||
      (sq + 63) / 64 > 65535 || (skv + 63) / 64 > 65535 ||
      sq > INT32_MAX || skv > INT32_MAX || (parts & ~7))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(di);
#define BWD_ARGS                                                          \
  q, k, v, o, dout, l, dd, dq, dk, dv, h, sq, skv, group, causal, scale, \
      window, softcap, is_bf16, parts, s
  switch (d) {
    case 16: return launch_width<16>(BWD_ARGS);
    case 32: return launch_width<32>(BWD_ARGS);
    case 64: return launch_width<64>(BWD_ARGS);
    case 128: return launch_width<128>(BWD_ARGS);
    case 256: return launch_width<256>(BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_ARGS
}

// dynamic shared memory of the dK/dV kernel (kernel 0) or the dQ kernel
// (kernel 1) of head width d in the given type (ptxas reports static
// shared memory only; the Di pass has none); -1 for a width they lack
template <int D>
int smem_bytes(int is_bf16, int kernel) {
  if (is_bf16)
    return (int)(kernel ? bf16p::Shape<D>::SMEM_DQ
                        : bf16p::Shape<D>::SMEM_DKDV);
  return (int)f32p::Shape<D>::SMEM;
}

extern "C" int flash_attention_bwd_smem_bytes(int d, int is_bf16,
                                              int kernel) {
  switch (d) {
    case 16: return smem_bytes<16>(is_bf16, kernel);
    case 32: return smem_bytes<32>(is_bf16, kernel);
    case 64: return smem_bytes<64>(is_bf16, kernel);
    case 128: return smem_bytes<128>(is_bf16, kernel);
    case 256: return smem_bytes<256>(is_bf16, kernel);
    default: return -1;
  }
}
