// quantize_blockwise / dequantize_blockwise: the int8 persist format of
// APPROXIMABLE checkpoint leaves (Adam moments): one byte per element plus
// one f32 scale per 256-element group of a row.
//
// Replaces: src/repro/kernels/quant_pack.py:quantize_blockwise
// (_quant_kernel) and :dequantize_blockwise (_dequant_kernel), the Pallas
// kernels that compute one (bn, 256) block per grid step.
//
// Computes, per row and 256-group of x (N, D) f32, D a multiple of 256:
//   scale = max(absmax, 1e-12) * f32(1/127)   (the reference's CPU bits:
//           XLA rewrites its division by the constant 127 into this
//           multiply, so the scale is a multiply here too)
//   q     = clip(rint(x / scale), -127, 127)  (true IEEE division: nvcc's
//           default -prec-div=true, no fast math; rint rounds half to even
//           as jnp.round does)
// A NaN in the group makes absmax and the scale NaN, +-inf makes them inf
// (the max carries NaN through, as the reference's does), and a NaN
// quotient quantizes to 0, as XLA's conversion to int8 gives.
// and back: x' = float(q) * scale, written as f32, or as bf16 rounded to
// nearest even from that f32 product in the same pass (the reference's
// (q * s in f32).astype(dtype), src/repro/kernels/quant_pack.py:60-85).
//
// Bound on an H100: bytes.  quantize reads 4 B and writes 1 B per element
// plus 4 B per 256; dequantize the reverse: about 5.02 B per element at
// 3.35 TB/s (3.02 B with bf16 output).  The arithmetic (one division per
// element) is far below the card's rate.
//
// Design: quantize gives one warp to each (row, group): lane l loads
// elements [8l, 8l+8) as two float4, a __shfl_xor_sync max-reduction gives
// the absmax in every lane, and the lane writes its 8 int8 with one 8-byte
// store; lane 0 writes the scale.  dequantize gives each thread 4
// elements: one 4-byte load of int8, its group's scale (shared by 64
// neighbouring threads), one float4 store (bf16: one 8-byte store of four
// __float2bfloat16_rn), so a warp reads 128 and writes 512 (256)
// contiguous bytes per instruction.  (Sixteen elements a thread, with
// four float4 stores 64 bytes apart, would make each store instruction
// span 2 KB at a quarter density.)  Both walk their work grid-stride with
// 64-bit indices.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 256;

// a NaN quotient (a NaN element, or inf / inf) quantizes to 0, as XLA
// converts NaN to int8; fmaxf would have clipped it to -127
__device__ __forceinline__ uint32_t q8(float x, float scale) {
  const float r = rintf(x / scale);
  if (r != r) return 0u;
  const float v = fminf(fmaxf(r, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)v;
}

// max that carries a NaN through, as the reference's max does (fmaxf
// returns the other operand)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void quantize_kernel(const float* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ scales, int64_t groups) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t g = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                   (threadIdx.x >> 5);
       g < groups; g += warps) {
    // rows are whole groups, so group g covers flat elements [256g, 256g+256)
    const int64_t base = g * kGroup + lane * 8;
    const float4 a = __ldg(reinterpret_cast<const float4*>(x + base));
    const float4 b = __ldg(reinterpret_cast<const float4*>(x + base + 4));
    float m = nan_max(nan_max(nan_max(fabsf(a.x), fabsf(a.y)),
                              nan_max(fabsf(a.z), fabsf(a.w))),
                      nan_max(nan_max(fabsf(b.x), fabsf(b.y)),
                              nan_max(fabsf(b.z), fabsf(b.w))));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float scale = nan_max(m, 1e-12f) * (1.0f / 127.0f);
    uint2 out;
    out.x = q8(a.x, scale) | (q8(a.y, scale) << 8) | (q8(a.z, scale) << 16) |
            (q8(a.w, scale) << 24);
    out.y = q8(b.x, scale) | (q8(b.y, scale) << 8) | (q8(b.z, scale) << 16) |
            (q8(b.w, scale) << 24);
    *reinterpret_cast<uint2*>(q + base) = out;
    if (lane == 0) scales[g] = scale;
  }
}

__device__ __forceinline__ void store4(float* x, int64_t c, float4 v) {
  reinterpret_cast<float4*>(x)[c] = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* x, int64_t c,
                                       float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(x)[c] = w;
}

template <typename T>
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  T* __restrict__ x, int64_t quads) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       c < quads; c += stride) {
    const int64_t e = c * 4;                  // first of 4 elements
    const int w = __ldg(reinterpret_cast<const int*>(q + e));
    const float s = __ldg(scales + e / kGroup);
    float4 v;
    v.x = (float)(int8_t)(w & 0xff) * s;
    v.y = (float)(int8_t)((w >> 8) & 0xff) * s;
    v.z = (float)(int8_t)((w >> 16) & 0xff) * s;
    v.w = (float)(int8_t)((w >> 24) & 0xff) * s;
    store4(x, c, v);
  }
}

int64_t blocks_for(int64_t work_items, int per_block) {
  int64_t blocks = (work_items + per_block - 1) / per_block;
  if (blocks > 132 * 16) blocks = 132 * 16;   // 16 resident blocks per SM
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

// x (n_el,) f32 -> q (n_el,) int8, scales (n_el / 256,) f32; n_el a
// multiple of 256, x 16-byte and q 8-byte aligned.
extern "C" int quantize_blockwise_launch(const void* x, void* q, void* scales,
                                         int64_t n_el, void* stream) {
  const int64_t groups = n_el / kGroup;
  const int threads = 256;                      // 8 warps, 8 groups a block
  quantize_kernel<<<(unsigned)blocks_for(groups, threads / 32), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), groups);
  return (int)cudaGetLastError();
}

// q (n_el,) int8, scales (n_el / 256,) f32 -> x (n_el,) f32, or bf16 when
// is_bf16; n_el a multiple of 256, q 4-byte and x 16-byte aligned.
extern "C" int dequantize_blockwise_launch(const void* q, const void* scales,
                                           void* x, int64_t n_el,
                                           int is_bf16, void* stream) {
  const int64_t quads = n_el / 4;
  const int threads = 256;
  const unsigned blocks = (unsigned)blocks_for(quads, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(scales);
  if (is_bf16)
    dequantize_kernel<<<blocks, threads, 0, s>>>(
        qq, ss, static_cast<__nv_bfloat16*>(x), quads);
  else
    dequantize_kernel<<<blocks, threads, 0, s>>>(
        qq, ss, static_cast<float*>(x), quads);
  return (int)cudaGetLastError();
}
