// Chain ranking kernels: the device rounds of the recovery layer's list
// ranking (pointer doubling and contraction), all on int32 node ids.
//
// Every pointer these kernels read is range-checked before it is followed:
// a value outside [0, n) ends the chain like NULL (-1).  The wrappers narrow
// 64-bit NEXT columns to int32 only after a 64-bit range check, so a torn
// 2**32 + 3 has already become NULL here and cannot alias node 3.
//
// jump_double
//   Replaces src/repro/kernels/chain_order.py:jump_double (_double_kernel),
//   one doubling round steered through a scalar-prefetched pointer array.
//   Computes jump'[i] = jump[jump[i]] and cnt'[i] = cnt[i] + cnt[jump[i]]
//   for live lanes; NULL absorbs, out-of-range values become NULL.
//   Bound: bytes.  Per node one 4 B and one 8 B load at a data-dependent
//   address (two 32 B sectors) plus 24 B of streaming reads and writes.
//   Design: one thread per node, grid-stride; the streaming half coalesces,
//   the gather half is as random as the chain and leans on the 50 MB L2.
//
// walk_segments
//   Replaces src/repro/kernels/chain_order.py:walk_segments (inner kern),
//   the fused local walk of contraction.  Per lane, up to `budget` hops
//   along nxt until a spine node (id % k == 0, or the promoted head, whose
//   spine index is n_mult; or a spine_pos table lookup when one is given)
//   or the chain end.  Returns the final id, the spine index it arrived at
//   (NULL if it did not) and the hops taken.
//   Bound: latency.  Each hop is a dependent 4 B load; the byte floor of
//   total hops * 32 B sectors / 3.35 TB/s is a lower bound the walk cannot
//   approach.  Design: one thread per lane, so the card keeps one load per
//   lane in flight and hides latency by the ~n/k lanes alone.
//
// expand_segments
//   Replaces src/repro/kernels/chain_order.py:expand_segments (inner kern).
//   Lane i walks rem[i] hops from starts[i] and writes each visited id at
//   out[posn[i] + t].  The Pallas kernel re-stores retired steps because its
//   grid steps share one output block; lanes here retire by leaving the
//   loop, and each output slot is written exactly once.
//   Bound: latency, as walk_segments; byte floor hops * 32 B plus the 8 B
//   output per position.
//
// gather_next
//   Replaces src/repro/kernels/chain_order.py:152 gather_next
//   (_gather_kernel), one prefetch-steered chain hop per lane.  Computes
//   out[i] = nxt[ids[i]] for 0 <= ids[i] < n, else NULL.  ids are read at
//   their own width (int64 or int32) and range-checked before use, so a
//   torn 2**32 + 3 gives NULL instead of aliasing node 3.  The gathered
//   value is returned as stored, as the Pallas kernel returns it: callers
//   sanitize nxt first.
//   Bound: bytes.  Per lane the ids read and the 4 B store stream; the
//   nxt load is data-dependent, one 32 B sector per lane while nxt misses
//   the 50 MB L2 (a 2**22-node column is 16 MB and fits).  Design: one
//   thread per lane, grid-stride, one dependent load each; the streaming
//   half coalesces.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNull = -1;

__device__ __forceinline__ int32_t follow(const int32_t* __restrict__ nxt,
                                          int32_t cur, int64_t n) {
  if (cur < 0 || cur >= n) return kNull;
  const int32_t v = __ldg(nxt + cur);
  return (v >= 0 && v < n) ? v : kNull;
}

__global__ void jump_double_kernel(const int32_t* __restrict__ jump,
                                   const int64_t* __restrict__ cnt,
                                   int32_t* __restrict__ jump_out,
                                   int64_t* __restrict__ cnt_out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t j = jump[i];
    const bool live = j >= 0 && j < n;
    jump_out[i] = live ? follow(jump, j, n) : kNull;
    if (cnt != nullptr) cnt_out[i] = cnt[i] + (live ? __ldg(cnt + j) : 0);
  }
}

__global__ void walk_segments_kernel(
    const int32_t* __restrict__ nxt, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ spine_pos, int32_t* __restrict__ cur_out,
    int32_t* __restrict__ sp_out, int32_t* __restrict__ w_out, int64_t n,
    int64_t lanes, int32_t k, int32_t head, int32_t n_mult, int promoted,
    int32_t budget) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += stride) {
    int32_t cur = starts[i];
    int32_t sp = kNull;
    int32_t w = 0;
    if (cur >= 0) {
      for (int32_t t = 0; t < budget; ++t) {
        cur = follow(nxt, cur, n);
        ++w;
        if (cur < 0) break;  // chain end
        int32_t s;
        if (spine_pos != nullptr) {
          s = __ldg(spine_pos + cur);
        } else {
          s = (cur % k == 0) ? cur / k : kNull;
          if (promoted && cur == head) s = n_mult;
        }
        if (s >= 0) {
          sp = s;
          break;
        }
      }
    }
    cur_out[i] = cur;
    sp_out[i] = sp;
    w_out[i] = w;
  }
}

__global__ void expand_segments_kernel(const int32_t* __restrict__ nxt,
                                       const int32_t* __restrict__ starts,
                                       const int32_t* __restrict__ posn,
                                       const int32_t* __restrict__ rem,
                                       int64_t* __restrict__ out, int64_t n,
                                       int64_t lanes) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += stride) {
    int32_t cur = starts[i];
    const int64_t p = posn[i];
    const int32_t r = rem[i];
    for (int32_t t = 0; t < r; ++t) {
      out[p + t] = cur;
      if (t + 1 < r) cur = follow(nxt, cur, n);
    }
  }
}

template <typename Id>
__global__ void gather_next_kernel(const int32_t* __restrict__ nxt,
                                   const Id* __restrict__ ids,
                                   int32_t* __restrict__ out, int64_t n,
                                   int64_t lanes) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += stride) {
    const int64_t id = (int64_t)ids[i];
    out[i] = (id >= 0 && id < n) ? __ldg(nxt + id) : kNull;
  }
}

unsigned grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident blocks per SM
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" int jump_double_launch(const void* jump, const void* cnt,
                                  void* jump_out, void* cnt_out, int64_t n,
                                  void* stream) {
  const int threads = 256;
  jump_double_kernel<<<grid_for(n, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(jump), static_cast<const int64_t*>(cnt),
      static_cast<int32_t*>(jump_out), static_cast<int64_t*>(cnt_out), n);
  return (int)cudaGetLastError();
}

extern "C" int walk_segments_launch(const void* nxt, const void* starts,
                                    const void* spine_pos, void* cur_out,
                                    void* sp_out, void* w_out, int64_t n,
                                    int64_t lanes, int k, int head,
                                    int n_mult, int promoted, int budget,
                                    void* stream) {
  const int threads = 128;
  walk_segments_kernel<<<grid_for(lanes, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(spine_pos), static_cast<int32_t*>(cur_out),
      static_cast<int32_t*>(sp_out), static_cast<int32_t*>(w_out), n, lanes,
      k, head, n_mult, promoted, budget);
  return (int)cudaGetLastError();
}

extern "C" int expand_segments_launch(const void* nxt, const void* starts,
                                      const void* posn, const void* rem,
                                      void* out, int64_t n, int64_t lanes,
                                      void* stream) {
  const int threads = 128;
  expand_segments_kernel<<<grid_for(lanes, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(posn), static_cast<const int32_t*>(rem),
      static_cast<int64_t*>(out), n, lanes);
  return (int)cudaGetLastError();
}

// id_bytes: 8 for int64 ids, 4 for int32 ids.
extern "C" int gather_next_launch(const void* nxt, const void* ids,
                                  int id_bytes, void* out, int64_t n,
                                  int64_t lanes, void* stream) {
  const int threads = 256;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 8) {
    gather_next_kernel<int64_t><<<grid_for(lanes, threads), threads, 0, s>>>(
        static_cast<const int32_t*>(nxt), static_cast<const int64_t*>(ids),
        static_cast<int32_t*>(out), n, lanes);
  } else if (id_bytes == 4) {
    gather_next_kernel<int32_t><<<grid_for(lanes, threads), threads, 0, s>>>(
        static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(ids),
        static_cast<int32_t*>(out), n, lanes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
