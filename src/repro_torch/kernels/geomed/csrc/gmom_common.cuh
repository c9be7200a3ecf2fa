// Fixed-order reductions shared by the port's GMoM kernels (sm_90a).
//
// Cross-block sums never use float atomics: each block writes its partial
// sums to a (n_blocks, k) buffer, and the buffer is reduced in one fixed
// order (by a one-block kernel, or by every block of a persistent grid
// after a grid barrier), so every result is bitwise identical run to run
// (the reference's determinism rule, ROADMAP "Determinism").

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // grid kernels
constexpr int kReduceThreads = 1024;   // one-block kernels
constexpr int kWarps = kThreads / 32;

// jnp.maximum: NaN in `a` propagates (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : fmaxf(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
  // fixed butterfly order: deterministic; the sum lands in lane 0
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-reduce KMAX per-thread accumulators (only l < k used) and write
// part[blockIdx.x * k + l].  Fixed order: warp butterflies, then warps in
// ascending order.
template <int KMAX>
__device__ __forceinline__ void block_store_partials(const float (&acc)[KMAX],
                                                     int k, float* part) {
  __shared__ float smem[kWarps][KMAX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < KMAX; ++l) {
    if (l < k) {
      float v = warp_sum(acc[l]);
      if (lane == 0) smem[warp][l] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < k) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += smem[w][threadIdx.x];
    part[(size_t)blockIdx.x * k + threadIdx.x] = s;
  }
}

__device__ __forceinline__ float block_sum_scalar(float v) {
  __shared__ float smem[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += smem[w];
  return s;  // valid in thread 0
}

// One block's reduction of a (n_blocks, k) partial buffer in global memory
// into out[0:k] (shared or global memory).  Warp w sums columns l = w, w +
// nw, ...; lane i sums rows i, i + 32, ... in order, then a butterfly.
// Fixed order, whatever the block size.  `ld` is the buffer's row stride
// (default k).  The loads bypass L1 (ld.global.cg) so that a persistent
// grid reads what other blocks wrote before a grid barrier, not a stale
// line.
__device__ void reduce_partials(const float* part, int n_blocks, int k,
                                float* out, int ld = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (ld == 0) ld = k;
  for (int l = warp; l < k; l += nw) {
    float s = 0.f;
    for (int b = lane; b < n_blocks; b += 32)
      s += __ldcg(part + (size_t)b * ld + l);
    s = warp_sum(s);
    if (lane == 0) out[l] = s;
  }
}

}  // namespace
