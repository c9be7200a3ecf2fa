// The GMoM round's stages on Hopper (sm_90a), shared by the round kernels:
// per-worker gradient rows -> batch means Z (k, d) -> Remark-2 norm trim ->
// weighted-mean init -> early-exit Weiszfeld -> aggregate y (d,).
//
// The TPU design keeps the whole (k, d) mean block resident in VMEM; at
// the paper's m=50, k=11, d=1e4 that is 440 KB, more than one SM's 227 KB
// of shared memory, so here Z lives in global memory (and in the 50 MB L2
// when it fits).
//
// Bound: memory.  The tail reads Z once for the init and once per
// Weiszfeld iteration (about 4 k d (iters + 1) bytes) and reads and writes
// y per iteration; the arithmetic is a few flops per byte.  Design against
// that bound:
//   * one thread owns a column j (grid-stride over d) and keeps the k
//     values of its column in registers, so each pass reads Z once and
//     fuses everything that is per column: the update of iteration t, its
//     squared move, and the squared distances that iteration t+1 needs;
//   * cross-block sums go through per-block partials reduced in a fixed
//     order (gmom_common.cuh): bitwise identical run to run;
//   * the early exit stays on the device: the host enqueues max_iters
//     iterations without syncing; a device flag `done` (squared move <=
//     tol^2) makes every later launch return at once, and the executed
//     iteration count is written to device memory.

#pragma once

#include <type_traits>

#include "gmom_common.cuh"

namespace {

// layout of the small float state buffer
//   w[0:k]      trim weights
//   coef[k:2k]  Weiszfeld coefficients inv_l / denom of the current step
//   wsum[2k]    max(sum w, eps)
// layout of the int flags buffer: done[0], iters[1]

// Worker j's gradient value at column c, read from a stacked (m, d) block.
struct StackedRows {
  const float* g;
  long long d;
  __device__ __forceinline__ float operator()(int j, long long c) const {
    return g[(size_t)j * d + c];
  }
};

// --- stage 1: batch means (+ squared-norm partials for the trim) --------
// One thread owns column j and walks the CSR member lists of every batch.
template <int KMAX, class Rows>
__global__ void __launch_bounds__(kThreads)
means_kernel(Rows rows, const int* __restrict__ offsets,
             const int* __restrict__ members, const float* __restrict__ bsz,
             int k, long long d, float* __restrict__ z,
             float* __restrict__ part, int want_norms) {
  float acc[KMAX];
#pragma unroll
  for (int l = 0; l < KMAX; ++l) acc[l] = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
#pragma unroll
    for (int l = 0; l < KMAX; ++l) {
      if (l < k) {
        float s = 0.f;
        for (int i = offsets[l]; i < offsets[l + 1]; ++i)
          s += rows(members[i], j);
        const float zl = s / bsz[l];
        z[(size_t)l * d + j] = zl;
        acc[l] += zl * zl;
      }
    }
  }
  if (want_norms) block_store_partials<KMAX>(acc, k, part);
}

// --- stage 2 (one block): Remark-2 trim weights ---------------------------
// norms = sqrt(sum_j z^2); median by O(k^2) rank-select with ties broken by
// index (even k: mean of the two middle order statistics);
// w = norms <= c * median + 1e-12, all-ones if that keeps nothing.
__global__ void trim_kernel(const float* __restrict__ part, int n_blocks,
                            int k, int use_trim, float trim_multiplier,
                            float eps, float* __restrict__ state) {
  __shared__ float sq[64];
  if (use_trim) reduce_partials(part, n_blocks, k, sq);
  __syncthreads();
  if (threadIdx.x != 0) return;
  float* w = state;
  if (use_trim) {
    float nrm[64];
    for (int l = 0; l < k; ++l) nrm[l] = sqrtf(sq[l]);
    float lo = 0.f, hi = 0.f;
    for (int i = 0; i < k; ++i) {
      int rank = 0;
      for (int j = 0; j < k; ++j)
        rank += (nrm[j] < nrm[i]) || (nrm[j] == nrm[i] && j < i);
      if (rank == (k - 1) / 2) lo = nrm[i];
      if (rank == k / 2) hi = nrm[i];
    }
    const float med = (k & 1) ? hi : 0.5f * (lo + hi);
    const float tau = trim_multiplier * med + 1e-12f;
    float kept = 0.f;
    for (int l = 0; l < k; ++l) {
      w[l] = (nrm[l] <= tau) ? 1.f : 0.f;
      kept += w[l];
    }
    if (!(kept > 0.f))
      for (int l = 0; l < k; ++l) w[l] = 1.f;
  } else {
    for (int l = 0; l < k; ++l) w[l] = 1.f;
  }
  float wsum = 0.f;
  for (int l = 0; l < k; ++l) wsum += w[l];
  state[2 * k] = nan_max(wsum, eps);
}

// --- stage 3: weighted-mean init + squared distances for iteration 1 -----
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
init_kernel(const float* __restrict__ z, int k, long long d,
            const float* __restrict__ state, float* __restrict__ y,
            float* __restrict__ part) {
  __shared__ float s_w[KMAX];
  __shared__ float s_wsum;
  if (threadIdx.x < k) s_w[threadIdx.x] = state[threadIdx.x];
  if (threadIdx.x == 0) s_wsum = state[2 * k];
  __syncthreads();
  float acc[KMAX];
#pragma unroll
  for (int l = 0; l < KMAX; ++l) acc[l] = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float zl[KMAX];
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < KMAX; ++l) {
      if (l < k) {
        zl[l] = z[(size_t)l * d + j];
        s += s_w[l] * zl[l];
      }
    }
    const float y0 = s / s_wsum;
    y[j] = y0;
#pragma unroll
    for (int l = 0; l < KMAX; ++l) {
      if (l < k) {
        const float e = zl[l] - y0;
        acc[l] += e * e;
      }
    }
  }
  block_store_partials<KMAX>(acc, k, part);
}

// --- stage 4a (one block): close the previous iteration, then the step's
// coefficients.  has_prev: reduce the previous squared move, count the
// iteration, set `done` when it is <= tol^2.  want_coef: dist_l =
// sqrt(sq_l + eps^2), inv = w / dist, coef = inv / max(sum inv, eps).
__global__ void step_head_kernel(const float* __restrict__ part,
                                 const float* __restrict__ dpart,
                                 int n_blocks, int k, int has_prev,
                                 int want_coef, float tol2, float eps,
                                 float eps2, float* __restrict__ state,
                                 int* __restrict__ flags) {
  __shared__ float sq[64];
  __shared__ int skip, stop;
  // read `done` once, before thread 0 may set it below: a uniform branch
  if (threadIdx.x == 0) skip = flags[0];
  __syncthreads();
  if (skip) return;
  if (has_prev) {
    if (threadIdx.x < 32) {
      float s = 0.f;
      for (int b = threadIdx.x; b < n_blocks; b += 32) s += dpart[b];
      s = warp_sum(s);
      if (threadIdx.x == 0) {
        flags[1] += 1;
        stop = !(s > tol2);
        if (stop) flags[0] = 1;
      }
    }
    __syncthreads();
    if (stop) return;
  }
  if (!want_coef) return;
  reduce_partials(part, n_blocks, k, sq);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float* w = state;
  float* coef = state + k;
  float inv_sum = 0.f;
  for (int l = 0; l < k; ++l) {
    coef[l] = w[l] / sqrtf(sq[l] + eps2);
    inv_sum += coef[l];
  }
  const float denom = nan_max(inv_sum, eps);
  for (int l = 0; l < k; ++l) coef[l] = coef[l] / denom;
}

// --- stage 4b: one Weiszfeld update, its squared move, and the squared
// distances for the next iteration, in one pass over Z -------------------
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
step_kernel(const float* __restrict__ z, int k, long long d,
            const float* __restrict__ state, const int* __restrict__ flags,
            float* __restrict__ y, float* __restrict__ part,
            float* __restrict__ dpart) {
  if (flags[0]) return;
  __shared__ float s_c[KMAX];
  if (threadIdx.x < k) s_c[threadIdx.x] = state[k + threadIdx.x];
  __syncthreads();
  float acc[KMAX];
#pragma unroll
  for (int l = 0; l < KMAX; ++l) acc[l] = 0.f;
  float dacc = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float zl[KMAX];
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < KMAX; ++l) {
      if (l < k) {
        zl[l] = z[(size_t)l * d + j];
        s += s_c[l] * zl[l];
      }
    }
    const float mv = s - y[j];
    dacc += mv * mv;
    y[j] = s;
#pragma unroll
    for (int l = 0; l < KMAX; ++l) {
      if (l < k) {
        const float e = zl[l] - s;
        acc[l] += e * e;
      }
    }
  }
  block_store_partials<KMAX>(acc, k, part);
  const float ds = block_sum_scalar(dacc);
  if (threadIdx.x == 0) dpart[blockIdx.x] = ds;
}

#define GMOM_CHECK_LAUNCH()                        \
  do {                                             \
    cudaError_t err_ = cudaGetLastError();         \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

// Enqueue the batch means of a round: `rows` gives worker j's value at a
// column; writes Z (k, d) and, when the trim is on, the norm partials.
template <int KMAX, class Rows>
int launch_means(Rows rows, const int* offsets, const int* members,
                 const float* bsz, int k, long long d, int use_trim,
                 float* z, float* part, int n_blocks, cudaStream_t st) {
  means_kernel<KMAX, Rows><<<n_blocks, kThreads, 0, st>>>(
      rows, offsets, members, bsz, k, d, z, part, use_trim);
  GMOM_CHECK_LAUNCH();
  return 0;
}

// Enqueue the tail that follows the means: trim, init, and max_iters
// Weiszfeld iterations that stop on the device flag.
template <int KMAX>
int launch_tail(const float* z, int k, long long d, int use_trim,
                float trim_multiplier, int max_iters, float tol2, float eps,
                float eps2, float* part, float* dpart, float* state,
                int* flags, float* y, int n_blocks, cudaStream_t st) {
  trim_kernel<<<1, kReduceThreads, 0, st>>>(part, n_blocks, k, use_trim,
                                            trim_multiplier, eps, state);
  GMOM_CHECK_LAUNCH();
  init_kernel<KMAX><<<n_blocks, kThreads, 0, st>>>(z, k, d, state, y, part);
  GMOM_CHECK_LAUNCH();
  for (int it = 0; it < max_iters; ++it) {
    step_head_kernel<<<1, kReduceThreads, 0, st>>>(
        part, dpart, n_blocks, k, it > 0, 1, tol2, eps, eps2, state, flags);
    GMOM_CHECK_LAUNCH();
    step_kernel<KMAX><<<n_blocks, kThreads, 0, st>>>(z, k, d, state, flags, y,
                                                    part, dpart);
    GMOM_CHECK_LAUNCH();
  }
  if (max_iters > 0) {
    step_head_kernel<<<1, kReduceThreads, 0, st>>>(
        part, dpart, n_blocks, k, 1, 0, tol2, eps, eps2, state, flags);
    GMOM_CHECK_LAUNCH();
  }
  return 0;
}

// Call fn(std::integral_constant<int, KMAX>) with the smallest register
// file (16, 32 or 64 batch means per column) that holds k.
template <class Fn>
int dispatch_kmax(int k, Fn&& fn) {
  if (k <= 16) return fn(std::integral_constant<int, 16>{});
  if (k <= 32) return fn(std::integral_constant<int, 32>{});
  return fn(std::integral_constant<int, 64>{});
}

}  // namespace
