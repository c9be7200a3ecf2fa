// GMoM server round for Hopper (sm_90a): stacked worker gradients G (m, d)
// -> batch means Z (k, d) -> Remark-2 norm trim -> weighted-mean init ->
// early-exit Weiszfeld -> aggregate y (d,).
//
// Replaces the Pallas TPU kernel repro.kernels.geomed.round
// round_aggregate_kernel (src/repro/kernels/geomed/round.py, body
// _round_kernel with the tail _finish_round).  The TPU design keeps the
// whole (k, d) mean block resident in VMEM; at the paper's m=50, k=11,
// d=1e4 that is 440 KB, more than one SM's 227 KB of shared memory, so
// here Z lives in global memory (and in the 50 MB L2 when it fits).
//
// Bound: memory.  The round reads G once (4 m d bytes), writes Z once and
// reads it once per Weiszfeld iteration plus once for the init (about
// 4 k d (iters + 2) bytes), and reads and writes y per iteration; the
// arithmetic is a few flops per byte.  Design against that bound:
//   * one thread owns a column j (grid-stride over d) and keeps the k
//     values of its column in registers, so each pass reads Z once and
//     fuses everything that is per column: the update of iteration t, its
//     squared move, and the squared distances that iteration t+1 needs;
//   * cross-block sums never use float atomics: each block writes its
//     per-batch partials to a (n_blocks, k) buffer and a one-block kernel
//     reduces them in a fixed order, so results are bitwise identical run
//     to run (the reference's determinism rule);
//   * the early exit stays on the device: the host enqueues max_iters
//     iterations without syncing; a device flag `done` (squared move <=
//     tol^2) makes every later launch return at once, and the executed
//     iteration count is written to device memory.
//
// Plain C interface for ctypes; every function returns cudaGetLastError()
// checked after each launch (0 on success).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;          // grid kernels
constexpr int kReduceThreads = 1024;   // one-block kernels
constexpr int kWarps = kThreads / 32;

// layout of the small float state buffer
//   w[0:k]      trim weights
//   coef[k:2k]  Weiszfeld coefficients inv_l / denom of the current step
//   wsum[2k]    max(sum w, eps)
// layout of the int flags buffer: done[0], iters[1]

// jnp.maximum: NaN in `a` propagates (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : fmaxf(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
  // fixed butterfly order: deterministic
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

// One-block reduction of a (n_blocks, k) partial buffer into out[0:k]
// (shared memory).  Warp w sums columns l = w, w + 32, ...; lane i sums
// rows i, i + 32, ... in order, then a butterfly.  Fixed order.
__device__ void reduce_partials(const float* part, int n_blocks, int k,
                                float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int l = warp; l < k; l += nw) {
    float s = 0.f;
    for (int b = lane; b < n_blocks; b += 32) s += part[(size_t)b * k + l];
    s = warp_sum(s);
    if (lane == 0) out[l] = s;
  }
}

// --- stage 1: batch means (+ squared-norm partials for the trim) --------
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
means_kernel(const float* __restrict__ g, const int* __restrict__ offsets,
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
          s += g[(size_t)members[i] * d + j];
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

template <int KMAX>
int launch_round(const float* g, const int* offsets, const int* members,
                 const float* bsz, int k, long long d, int use_trim,
                 float trim_multiplier, int max_iters, float tol2, float eps,
                 float eps2, float* z, float* part, float* dpart,
                 float* state, int* flags, float* y, int n_blocks,
                 cudaStream_t st) {
  cudaError_t err;
#define CHECK_LAUNCH()                          \
  if ((err = cudaGetLastError()) != cudaSuccess) \
    return (int)err;
  means_kernel<KMAX><<<n_blocks, kThreads, 0, st>>>(g, offsets, members, bsz,
                                                   k, d, z, part, use_trim);
  CHECK_LAUNCH();
  trim_kernel<<<1, kReduceThreads, 0, st>>>(part, n_blocks, k, use_trim,
                                            trim_multiplier, eps, state);
  CHECK_LAUNCH();
  init_kernel<KMAX><<<n_blocks, kThreads, 0, st>>>(z, k, d, state, y, part);
  CHECK_LAUNCH();
  for (int it = 0; it < max_iters; ++it) {
    step_head_kernel<<<1, kReduceThreads, 0, st>>>(
        part, dpart, n_blocks, k, it > 0, 1, tol2, eps, eps2, state, flags);
    CHECK_LAUNCH();
    step_kernel<KMAX><<<n_blocks, kThreads, 0, st>>>(z, k, d, state, flags, y,
                                                    part, dpart);
    CHECK_LAUNCH();
  }
  if (max_iters > 0) {
    step_head_kernel<<<1, kReduceThreads, 0, st>>>(
        part, dpart, n_blocks, k, 1, 0, tol2, eps, eps2, state, flags);
    CHECK_LAUNCH();
  }
#undef CHECK_LAUNCH
  return 0;
}

}  // namespace

extern "C" {

// Largest number of batches the kernel takes (register-resident columns).
int gmom_round_max_batches() { return 64; }

// Enqueue one GMoM round on `stream`; no host synchronisation.
//   g (m, d) f32, offsets (k+1) i32, members (m) i32, bsz (k) f32;
//   scratch: z (k, d), part (n_blocks, k), dpart (n_blocks), state (2k+1)
//   f32; flags (2) i32 zeroed by the caller; out: y (d) f32, flags[1] =
//   executed Weiszfeld iterations.
int gmom_round_aggregate(const void* g, const void* offsets,
                         const void* members, const void* bsz, int k,
                         long long d, int use_trim, float trim_multiplier,
                         int max_iters, float tol2, float eps, float eps2,
                         void* z, void* part, void* dpart, void* state,
                         void* flags, void* y, int n_blocks, void* stream) {
  if (k < 1 || k > 64 || d < 1 || n_blocks < 1 || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto kmax_tag) {
    constexpr int KMAX = decltype(kmax_tag)::value;
    return launch_round<KMAX>(
        (const float*)g, (const int*)offsets, (const int*)members,
        (const float*)bsz, k, d, use_trim, trim_multiplier, max_iters, tol2,
        eps, eps2, (float*)z, (float*)part, (float*)dpart, (float*)state,
        (int*)flags, (float*)y, n_blocks, (cudaStream_t)stream);
  };
  if (k <= 16) return run(std::integral_constant<int, 16>{});
  if (k <= 32) return run(std::integral_constant<int, 32>{});
  return run(std::integral_constant<int, 64>{});
}

const char* gmom_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
