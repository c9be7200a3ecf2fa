// One whole failure-free round of Algorithm 2 on the linreg testbed, for
// Hopper (sm_90a): raw worker batches X (m, n, d), y (m, n) and the iterate
// theta (d,) -> residual R = X theta - y -> per-worker gradients
// (1/n) X_j^T R_j -> batch means -> Remark-2 trim -> early-exit Weiszfeld
// -> aggregate (d,).
//
// Replaces the Pallas TPU kernel repro.kernels.geomed.round
// linreg_round_kernel (src/repro/kernels/geomed/round.py, body
// _linreg_round_kernel: grid (2, d/256), phase 0 builds R, phase 1 the
// gradient tiles into the VMEM-resident means, then _finish_round).
//
// Bound: memory.  X is read twice (once for R, once for the gradients):
// 8 m n d bytes, 3.28 GB at (m, n, d) = (50, 1000, 8192); everything else
// (R, the gradient partials, Z and the Weiszfeld passes) is O(m n + m d +
// k d).  Design against that bound:
//   * residual: one warp per (worker, sample) row, lanes stride over d
//     (coalesced), a fixed butterfly per row: R needs no cross-block sum;
//   * gradients: a thread owns a column c of worker j and walks a chunk of
//     samples, so the loads of X[j, s, :] are coalesced on c for fixed
//     (j, s).  At small d the sample axis is split into n_split chunks to
//     fill the card; the chunk partials P (n_split, m, d) are summed in a
//     fixed order where the means read them (at (50, 1000, 8192) n_split
//     is 1 and P is the (m, d) gradient block, 1.6 MB);
//   * means, trim and Weiszfeld: the round kernel's stages
//     (gmom_round.cuh), the means reading worker j's gradient from P.
// No float atomics anywhere: bitwise identical run to run.
//
// Plain C interface for ctypes; returns cudaGetLastError() checked after
// each launch (0 on success).

#include "gmom_round.cuh"

namespace {

// R[row] = X[row, :] . theta - t[row] for the m n (worker, sample) rows.
__global__ void __launch_bounds__(kThreads)
residual_kernel(const float* __restrict__ x, const float* __restrict__ t,
                const float* __restrict__ theta, long long rows, long long d,
                float* __restrict__ r) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp
  const float* xr = x + (size_t)row * d;
  float s = 0.f;
#pragma unroll 4
  for (long long c = lane; c < d; c += 32) s += xr[c] * theta[c];
  s = warp_sum(s);
  if (lane == 0) r[row] = s - t[row];
}

// P[q, j, c] = sum over samples s of chunk q of X[j, s, c] R[j, s].
// Grid (ceil(d / kThreads), m, n_split).
__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ x, const float* __restrict__ r, int m,
            int n, long long d, int chunk, float* __restrict__ p) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  const int j = blockIdx.y, q = blockIdx.z;
  const int s0 = q * chunk, s1 = min(n, s0 + chunk);
  const float* xj = x + (size_t)j * n * d + c;
  const float* rj = r + (size_t)j * n;
  float acc = 0.f;
#pragma unroll 4
  for (int s = s0; s < s1; ++s) acc += xj[(size_t)s * d] * rj[s];
  p[((size_t)q * m + j) * d + c] = acc;
}

// Worker j's gradient at column c: its chunk partials summed in order,
// times 1/n.
struct SplitGradRows {
  const float* p;
  int m, n_split;
  long long d;
  float inv_n;
  __device__ __forceinline__ float operator()(int j, long long c) const {
    float s = 0.f;
    for (int q = 0; q < n_split; ++q) s += p[((size_t)q * m + j) * d + c];
    return s * inv_n;
  }
};

}  // namespace

extern "C" {

int gmom_linreg_max_batches() { return 64; }

// Enqueue one full linreg round on `stream`; no host synchronisation.
//   x (m, n, d), t (m, n), theta (d) f32; offsets (k+1) i32, members (m)
//   i32, bsz (k) f32; inv_n = f32(1/n);
//   scratch: r (m, n), p (n_split, m, d), z (k, d), part (n_blocks, k),
//   dpart (n_blocks), state (2k+1) f32; flags (2) i32 zeroed by the
//   caller; out: y (d) f32, flags[1] = executed Weiszfeld iterations.
int gmom_linreg_round(const void* x, const void* t, const void* theta,
                      const void* offsets, const void* members,
                      const void* bsz, int m, int n, int k, long long d,
                      int use_trim, float trim_multiplier, int max_iters,
                      float tol2, float eps, float eps2, float inv_n,
                      int n_split, void* r, void* p, void* z, void* part,
                      void* dpart, void* state, void* flags, void* y,
                      int n_blocks, void* stream) {
  if (k < 1 || k > 64 || m < 1 || m > 65535 || n < 1 || d < 1 ||
      n_split < 1 || n_split > n || n_split > 65535 || n_blocks < 1 ||
      max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)m * n;
  residual_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                    st>>>((const float*)x, (const float*)t,
                          (const float*)theta, rows, d, (float*)r);
  GMOM_CHECK_LAUNCH();
  const int chunk = (n + n_split - 1) / n_split;
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)m,
                  (unsigned)n_split);
  grad_kernel<<<grid, kThreads, 0, st>>>((const float*)x, (const float*)r, m,
                                         n, d, chunk, (float*)p);
  GMOM_CHECK_LAUNCH();
  const SplitGradRows rows_of{(const float*)p, m, n_split, d, inv_n};
  return dispatch_kmax(k, [&](auto kmax_tag) {
    constexpr int KMAX = decltype(kmax_tag)::value;
    const int rc = launch_means<KMAX>(
        rows_of, (const int*)offsets, (const int*)members, (const float*)bsz,
        k, d, use_trim, (float*)z, (float*)part, n_blocks, st);
    if (rc != 0) return rc;
    return launch_tail<KMAX>(
        (const float*)z, k, d, use_trim, trim_multiplier, max_iters, tol2,
        eps, eps2, (float*)part, (float*)dpart, (float*)state, (int*)flags,
        (float*)y, n_blocks, st);
  });
}

const char* gmom_linreg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
