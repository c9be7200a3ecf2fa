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
// Bound: memory.  The function reads X once: 4 m n d bytes, 1.64 GB at
// (m, n, d) = (50, 1000, 8192); everything else (the gradient partials, Z
// and the Weiszfeld passes) is O(m n + m d + k d).  Two routes, picked by
// d alone (round.linreg_route), each a front followed by the persistent
// round kernel of gmom_round.cuh, the means reading worker j's gradient
// from the chunk partials P (n_split, m, d) summed in a fixed order:
//   * one pass (d % 4 == 0, d <= kOnepassMaxD): a block per (sample chunk,
//     worker) owns all of d.  One thread of the block streams the chunk's
//     rows of X through a 3-stage shared-memory ring with 1-D TMA bulk
//     copies (cp.async.bulk + mbarrier).  A row group of tpr threads owns
//     a row: each thread dots its 16 columns with theta (kept in
//     registers), the group sums the dot by warp butterflies and warps in
//     order, and r = x.theta - y is added times the same 16 values, still
//     in registers, into the thread's gradient accumulators.  X is read
//     once.  2 kernels a round;
//   * two pass (other d): residual_kernel (a warp per row) writes R, then
//     grad_kernel (a thread per (worker, column) over a sample chunk) reads
//     X again.  3 kernels a round.
// Products that are added are explicit __fmaf_rn (round.linreg_round_blocked
// replays the arithmetic bit for bit).  No float atomics anywhere: bitwise
// identical run to run.
//
// Plain C interface for ctypes; returns the first CUDA error of the
// round's launches (0 on success).

#include "gmom_round.cuh"

namespace {

// --- the one-pass front ---------------------------------------------------

constexpr int kOnepassThreads = 512;
constexpr int kOnepassChunks = 4;  // float4 chunks of a row a thread owns
constexpr int kOnepassStages = 3;
constexpr int kOnepassStageBytes = 16384;
constexpr int kOnepassMaxD = 4 * kOnepassChunks * kOnepassThreads;  // 8192

// Threads that share a row: the least power of two from 32 up that holds
// d / 4 float4 chunks at kOnepassChunks each (round.onepass_row_threads).
int onepass_row_threads(int d) {
  const int need = (d / 4 + kOnepassChunks - 1) / kOnepassChunks;
  int tpr = 32;
  while (tpr < need) tpr *= 2;
  return tpr;
}

// Rows of X a ring stage holds: a whole number of row groups, about
// kOnepassStageBytes (round.onepass_rows_per_stage).
int onepass_rows_per_stage(int d, int groups) {
  const int fit = kOnepassStageBytes / (4 * d) / groups * groups;
  return fit > groups ? fit : groups;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D TMA: `bytes` (a multiple of 16) from global src to shared dst, both
// 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = __fmaf_rn(a.x, b.x, s);
  s = __fmaf_rn(a.y, b.y, s);
  s = __fmaf_rn(a.z, b.z, s);
  return __fmaf_rn(a.w, b.w, s);
}

__device__ __forceinline__ void axpy4(float4& acc, float4 x, float r) {
  acc.x = __fmaf_rn(x.x, r, acc.x);
  acc.y = __fmaf_rn(x.y, r, acc.y);
  acc.z = __fmaf_rn(x.z, r, acc.z);
  acc.w = __fmaf_rn(x.w, r, acc.w);
}

// P[q, j, :] = sum over the rows s of chunk q of worker j of
// (X[j, s] . theta - t[j, s]) X[j, s].  Grid (n_split, m); d % 4 == 0.
// Thread gt of row group g owns the float4 chunks gt + i tpr (i < 4) of
// every row g + groups i2 of the chunk; groups combine in order at the end.
__global__ void __launch_bounds__(kOnepassThreads)
linreg_onepass_kernel(const float* __restrict__ x,
                      const float* __restrict__ t,
                      const float* __restrict__ theta, int n, int d,
                      int chunk, int tpr, int rps, float* __restrict__ p) {
  extern __shared__ __align__(128) float ring[];  // [stages][rps][d]
  __shared__ __align__(8) unsigned long long full[kOnepassStages];
  __shared__ float red[2][kOnepassThreads / 32];
  const int q = blockIdx.x, j = blockIdx.y, m = gridDim.y;
  const int s0 = q * chunk, rows = min(n, s0 + chunk) - s0;
  const int tid = threadIdx.x, lane = tid & 31;
  const int groups = kOnepassThreads / tpr, g = tid / tpr, gt = tid % tpr;
  const int gw = tpr / 32;  // warps of a row group
  const int d4 = d / 4;
  const size_t stage_floats = (size_t)rps * d;
  const int n_stages = (rows + rps - 1) / rps;
  const float* xj = x + ((size_t)j * n + s0) * d;
  const float* tj = t + (size_t)j * n + s0;

  float4 th[kOnepassChunks], acc[kOnepassChunks];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kOnepassChunks; ++i) {
    const int c4 = gt + i * tpr;
    th[i] = c4 < d4 ? __ldg(reinterpret_cast<const float4*>(theta) + c4)
                    : zero;
    acc[i] = zero;
  }

  auto issue = [&](int st) {  // one thread: stage st of the chunk's rows
    const int nr = min(rps, rows - st * rps);
    const uint32_t bytes = (uint32_t)nr * d * 4;
    const uint32_t bar = smem_u32(&full[st % kOnepassStages]);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(ring + (st % kOnepassStages) * stage_floats),
              xj + (size_t)st * rps * d, bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kOnepassStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kOnepassStages && s < n_stages; ++s) issue(s);
  }
  __syncthreads();

  int step = 0;  // row-group steps so far: picks the half of `red`
  for (int st = 0; st < n_stages; ++st) {
    const int slot = st % kOnepassStages;
    mbar_wait(smem_u32(&full[slot]), (st / kOnepassStages) & 1);
    const float* xs = ring + slot * stage_floats;
    const int r0 = st * rps, nr = min(rps, rows - r0);
    for (int base = 0; base < nr; base += groups, ++step) {
      const int r = base + g;
      const bool live = r < nr;
      const float4* xr = reinterpret_cast<const float4*>(xs + (size_t)r * d);
      float4 xv[kOnepassChunks];
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kOnepassChunks; ++i) {
        const int c4 = gt + i * tpr;
        xv[i] = (live && c4 < d4) ? xr[c4] : zero;
        part = dot4(xv[i], th[i], part);
      }
      part = warp_sum(part);
      float* red_step = red[step & 1];
      if (lane == 0) red_step[tid >> 5] = part;
      __syncthreads();
      // the same sum in every thread of the group: warps in order
      float dot = 0.f;
      for (int w = 0; w < gw; ++w) dot += red_step[g * gw + w];
      if (live) {
        const float rs = dot - __ldg(tj + r0 + r);
#pragma unroll
        for (int i = 0; i < kOnepassChunks; ++i) axpy4(acc[i], xv[i], rs);
      }
    }
    // every thread read this stage before the last step's barrier
    if (tid == 0 && st + kOnepassStages < n_stages) issue(st + kOnepassStages);
  }

  float4* out = reinterpret_cast<float4*>(p + ((size_t)q * m + j) * d);
  if (groups == 1) {
#pragma unroll
    for (int i = 0; i < kOnepassChunks; ++i) {
      const int c4 = gt + i * tpr;
      if (c4 < d4) out[c4] = acc[i];
    }
    return;
  }
  // combine the row groups' accumulators in group order, through the ring
  // (every stage has been consumed)
  __syncthreads();
  float4* stash = reinterpret_cast<float4*>(ring);  // [groups][d4]
#pragma unroll
  for (int i = 0; i < kOnepassChunks; ++i) {
    const int c4 = gt + i * tpr;
    if (c4 < d4) stash[(size_t)g * d4 + c4] = acc[i];
  }
  __syncthreads();
  for (int c4 = tid; c4 < d4; c4 += kOnepassThreads) {
    float4 s = stash[c4];
    for (int gg = 1; gg < groups; ++gg) {
      const float4 v = stash[(size_t)gg * d4 + c4];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[c4] = s;
  }
}

// --- the two-pass front ---------------------------------------------------

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
  for (long long c = lane; c < d; c += 32) s = __fmaf_rn(xr[c], theta[c], s);
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
  for (int s = s0; s < s1; ++s) acc = __fmaf_rn(xj[(size_t)s * d], rj[s], acc);
  p[((size_t)q * m + j) * d + c] = acc;
}

// Worker j's gradient at column c: its chunk partials summed in order,
// times 1/n; v[u] for the kMemberBatch workers mem[u] (u < count), a
// chunk's loads for all of them in flight at once.
struct SplitGradRows {
  const float* p;
  int m, n_split;
  long long d;
  float inv_n;
  __device__ __forceinline__ void gather(const int (&mem)[kMemberBatch],
                                         int count, long long c,
                                         float (&v)[kMemberBatch]) const {
#pragma unroll
    for (int u = 0; u < kMemberBatch; ++u) v[u] = 0.f;
    for (int q = 0; q < n_split; ++q) {
      const float* pq = p + (size_t)q * m * d + c;
#pragma unroll
      for (int u = 0; u < kMemberBatch; ++u)
        if (u < count) v[u] += pq[(size_t)mem[u] * d];
    }
#pragma unroll
    for (int u = 0; u < kMemberBatch; ++u) v[u] = __fmul_rn(v[u], inv_n);
  }
};

}  // namespace

extern "C" {

int gmom_linreg_max_batches() { return kMaxBatches; }

// Columns of a tile of the persistent grid (round.TILE).
int gmom_linreg_tile() { return kTile; }

// Largest d of the one-pass route (round.D_ONEPASS).
int gmom_linreg_onepass_max_d() { return kOnepassMaxD; }

// Blocks of the round kernel that one SM holds at k batches, or minus a
// CUDA error.
int gmom_linreg_blocks_per_sm(int k) {
  if (k < 1 || k > kMaxBatches) return -(int)cudaErrorInvalidValue;
  return round_blocks_per_sm<SplitGradRows>(k);
}

// Enqueue one full linreg round on `stream`; no host synchronisation.
//   x (m, n, d), t (m, n), theta (d) f32; offsets (k+1) i32, members (m)
//   i32, bsz (k) f32; inv_n = f32(1/n); one_pass: the route (1 needs
//   d % 4 == 0, d <= gmom_linreg_onepass_max_d() and 16-byte aligned x,
//   theta); n_split sample chunks of ceil(n / n_split), none empty;
//   scratch: r (m, n) (two-pass route only, else NULL), p (n_split, m, d),
//   z, part as for gmom_round_aggregate; out: y (d) f32, iters (1)
//   i32 = executed Weiszfeld iterations.
int gmom_linreg_round(const void* x, const void* t, const void* theta,
                      const void* offsets, const void* members,
                      const void* bsz, int m, int n, int k, long long d,
                      int use_trim, float trim_multiplier, int max_iters,
                      float tol2, float eps, float eps2, float inv_n,
                      int one_pass, int n_split, void* r, void* p, void* z,
                      void* part, void* iters, void* y,
                      int n_blocks, void* stream) {
  if (k < 1 || k > kMaxBatches || m < 1 || m > 65535 || n < 1 || d < 1 ||
      n_split < 1 || n_split > n || n_split > 65535 || n_blocks < 1 ||
      max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunk = (n + n_split - 1) / n_split;
  if ((long long)(n_split - 1) * chunk >= n)  // an empty chunk
    return (int)cudaErrorInvalidValue;
  if (one_pass) {
    if (d % 4 != 0 || d > kOnepassMaxD ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(theta) |
         reinterpret_cast<uintptr_t>(p)) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int tpr = onepass_row_threads((int)d);
    const int rps = onepass_rows_per_stage((int)d, kOnepassThreads / tpr);
    const size_t smem = (size_t)kOnepassStages * rps * d * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        linreg_onepass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    linreg_onepass_kernel<<<dim3((unsigned)n_split, (unsigned)m),
                            kOnepassThreads, smem, st>>>(
        (const float*)x, (const float*)t, (const float*)theta, n, (int)d,
        chunk, tpr, rps, (float*)p);
  } else {
    const long long rows = (long long)m * n;
    residual_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                      st>>>((const float*)x, (const float*)t,
                            (const float*)theta, rows, d, (float*)r);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)m,
                    (unsigned)n_split);
    grad_kernel<<<grid, kThreads, 0, st>>>((const float*)x, (const float*)r,
                                           m, n, d, chunk, (float*)p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long dz = (d + kTile - 1) / kTile * kTile;
  const RoundArgs a{(const int*)offsets, (const int*)members,
                    (const float*)bsz, k, d, dz, use_trim, trim_multiplier,
                    max_iters, tol2, eps, eps2, (float*)z, (float*)part,
                    (float*)y, (int*)iters};
  return launch_round(SplitGradRows{(const float*)p, m, n_split, d, inv_n}, a,
                      n_blocks, st);
}

const char* gmom_linreg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
