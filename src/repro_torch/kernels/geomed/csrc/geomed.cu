// The Weiszfeld kernels over the batch means Z (k, d), for Hopper
// (sm_90a):
//   sqdist:    s_l = ||z_l - y||^2                 -> (k,)
//   reweight:  y_new = sum_l w_l z_l               -> (d,)
//   the loop: ops.geometric_median_kernel's whole Weiszfeld loop, init to
//             the stop, in one launch               -> (d,), iterations
//
// Replaces the Pallas TPU kernels repro.kernels.geomed.geomed sqdist
// (_sqdist_kernel, which accumulates the (k,) sums in its output across a
// sequential d-tile grid) and reweight (_reweight_kernel, one (1, k) x
// (k, tile) product per d-tile), and the lax.while_loop over them in
// repro.kernels.geomed.ops.geometric_median_kernel.
//
// Bound: memory.  sqdist reads Z and y once (4 (k d + d) bytes), reweight
// reads Z once and writes y (4 (k d + d) bytes); each does 2-3 flops per
// element of Z.  The loop reads Z once for the init and once per
// iteration and writes y each pass.  Design:
//   * sqdist: one launch.  A thread owns column quads (float4 loads where
//     d % 4 == 0 and the rows are 16-byte aligned, else single columns)
//     on a grid stride and keeps the running sums of a chunk of up to
//     kSqdistRows rows in registers (larger k: the chunks in turn, in the
//     same launch).  The grid is the occupancy times the SMs, one wave;
//     the kernel is held to 40 registers, so an SM keeps 1536 threads and
//     their loads in flight.  Each block writes its (k,) partials; an
//     integer ticket picks the last block to finish, which reduces the
//     (n_blocks, k) buffer in reduce_partials' fixed order and resets the
//     ticket.  No float atomics: bitwise identical run to run;
//   * reweight: a thread owns columns and sums its k weighted values in
//     row order: no cross-thread sum at all;
//   * the loop, one cooperative launch, the stop (the NORM of the move <=
//     tol, the reference's rule) taken on the device with one grid
//     barrier per iteration; each pass fuses iteration t's reweight with
//     iteration t + 1's squared distances over one read of Z; it divides
//     after the sum, in the reference's order: y = (sum_l inv_l z_l) /
//     max(sum inv, eps); after each barrier every block reduces the
//     per-block partials (column k: the squared move) in reduce_partials'
//     order, so all stop together.  Two kernels, by k:
//       - weiszfeld_regs_kernel (k <= kRegsMaxK): sqdist's stream.  A
//         thread owns column quads (or columns) on a grid stride and holds
//         a unit's k values in registers: y_new, the previous y
//         (recomputed from the previous coefficients: the same bits, no
//         read of y), the move and the k squared distances come from
//         them, so Z is read once a pass at the card's stream rate.  161
//         registers: one block an SM, one wave;
//       - weiszfeld_tiles_kernel (larger k, whose columns do not fit in
//         registers): gmom_round.cuh's z_pass / publish with the caller's
//         weights in place of the trim and Z read in place (GivenZ).  A
//         block that owns one tile keeps it in shared memory for the
//         whole loop; one that owns more streams its tiles through the
//         3-stage cp.async ring and recomputes the previous y from them,
//         which keeps it at 80 registers, three blocks an SM.
//
// Plain C interface for ctypes; every function returns cudaGetLastError()
// checked after each launch (0 on success).

#include "gmom_round.cuh"

namespace {

constexpr int kSqdistRows = 16;      // rows a thread accumulates at once
constexpr int kSqdistMinBlocks = 6;  // 1536 threads an SM: 40 registers
constexpr int kRegsMaxK = 16;        // the register-streamed loop's k
constexpr int kTilesMinBlocks = 3;   // 80 registers, no spill (ptxas)

// the sums of squares of one row chunk (rows r0.., kc of them) of one
// block, fma-accumulated over the thread's units in grid-stride order
// (within a quad: .x, .y, .z, .w), then the block's fixed order
template <int kVec>
__device__ __forceinline__ void sqdist_chunk(const float* __restrict__ z,
                                             const float* __restrict__ y,
                                             int kc, long long d,
                                             float (*wsum)[kSqdistRows],
                                             float* dst) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long units = d / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  float acc[kSqdistRows];
#pragma unroll
  for (int l = 0; l < kSqdistRows; ++l) acc[l] = 0.f;
  for (long long u = (long long)blockIdx.x * kThreads + tid; u < units;
       u += stride) {
    if constexpr (kVec == 4) {
      const float4 yv = __ldg(reinterpret_cast<const float4*>(y) + u);
#pragma unroll
      for (int l = 0; l < kSqdistRows; ++l) {
        if (l < kc) {
          const float4 zv =
              __ldcs(reinterpret_cast<const float4*>(z + (size_t)l * d) + u);
          float e = zv.x - yv.x;
          acc[l] = __fmaf_rn(e, e, acc[l]);
          e = zv.y - yv.y;
          acc[l] = __fmaf_rn(e, e, acc[l]);
          e = zv.z - yv.z;
          acc[l] = __fmaf_rn(e, e, acc[l]);
          e = zv.w - yv.w;
          acc[l] = __fmaf_rn(e, e, acc[l]);
        }
      }
    } else {
      const float yv = __ldg(y + u);
#pragma unroll
      for (int l = 0; l < kSqdistRows; ++l) {
        if (l < kc) {
          const float e = __ldcs(z + (size_t)l * d + u) - yv;
          acc[l] = __fmaf_rn(e, e, acc[l]);
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kSqdistRows; ++l) {
    if (l < kc) {
      const float v = warp_sum(acc[l]);
      if (lane == 0) wsum[warp][l] = v;
    }
  }
  __syncthreads();
  if (tid < kc) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wsum[w][tid];
    dst[tid] = s;
  }
  __syncthreads();  // wsum is the next chunk's
}

// out[l] = ||z_l - y||^2 in one launch: every block writes its partials
// to part (n_blocks, k), the last one to arrive reduces them.
template <int kVec>
__global__ void __launch_bounds__(kThreads, kSqdistMinBlocks)
sqdist_kernel(const float* __restrict__ z, const float* __restrict__ y,
              int k, long long d, float* __restrict__ part,
              unsigned int* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float wsum[kWarps][kSqdistRows];
  __shared__ bool last;
  for (int r0 = 0; r0 < k; r0 += kSqdistRows)
    sqdist_chunk<kVec>(z + (size_t)r0 * d, y, min(kSqdistRows, k - r0), d,
                       wsum, part + (size_t)blockIdx.x * k + r0);
  // this block's partials are visible to the grid before its ticket
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  reduce_partials(part, gridDim.x, k, out);
  if (threadIdx.x == 0) *ticket = 0u;  // every block has taken its ticket
}

__global__ void __launch_bounds__(kThreads)
reweight_kernel(const float* __restrict__ z, const float* __restrict__ w,
                int k, long long d, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float s = 0.f;
    for (int l = 0; l < k; ++l) s += __ldg(w + l) * z[(size_t)l * d + j];
    out[j] = s;
  }
}

// cp.async of `bytes` (16 or 4) from src to shared dst, or zeros when
// `live` is false (src is then not read)
__device__ __forceinline__ void cp_async16_or_zero(float* dst,
                                                   const float* src,
                                                   bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_or_zero(float* dst,
                                                  const float* src,
                                                  bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// The tiles of the caller's Z (k, d), read in place: 16 B copies where the
// rows are 16-byte aligned (vec), else 4 B ones; the columns of the last
// tile past d are zero, as in the round kernel's padded copy.
struct GivenZ {
  static constexpr bool kRecomputeY = true;  // no read of y in a pass
  const float* z;
  long long d;
  int k;
  bool vec;
  __device__ __forceinline__ void load(float* dst, long long c0) const {
    if (vec) {
      constexpr int kChunks = kTile / 4;
      for (int i = threadIdx.x; i < k * kChunks; i += kThreads) {
        const int l = i / kChunks, c4 = i % kChunks;
        const long long c = c0 + 4 * c4;
        const bool live = c < d;
        cp_async16_or_zero(dst + l * kTile + 4 * c4,
                           z + (size_t)l * d + (live ? c : 0), live);
      }
    } else {
      for (int i = threadIdx.x; i < k * kTile; i += kThreads) {
        const int l = i / kTile, cc = i % kTile;
        const long long c = c0 + cc;
        const bool live = c < d;
        cp_async4_or_zero(dst + l * kTile + cc,
                          z + (size_t)l * d + (live ? c : 0), live);
      }
    }
  }
};

// ops.geometric_median_kernel's loop in one cooperative launch of n_blocks
// x kThreads: y0 = (w . Z) / max(sum w, 1e-12); then, until the norm of
// the move is <= tol or max_iters steps: inv_l = w_l / sqrt(s_l + eps^2),
// y = (sum_l inv_l z_l) / max(sum inv, eps).  Z's tiles through z_pass;
// a.y (d) is the result, a.part the partial halves, a.iters the steps
// taken; a's grouping, trim and z fields are unused.
__global__ void __launch_bounds__(kThreads, kTilesMinBlocks)
weiszfeld_tiles_kernel(GivenZ tiles, const float* __restrict__ w, float tol,
                 RoundArgs a) {
  extern __shared__ __align__(16) float slab[];  // [kSlabStages][k][kTile]
  // the coefficients and divisor of a pass, and of the pass before it (a
  // streaming block recomputes the previous y from them): the init's in
  // half 0, iteration t's in half (t + 1) % 2
  __shared__ float s_coef[2][kMaxBatches], s_div[2];
  __shared__ float s_tot[kMaxBatches + 1];
  __shared__ float s_y[kTile];
  __shared__ float s_wsum[kWarps][kMaxBatches];
  cg::grid_group grid = cg::this_grid();
  if (!grid.is_valid()) return;  // not a cooperative launch: no barrier
  const int tid = threadIdx.x, k = a.k, nb = gridDim.x;
  const long long n_tiles = (a.d + kTile - 1) / kTile;
  const int my_tiles =
      blockIdx.x < n_tiles ? (int)((n_tiles - 1 - blockIdx.x) / nb + 1) : 0;
  const bool resident = my_tiles == 1;
  auto part_half = [&](int h) { return a.part + (size_t)h * nb * (k + 1); };
  const float* s_w = s_coef[0];
  if (tid < k) s_coef[0][tid] = w != nullptr ? __ldg(w + tid) : 1.f;
  if (resident) {  // the block's one tile stays in stage 0 throughout
    tiles.load(slab, tile_start(0));
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  if (tid == 0) {
    float wsum = 0.f;
    for (int j = 0; j < k; ++j) wsum += s_w[j];
    s_div[0] = nan_max(wsum, 1e-12f);
  }
  __syncthreads();
  float acc[kRowsPerWarp], dacc, y_keep = 0.f;

  // weighted-mean init + squared distances for iteration 1
  z_pass<false>(a, tiles, slab, resident, my_tiles, s_w, s_div[0], nullptr,
                1.f, s_y, y_keep, acc, dacc, s_wsum,
                partial_row(part_half(1), s_tot, k));
  publish<false>(acc, resident, 0.f, k, part_half(1), s_tot, grid);

  // the weights stay in a register: iteration 1 overwrites half 0
  const float w_own = tid < k ? s_w[tid] : 0.f;
  int it = 0, h = 0;
  while (it < a.max_iters) {
    const int cur = (it + 1) & 1, prev = it & 1;
    if (tid < k)
      s_coef[cur][tid] = __fdiv_rn(w_own, __fsqrt_rn(s_tot[tid] + a.eps2));
    __syncthreads();
    if (tid == 0) {
      float inv_sum = 0.f;
      for (int j = 0; j < k; ++j) inv_sum += s_coef[cur][j];
      s_div[cur] = nan_max(inv_sum, a.eps);
    }
    __syncthreads();
    z_pass<true>(a, tiles, slab, resident, my_tiles, s_coef[cur], s_div[cur],
                 s_coef[prev], s_div[prev], s_y, y_keep, acc, dacc, s_wsum,
                 partial_row(part_half(h), s_tot, k));
    publish<true>(acc, resident, dacc, k, part_half(h), s_tot, grid);
    h ^= 1;
    ++it;
    if (!(__fsqrt_rn(s_tot[k]) > tol)) break;
  }
  if (blockIdx.x == 0 && tid == 0) *a.iters = it;
}

// One pass of the register-streamed loop over the block's units of kVec
// columns (u = blockIdx.x * kThreads + threadIdx.x + i * stride): per
// column, y_new = (sum_l coef_l z_l) / div; with has_prev the previous y
// the same way from coef_prev / div_prev, and dacc += (y_new - y)^2; then
// acc[l] += (z_l - y_new)^2; the columns of a unit in order.  y_new is
// stored to y.
template <int kVec>
__device__ __forceinline__ void regs_pass(const float* __restrict__ z, int k,
                                          long long d, const float* coef,
                                          float div, const float* coef_prev,
                                          float div_prev, bool has_prev,
                                          float* __restrict__ y,
                                          float (&acc)[kRegsMaxK],
                                          float& dacc) {
  const long long units = d / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
#pragma unroll
  for (int l = 0; l < kRegsMaxK; ++l) acc[l] = 0.f;
  dacc = 0.f;
  for (long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
       u < units; u += stride) {
    float zv[kRegsMaxK][kVec];  // every load of the unit in flight at once
#pragma unroll
    for (int l = 0; l < kRegsMaxK; ++l) {
      if (l < k) {
        if constexpr (kVec == 4) {
          const float4 v =
              __ldcs(reinterpret_cast<const float4*>(z + (size_t)l * d) + u);
          zv[l][0] = v.x;
          zv[l][1] = v.y;
          zv[l][2] = v.z;
          zv[l][3] = v.w;
        } else {
          zv[l][0] = __ldcs(z + (size_t)l * d + u);
        }
      }
    }
    float yo[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < kRegsMaxK; ++l)
        if (l < k) s = __fmaf_rn(coef[l], zv[l][j], s);
      const float yn = __fdiv_rn(s, div);
      if (has_prev) {
        float sp = 0.f;
#pragma unroll
        for (int l = 0; l < kRegsMaxK; ++l)
          if (l < k) sp = __fmaf_rn(coef_prev[l], zv[l][j], sp);
        const float mv = yn - __fdiv_rn(sp, div_prev);
        dacc = __fmaf_rn(mv, mv, dacc);
      }
#pragma unroll
      for (int l = 0; l < kRegsMaxK; ++l) {
        if (l < k) {
          const float e = zv[l][j] - yn;
          acc[l] = __fmaf_rn(e, e, acc[l]);
        }
      }
      yo[j] = yn;
    }
    if constexpr (kVec == 4)
      reinterpret_cast<float4*>(y)[u] =
          make_float4(yo[0], yo[1], yo[2], yo[3]);
    else
      y[u] = yo[0];
  }
}

// The block's partials of a pass, warp butterflies then warps in order, to
// row blockIdx.x of buf (n_blocks, k + 1) (column k: the move); then the
// grid barrier and every block's reduce_partials into tot.
__device__ __forceinline__ void regs_publish(const float (&acc)[kRegsMaxK],
                                             float dacc, int k, float* buf,
                                             float* tot,
                                             float (*wsum)[kRegsMaxK + 1],
                                             cg::grid_group& grid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < kRegsMaxK; ++l) {
    if (l < k) {
      const float v = warp_sum(acc[l]);
      if (lane == 0) wsum[warp][l] = v;
    }
  }
  const float dv = warp_sum(dacc);
  if (lane == 0) wsum[warp][k] = dv;
  __syncthreads();
  if (threadIdx.x <= k) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wsum[w][threadIdx.x];
    buf[(size_t)blockIdx.x * (k + 1) + threadIdx.x] = s;
  }
  grid.sync();
  reduce_partials(buf, gridDim.x, k + 1, tot, k + 1);
  __syncthreads();
}

// The loop for k <= kRegsMaxK, as weiszfeld_tiles_kernel computes it but in
// sqdist's stream: units of vec (4 or 1) columns; part (2, n_blocks,
// k + 1) the partial halves; y (d) the result; iters the steps taken.
__global__ void __launch_bounds__(kThreads, 1)
weiszfeld_regs_kernel(const float* __restrict__ z,
                      const float* __restrict__ w, int k, long long d,
                      int vec, int max_iters, float tol, float eps,
                      float eps2, float* __restrict__ part,
                      float* __restrict__ y, int* __restrict__ iters) {
  // the coefficients and divisor of a pass and of the pass before it: the
  // init's in half 0, iteration t's in half (t + 1) % 2
  __shared__ float s_coef[2][kRegsMaxK], s_div[2];
  __shared__ float s_tot[kRegsMaxK + 1];
  __shared__ float s_wsum[kWarps][kRegsMaxK + 1];
  cg::grid_group grid = cg::this_grid();
  if (!grid.is_valid()) return;  // not a cooperative launch: no barrier
  const int tid = threadIdx.x, nb = gridDim.x;
  auto part_half = [&](int h) { return part + (size_t)h * nb * (k + 1); };
  if (tid < k) s_coef[0][tid] = w != nullptr ? __ldg(w + tid) : 1.f;
  __syncthreads();
  if (tid == 0) {
    float wsum = 0.f;
    for (int j = 0; j < k; ++j) wsum += s_coef[0][j];
    s_div[0] = nan_max(wsum, 1e-12f);
  }
  __syncthreads();
  // the weights stay in a register: iteration 1 overwrites half 0
  const float w_own = tid < k ? s_coef[0][tid] : 0.f;
  float acc[kRegsMaxK], dacc;
  auto pass = [&](int cur, int prev, bool has_prev) {
    if (vec == 4)
      regs_pass<4>(z, k, d, s_coef[cur], s_div[cur], s_coef[prev],
                   s_div[prev], has_prev, y, acc, dacc);
    else
      regs_pass<1>(z, k, d, s_coef[cur], s_div[cur], s_coef[prev],
                   s_div[prev], has_prev, y, acc, dacc);
  };
  pass(0, 0, false);  // the weighted-mean init
  regs_publish(acc, dacc, k, part_half(1), s_tot, s_wsum, grid);
  int it = 0, h = 0;
  while (it < max_iters) {
    const int cur = (it + 1) & 1, prev = it & 1;
    if (tid < k)
      s_coef[cur][tid] = __fdiv_rn(w_own, __fsqrt_rn(s_tot[tid] + eps2));
    __syncthreads();
    if (tid == 0) {
      float inv_sum = 0.f;
      for (int j = 0; j < k; ++j) inv_sum += s_coef[cur][j];
      s_div[cur] = nan_max(inv_sum, eps);
    }
    __syncthreads();
    pass(cur, prev, true);
    regs_publish(acc, dacc, k, part_half(h), s_tot, s_wsum, grid);
    h ^= 1;
    ++it;
    if (!(__fsqrt_rn(s_tot[k]) > tol)) break;
  }
  if (blockIdx.x == 0 && tid == 0) *iters = it;
}

// Blocks of `fn` one SM holds with `smem` bytes of dynamic shared memory
// (allowed past the 48 KB default first), or minus a CUDA error.
template <class Fn>
int blocks_per_sm(Fn fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads,
                                                        smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

}  // namespace

extern "C" {

// Blocks of sqdist_kernel one SM holds for 16-byte (vec 4) or 4-byte
// (vec 1) loads, or minus a CUDA error.
int gmom_sqdist_blocks_per_sm(int vec) {
  if (vec == 4) return blocks_per_sm(sqdist_kernel<4>, 0);
  if (vec == 1) return blocks_per_sm(sqdist_kernel<1>, 0);
  return -(int)cudaErrorInvalidValue;
}

// Enqueue out[l] = ||z_l - y||^2 on `stream` as one launch.
//   z (k, d), y (d) f32; vec 4 (d % 4 == 0, z and y 16-byte aligned) or
//   1; scratch part (n_blocks, k) f32 and ticket (1) u32, zero before the
//   first launch and left zero by every launch; out (k) f32.  Launches on
//   one stream may share the scratch, launches on two may not.
int gmom_sqdist(const void* z, const void* y, int k, long long d, int vec,
                void* part, void* ticket, void* out, int n_blocks,
                void* stream) {
  if (k < 1 || d < 1 || n_blocks < 1 || (vec != 4 && vec != 1))
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (d % 4 != 0 || (reinterpret_cast<uintptr_t>(z) |
                                  reinterpret_cast<uintptr_t>(y)) %
                                     16 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec == 4)
    sqdist_kernel<4><<<n_blocks, kThreads, 0, st>>>(
        (const float*)z, (const float*)y, k, d, (float*)part,
        (unsigned int*)ticket, (float*)out);
  else
    sqdist_kernel<1><<<n_blocks, kThreads, 0, st>>>(
        (const float*)z, (const float*)y, k, d, (float*)part,
        (unsigned int*)ticket, (float*)out);
  return (int)cudaGetLastError();
}

// Enqueue out = sum_l w_l z_l on `stream`.
//   z (k, d), w (k) f32; out (d) f32.
int gmom_reweight(const void* z, const void* w, int k, long long d, void* out,
                  int n_blocks, void* stream) {
  if (k < 1 || d < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  reweight_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)w, k, d, (float*)out);
  return (int)cudaGetLastError();
}

// Largest k the Weiszfeld loop takes, its tile width, and the largest k
// of weiszfeld_regs_kernel (larger k runs weiszfeld_tiles_kernel).
int gmom_weiszfeld_max_batches() { return kMaxBatches; }

int gmom_weiszfeld_tile() { return kTile; }

int gmom_weiszfeld_regs_max_k() { return kRegsMaxK; }

// Blocks of the loop kernel for k points one SM holds, or minus a CUDA
// error.
int gmom_weiszfeld_blocks_per_sm(int k) {
  if (k < 1 || k > kMaxBatches) return -(int)cudaErrorInvalidValue;
  if (k <= kRegsMaxK) return blocks_per_sm(weiszfeld_regs_kernel, 0);
  return blocks_per_sm(weiszfeld_tiles_kernel, slab_bytes(k));
}

// Enqueue the whole Weiszfeld loop on `stream` as one cooperative launch
// of the loop kernel for k; no host synchronisation.
//   z (k, d) f32, read in place; vec: 16-byte units (d % 4 == 0, z and y
//   16-byte aligned), else single columns; w (k) f32 weights, or NULL for
//   unit weights; tol: stop when sqrt(squared move) <= tol; eps, eps2 =
//   f32(eps^2); scratch part (2, n_blocks, k + 1) f32; out: y (d) f32,
//   iters (1) i32 = the steps taken.  n_blocks must fit on the card at
//   once; for k > gmom_weiszfeld_regs_max_k() it may not exceed the tiles
//   of kTile columns.
int gmom_weiszfeld(const void* z, const void* w, int k, long long d, int vec,
                   int max_iters, float tol, float eps, float eps2,
                   void* part, void* iters, void* y, int n_blocks,
                   void* stream) {
  const long long n_tiles = (d + kTile - 1) / kTile;
  if (k < 1 || k > kMaxBatches || d < 1 || n_blocks < 1 || max_iters < 0 ||
      (k > kRegsMaxK && n_blocks > n_tiles))
    return (int)cudaErrorInvalidValue;
  if (vec && (d % 4 != 0 || (reinterpret_cast<uintptr_t>(z) |
                             reinterpret_cast<uintptr_t>(y)) %
                                16 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* zp = (const float*)z;
  const float* wp = (const float*)w;
  float* pp = (float*)part;
  float* yp = (float*)y;
  int* ip = (int*)iters;
  cudaError_t err;
  if (k <= kRegsMaxK) {
    int v = vec ? 4 : 1;
    void* args[] = {&zp, &wp, &k, &d, &v, &max_iters, &tol, &eps, &eps2,
                    &pp, &yp, &ip};
    err = cudaLaunchCooperativeKernel((const void*)weiszfeld_regs_kernel,
                                      dim3(n_blocks), dim3(kThreads), args,
                                      0, st);
  } else {
    const void* fn = (const void*)weiszfeld_tiles_kernel;
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)slab_bytes(k));
    if (err == cudaSuccess) {
      GivenZ tiles{zp, d, k, vec != 0};
      RoundArgs a{nullptr, nullptr, nullptr, k, d, d, 0, 0.f, max_iters,
                  0.f, eps, eps2, nullptr, pp, yp, ip};
      void* args[] = {&tiles, &wp, &tol, &a};
      err = cudaLaunchCooperativeKernel(fn, dim3(n_blocks), dim3(kThreads),
                                        args, slab_bytes(k), st);
    }
  }
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

const char* gmom_geomed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
