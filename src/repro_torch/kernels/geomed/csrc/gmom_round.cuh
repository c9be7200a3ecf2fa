// The GMoM round's stages on Hopper (sm_90a) as one persistent cooperative
// kernel, shared by the round kernels: per-worker gradient rows -> batch
// means Z (k, d) -> Remark-2 norm trim -> weighted-mean init -> early-exit
// Weiszfeld -> aggregate y (d,).
//
// The TPU design keeps the whole (k, d) mean block resident in VMEM; at
// the paper's m=50, k=11, d=1e4 that is 440 KB, more than one SM's 227 KB
// of shared memory.  Here the columns are cut into tiles of kTile, one
// column per thread, and tile t belongs to block t % n_blocks for every
// stage, so no block ever reads another block's columns of Z or y: the
// only data that crosses blocks are the per-block partial sums.
//
// Bound: memory at large d, latency below.  The tail reads Z once for the
// init and once per Weiszfeld iteration (about 4 k d (iters + 1) bytes)
// and reads and writes y per iteration; the arithmetic is a few flops per
// byte.  Design:
//   * one cooperative launch per round; the stages are separated by grid
//     barriers (cooperative_groups), so the host enqueues one kernel and
//     no empty iterations: the loop ends on the device when the squared
//     move is <= tol^2 or at max_iters;
//   * after each barrier EVERY block reduces the (n_blocks, k + 1)
//     partials itself (column k the squared move), in the fixed order of
//     reduce_partials, so every block holds bitwise the same trim weights,
//     coefficients and squared move and takes the same stop decision
//     without a flag: one grid barrier per Weiszfeld iteration; partial
//     buffers alternate between two halves so a block that runs ahead
//     never overwrites what a slower one reads.  A grid of one block
//     (d <= kTile) keeps its sums and its y on chip and needs no barrier;
//   * the (k, kTile) slab of Z of a tile sits in shared memory: a block
//     that owns one tile keeps it there from the means to the last
//     iteration (Z never touches device memory); a block that owns more
//     streams its tiles through a 3-stage cp.async ring (two tiles in
//     flight while it works on a third).  Threads keep only per-batch
//     accumulators (a warp owns batches l = w, w + 8, ...; 8 registers at
//     k = 64), never the k values of a column;
//   * a block's partial sum of a batch's squares: a block that owns one
//     tile squares its column in each thread, sums each warp's 32 columns
//     by the butterfly, then its warps in order (the order of a thread per
//     column: on chip_smoke.py's (50, 11, 100) input it reaches an exact
//     float32 fixed point, where the row order below settles into a 1-ulp
//     cycle and runs to max_iters); one that owns more gives each batch
//     to a warp whose lanes accumulate across the tiles, then the
//     butterfly;
//   * every product that is added is an explicit __fmaf_rn, every other
//     product, quotient and root an explicit _rn intrinsic, so the bits
//     follow from the source (round.round_aggregate_blocked replays them);
//   * no float atomics: bitwise identical run to run.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "gmom_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = kThreads;         // columns of a tile, one per thread
constexpr int kMaxBatches = 64;
constexpr int kRowsPerWarp = kMaxBatches / kWarps;  // batches a warp owns
constexpr int kSlabStages = 3;    // ring of Z tiles: two in flight
constexpr int kMemberBatch = 16;  // gradient loads a thread has in flight
// blocks an SM must hold: 128 registers a thread.  Three (80 registers)
// or four (64) spill 52-76 bytes (ptxas, sm_90a), so two it is
constexpr int kMinBlocks = 2;

// dynamic shared memory of the round kernel at k batches
__host__ __device__ constexpr size_t slab_bytes(int k) {
  return (size_t)kSlabStages * k * kTile * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// What one round needs besides the gradient rows.
//   offsets (k+1), members (m), bsz (k): the grouping as CSR member lists;
//   z (k, dz): device copy of Z for blocks that own more than one tile
//   (dz = d rounded up to whole tiles); part (2, n_blocks, k + 1): the
//   per-block partial sums in two halves, column k the squared move;
//   y (d); iters (1).
struct RoundArgs {
  const int* offsets;
  const int* members;
  const float* bsz;
  int k;
  long long d, dz;
  int use_trim;
  float trim_multiplier;
  int max_iters;
  float tol2, eps, eps2;
  float* z;
  float* part;
  float* y;
  int* iters;
};

// Worker j's gradient at column c, read from a stacked (m, d) block:
// v[u] = g[members[u], c] for the kMemberBatch members of a batch of loads
// (u < count), all issued before any is used.
struct StackedRows {
  const float* g;
  long long d;
  __device__ __forceinline__ void gather(const int (&mem)[kMemberBatch],
                                         int count, long long c,
                                         float (&v)[kMemberBatch]) const {
#pragma unroll
    for (int u = 0; u < kMemberBatch; ++u)
      v[u] = u < count ? g[(size_t)mem[u] * d + c] : 0.f;
  }
};

// Copy the (k, kTile) slab of the tile starting at c0 to Z in device
// memory (16 B a store).
__device__ __forceinline__ void store_tile(const float* src,
                                           const RoundArgs& a, long long c0) {
  constexpr int kChunks = kTile / 4;
  for (int i = threadIdx.x; i < a.k * kChunks; i += kThreads) {
    const int l = i / kChunks, c4 = i % kChunks;
    *reinterpret_cast<float4*>(a.z + (size_t)l * a.dz + c0 + 4 * c4) =
        *reinterpret_cast<const float4*>(src + l * kTile + 4 * c4);
  }
}

// Where z_pass reads the tiles of Z that a block does not keep resident:
// the round's own device copy (k, dz) of whole tiles.  load() stages the
// (k, kTile) slab whose first column is c0 (cp.async, 16 B a copy; a tile
// never runs past dz).  The Weiszfeld loop kernel (geomed.cu) reads the
// caller's Z through a loader of the same shape.
struct PaddedZ {
  static constexpr bool kRecomputeY = false;
  const float* z;
  long long dz;
  int k;
  __device__ __forceinline__ void load(float* dst, long long c0) const {
    constexpr int kChunks = kTile / 4;
    for (int i = threadIdx.x; i < k * kChunks; i += kThreads) {
      const int l = i / kChunks, c4 = i % kChunks;
      cp_async16(dst + l * kTile + 4 * c4, z + (size_t)l * dz + c0 + 4 * c4);
    }
  }
};

// acc[r] += sum over the tile's live columns c = lane, lane + 32, ... of
// (zs[l][c] - ys[c])^2 for the batches l = warp + r * kWarps (kCentered)
// or of zs[l][c]^2.
template <bool kCentered>
__device__ __forceinline__ void accumulate_rows(float (&acc)[kRowsPerWarp],
                                                const float* zs,
                                                const float* ys, int k,
                                                int len) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int l = warp + r * kWarps;
    if (l < k) {
      const float* row = zs + l * kTile;
#pragma unroll
      for (int q = 0; q < kTile / 32; ++q) {
        const int c = lane + 32 * q;
        if (c < len) {
          const float e = kCentered ? row[c] - ys[c] : row[c];
          acc[r] = __fmaf_rn(e, e, acc[r]);
        }
      }
    }
  }
}

// dst[l] = the sum over the tile's columns of (zs[l][c] - ys[c])^2
// (kCentered) or zs[l][c]^2, for a block that owns this one tile: thread
// c squares its column, the butterfly sums each warp's 32 columns, then
// the warps are added in order.  Dead columns hold 0 in zs and ys.
template <bool kCentered>
__device__ __forceinline__ void resident_partials(const float* zs,
                                                  const float* ys, int k,
                                                  float (*wsum)[kMaxBatches],
                                                  float* dst) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float yc = kCentered ? ys[tid] : 0.f;
  for (int l = 0; l < k; ++l) {
    const float e = zs[l * kTile + tid] - yc;
    const float v = warp_sum(__fmul_rn(e, e));
    if (lane == 0) wsum[warp][l] = v;
  }
  __syncthreads();
  if (tid < k) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wsum[w][tid];
    dst[tid] = s;
  }
}

// Tile i of this block starts at column (blockIdx.x + i n_blocks) kTile.
__device__ __forceinline__ long long tile_start(int i) {
  return ((long long)blockIdx.x + (long long)i * gridDim.x) * kTile;
}

// Where a block puts its partials of a stage: straight into tot when the
// grid is one block (the bits reduce_partials gives for one row, v + 0 =
// v), else row blockIdx.x of buf (n_blocks, k + 1).
__device__ __forceinline__ float* partial_row(float* buf, float* tot,
                                              int k) {
  return gridDim.x == 1 ? tot : buf + (size_t)blockIdx.x * (k + 1);
}

// Bring the grid's sums of this stage into tot in every block: tot[l]
// (l < k) the batch sums, tot[k] the squared move (kMove).  A block that
// streams its tiles adds its batch partials from acc here; a resident one
// has written them already (resident_partials).  Then, for more than one
// block, a grid barrier and reduce_partials over buf.
template <bool kMove>
__device__ __forceinline__ void publish(const float (&acc)[kRowsPerWarp],
                                        bool resident, float move, int k,
                                        float* buf, float* tot,
                                        cg::grid_group& grid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool one = gridDim.x == 1;
  float* dst = partial_row(buf, tot, k);
  if (!resident) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int l = warp + r * kWarps;
      if (l < k) {
        const float v = warp_sum(acc[r]);
        if (lane == 0) dst[l] = v;
      }
    }
  }
  if (kMove) {
    const float ds = block_sum_scalar(move);
    if (threadIdx.x == 0) dst[k] = ds;
  }
  if (one) {
    __syncthreads();
    return;
  }
  grid.sync();
  reduce_partials(buf, gridDim.x, kMove ? k + 1 : k, tot, k + 1);
  __syncthreads();
}

// One pass over the block's tiles of Z: y_new = (sum_l coef_l z_l) / div
// per column, its squared move (kHasPrev: into dacc), and the per-batch
// squared distances to y_new (a resident block: into dst; the others:
// into acc).  A resident block keeps its column's y in y_keep; the others
// read it back from device memory, or, where the source says so
// (Tiles::kRecomputeY), recompute it from the tile of Z in shared memory
// and the previous pass's coefficients coef_prev / div_prev: the same
// operations in the same order, so the same bits, and no read of y.
template <bool kHasPrev, class Tiles>
__device__ void z_pass(const RoundArgs& a, const Tiles& tiles, float* slab,
                       bool resident, int my_tiles, const float* coef,
                       float div, const float* coef_prev, float div_prev,
                       float* ys, float& y_keep, float (&acc)[kRowsPerWarp],
                       float& dacc, float (*wsum)[kMaxBatches], float* dst) {
  const int tid = threadIdx.x, k = a.k;
  const size_t stage = (size_t)k * kTile;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;
  dacc = 0.f;
  if (!resident) {  // tiles 0 and 1 in flight (a group may be empty)
    for (int i = 0; i < kSlabStages - 1; ++i) {
      if (i < my_tiles) tiles.load(slab + i * stage, tile_start(i));
      cp_async_commit();
    }
  }
  for (int i = 0; i < my_tiles; ++i) {
    const long long c0 = tile_start(i), c = c0 + tid;
    const bool live = c < a.d;
    float* zs = slab;
    float prev = y_keep;
    if (!resident) {
      if (kHasPrev && !Tiles::kRecomputeY && live)
        prev = a.y[c];  // in flight while Z arrives
      zs = slab + (i % kSlabStages) * stage;
      // the stage tile i + 2 goes to was last read in iteration i - 1
      const int ahead = i + kSlabStages - 1;
      if (ahead < my_tiles)
        tiles.load(slab + (ahead % kSlabStages) * stage, tile_start(ahead));
      cp_async_commit();
      cp_async_wait<kSlabStages - 1>();  // tile i has landed
      __syncthreads();
    }
    const int len = (int)min((long long)kTile, a.d - c0);
    float s = 0.f;
    for (int l = 0; l < k; ++l) s = __fmaf_rn(coef[l], zs[l * kTile + tid], s);
    const float yn = __fdiv_rn(s, div);
    if (kHasPrev && Tiles::kRecomputeY && !resident) {
      float sp = 0.f;
      for (int l = 0; l < k; ++l)
        sp = __fmaf_rn(coef_prev[l], zs[l * kTile + tid], sp);
      prev = __fdiv_rn(sp, div_prev);
    }
    if (live) {
      if (kHasPrev) {
        const float mv = yn - prev;
        dacc = __fmaf_rn(mv, mv, dacc);
      }
      a.y[c] = yn;
    }
    y_keep = yn;
    ys[tid] = yn;
    __syncthreads();
    if (resident)
      resident_partials<true>(zs, ys, k, wsum, dst);
    else
      accumulate_rows<true>(acc, zs, ys, k, len);
    __syncthreads();
  }
}

// The whole round in one cooperative launch of n_blocks x kThreads.
template <class Rows>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gmom_round_kernel(Rows rows, RoundArgs a) {
  extern __shared__ __align__(16) float slab[];  // [kSlabStages][k][kTile]
  __shared__ float s_w[kMaxBatches], s_coef[kMaxBatches];
  __shared__ float s_tot[kMaxBatches + 1], s_bsz[kMaxBatches];
  __shared__ int s_rank[kMaxBatches], s_off[kMaxBatches + 1];
  __shared__ float s_y[kTile];
  __shared__ float s_wsum[kWarps][kMaxBatches];
  __shared__ float s_div;
  cg::grid_group grid = cg::this_grid();
  if (!grid.is_valid()) return;  // not a cooperative launch: no barrier
  const int tid = threadIdx.x, k = a.k, nb = gridDim.x;
  const long long n_tiles = (a.d + kTile - 1) / kTile;
  const int my_tiles =
      blockIdx.x < n_tiles ? (int)((n_tiles - 1 - blockIdx.x) / nb + 1) : 0;
  const bool resident = my_tiles == 1;
  // the halves of the partial buffer (no local array: a runtime index
  // would put it on the stack)
  auto part_half = [&](int h) { return a.part + (size_t)h * nb * (k + 1); };
  if (tid <= k) s_off[tid] = __ldg(a.offsets + tid);
  if (tid < k) s_bsz[tid] = __ldg(a.bsz + tid);
  __syncthreads();
  float acc[kRowsPerWarp], dacc, y_keep = 0.f;

  // -- 1. batch means, and the squared-norm partials for the trim --------
  // each batch's members summed in order, kMemberBatch loads in flight
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;
  const int m_total = s_off[k];
  for (int i = 0; i < my_tiles; ++i) {
    const long long c0 = tile_start(i), c = c0 + tid;
    const bool live = c < a.d;
    int l = 0;
    float s = 0.f;
    for (int i0 = 0; i0 < m_total; i0 += kMemberBatch) {
      const int count = min(kMemberBatch, m_total - i0);
      int mem[kMemberBatch];
      float v[kMemberBatch];
#pragma unroll
      for (int u = 0; u < kMemberBatch; ++u)
        mem[u] = u < count ? __ldg(a.members + i0 + u) : 0;
      rows.gather(mem, live ? count : 0, c, v);
#pragma unroll
      for (int u = 0; u < kMemberBatch; ++u) {
        if (u < count) {
          s += v[u];
          if (i0 + u + 1 == s_off[l + 1]) {  // batch l is complete
            slab[l * kTile + tid] = live ? __fdiv_rn(s, s_bsz[l]) : 0.f;
            s = 0.f;
            ++l;
          }
        }
      }
    }
    __syncthreads();
    if (!resident) store_tile(slab, a, c0);
    if (a.use_trim) {
      if (resident)
        resident_partials<false>(slab, nullptr, k, s_wsum,
                                 partial_row(part_half(0), s_tot, k));
      else
        accumulate_rows<false>(acc, slab, nullptr, k,
                               (int)min((long long)kTile, a.d - c0));
    }
    __syncthreads();
  }
  if (a.use_trim)
    publish<false>(acc, resident, 0.f, k, part_half(0), s_tot, grid);

  // -- 2. Remark-2 trim weights, the same in every block ------------------
  // norms = sqrt(sum_j z^2); median by O(k^2) rank-select with ties broken
  // by index (even k: mean of the two middle order statistics);
  // w = norms <= c * median + 1e-12, all-ones if that keeps nothing.
  if (a.use_trim) {
    if (tid < k) s_tot[tid] = __fsqrt_rn(s_tot[tid]);
    __syncthreads();
    if (tid < k) {
      const float v = s_tot[tid];
      int rank = 0;
      for (int j = 0; j < k; ++j)
        rank += (s_tot[j] < v) || (s_tot[j] == v && j < tid);
      s_rank[tid] = rank;
    }
    __syncthreads();
    if (tid == 0) {
      float lo = 0.f, hi = 0.f;
      for (int j = 0; j < k; ++j) {
        if (s_rank[j] == (k - 1) / 2) lo = s_tot[j];
        if (s_rank[j] == k / 2) hi = s_tot[j];
      }
      const float med = (k & 1) ? hi : 0.5f * (lo + hi);
      const float tau = __fadd_rn(__fmul_rn(a.trim_multiplier, med), 1e-12f);
      float kept = 0.f;
      for (int j = 0; j < k; ++j) {
        s_w[j] = (s_tot[j] <= tau) ? 1.f : 0.f;
        kept += s_w[j];
      }
      if (!(kept > 0.f))
        for (int j = 0; j < k; ++j) s_w[j] = 1.f;
    }
  } else if (tid < k) {
    s_w[tid] = 1.f;
  }
  __syncthreads();
  if (tid == 0) {
    float wsum = 0.f;
    for (int j = 0; j < k; ++j) wsum += s_w[j];
    s_div = nan_max(wsum, a.eps);
  }
  __syncthreads();

  // -- 3. weighted-mean init + squared distances for iteration 1 ----------
  const PaddedZ tiles{a.z, a.dz, k};
  z_pass<false>(a, tiles, slab, resident, my_tiles, s_w, s_div, nullptr, 1.f,
                s_y, y_keep, acc, dacc, s_wsum,
                partial_row(part_half(1), s_tot, k));
  publish<false>(acc, resident, 0.f, k, part_half(1), s_tot, grid);

  // -- 4. early-exit Weiszfeld: one grid barrier per iteration ------------
  int it = 0, h = 0;
  while (it < a.max_iters) {
    // coefficients: dist_l = sqrt(sq_l + eps^2), inv = w / dist,
    // coef = inv / max(sum inv, eps)
    if (tid < k)
      s_coef[tid] = __fdiv_rn(s_w[tid], __fsqrt_rn(s_tot[tid] + a.eps2));
    __syncthreads();
    if (tid == 0) {
      float inv_sum = 0.f;
      for (int j = 0; j < k; ++j) inv_sum += s_coef[j];
      s_div = nan_max(inv_sum, a.eps);
    }
    __syncthreads();
    if (tid < k) s_coef[tid] = __fdiv_rn(s_coef[tid], s_div);
    __syncthreads();
    z_pass<true>(a, tiles, slab, resident, my_tiles, s_coef, 1.f, nullptr,
                 1.f, s_y, y_keep, acc, dacc, s_wsum,
                 partial_row(part_half(h), s_tot, k));
    publish<true>(acc, resident, dacc, k, part_half(h), s_tot, grid);
    h ^= 1;
    ++it;
    if (!(s_tot[k] > a.tol2)) break;
  }
  if (blockIdx.x == 0 && tid == 0) *a.iters = it;
}

// Blocks of gmom_round_kernel<Rows> one SM holds at k batches (> 0), or
// minus a CUDA error.
template <class Rows>
int round_blocks_per_sm(int k) {
  const void* fn = (const void*)gmom_round_kernel<Rows>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)slab_bytes(k));
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads,
                                                        slab_bytes(k));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// Enqueue the round on `st` as one cooperative launch.  A grid larger than
// the card can hold at once is refused by the launch (an error code, never
// a hang).
template <class Rows>
int launch_round(Rows rows, RoundArgs a, int n_blocks, cudaStream_t st) {
  const long long n_tiles = (a.d + kTile - 1) / kTile;
  if (a.k < 1 || a.k > kMaxBatches || a.d < 1 || a.dz < a.d ||
      a.dz % kTile != 0 || n_blocks < 1 || a.max_iters < 0 ||
      (a.z == nullptr && n_tiles > n_blocks))
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)gmom_round_kernel<Rows>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)slab_bytes(a.k));
  if (err == cudaSuccess) {
    void* args[] = {&rows, &a};
    err = cudaLaunchCooperativeKernel(fn, dim3(n_blocks), dim3(kThreads),
                                      args, slab_bytes(a.k), st);
  }
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace
