// GMoM server round for Hopper (sm_90a): stacked worker gradients G (m, d)
// -> batch means Z (k, d) -> Remark-2 norm trim -> weighted-mean init ->
// early-exit Weiszfeld -> aggregate y (d,), in ONE cooperative launch.
//
// Replaces the Pallas TPU kernel repro.kernels.geomed.round
// round_aggregate_kernel (src/repro/kernels/geomed/round.py, body
// _round_kernel with the tail _finish_round).  The persistent kernel and
// its design against the memory bound are in gmom_round.cuh, which the
// full linreg round (linreg_round.cu) shares.  The round reads G once
// (4 m d bytes) and, when a block owns more than one tile, Z once per
// Weiszfeld pass.
//
// Plain C interface for ctypes; every function returns the launch's CUDA
// error (0 on success).

#include "gmom_round.cuh"

extern "C" {

// Largest number of batches the kernel takes.
int gmom_round_max_batches() { return kMaxBatches; }

// Columns of a tile of the persistent grid (round.TILE).
int gmom_round_tile() { return kTile; }

// Blocks of the round kernel that one SM holds at k batches, or minus a
// CUDA error.
int gmom_round_blocks_per_sm(int k) {
  if (k < 1 || k > kMaxBatches) return -(int)cudaErrorInvalidValue;
  return round_blocks_per_sm<StackedRows>(k);
}

// Enqueue one GMoM round on `stream`; no host synchronisation.
//   g (m, d) f32, offsets (k+1) i32, members (m) i32, bsz (k) f32;
//   scratch: z (k, dz) f32 with dz = d rounded up to whole tiles (may be
//   NULL when n_blocks covers every tile), part (2, n_blocks, k + 1) f32;
//   out: y (d) f32, iters (1) i32 = executed Weiszfeld iterations.
//   n_blocks must fit on the card at once.
int gmom_round_aggregate(const void* g, const void* offsets,
                         const void* members, const void* bsz, int k,
                         long long d, int use_trim, float trim_multiplier,
                         int max_iters, float tol2, float eps, float eps2,
                         void* z, void* part, void* iters, void* y,
                         int n_blocks, void* stream) {
  const long long dz = (d + kTile - 1) / kTile * kTile;
  const RoundArgs a{(const int*)offsets, (const int*)members,
                    (const float*)bsz, k, d, dz, use_trim, trim_multiplier,
                    max_iters, tol2, eps, eps2, (float*)z, (float*)part,
                    (float*)y, (int*)iters};
  return launch_round(StackedRows{(const float*)g, d}, a, n_blocks,
                      (cudaStream_t)stream);
}

const char* gmom_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
