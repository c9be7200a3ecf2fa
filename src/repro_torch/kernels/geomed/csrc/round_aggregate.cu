// GMoM server round for Hopper (sm_90a): stacked worker gradients G (m, d)
// -> batch means Z (k, d) -> Remark-2 norm trim -> weighted-mean init ->
// early-exit Weiszfeld -> aggregate y (d,).
//
// Replaces the Pallas TPU kernel repro.kernels.geomed.round
// round_aggregate_kernel (src/repro/kernels/geomed/round.py, body
// _round_kernel with the tail _finish_round).  The stages and the design
// against the memory bound are in gmom_round.cuh, which the full linreg
// round (linreg_round.cu) shares.  The round reads G once (4 m d bytes)
// and Z once per Weiszfeld pass.
//
// Plain C interface for ctypes; every function returns cudaGetLastError()
// checked after each launch (0 on success).

#include "gmom_round.cuh"

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
  const cudaStream_t st = (cudaStream_t)stream;
  return dispatch_kmax(k, [&](auto kmax_tag) {
    constexpr int KMAX = decltype(kmax_tag)::value;
    const int rc = launch_means<KMAX>(
        StackedRows{(const float*)g, d}, (const int*)offsets,
        (const int*)members, (const float*)bsz, k, d, use_trim, (float*)z,
        (float*)part, n_blocks, st);
    if (rc != 0) return rc;
    return launch_tail<KMAX>(
        (const float*)z, k, d, use_trim, trim_multiplier, max_iters, tol2,
        eps, eps2, (float*)part, (float*)dpart, (float*)state, (int*)flags,
        (float*)y, n_blocks, st);
  });
}

const char* gmom_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
