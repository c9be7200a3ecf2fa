// The two passes of one Weiszfeld step over the batch means Z (k, d), for
// Hopper (sm_90a):
//   sqdist:   s_i = ||z_i - y||^2                  -> (k,)
//   reweight: y_new = sum_i w_i z_i                -> (d,)
//
// Replaces the Pallas TPU kernels repro.kernels.geomed.geomed sqdist
// (_sqdist_kernel, which accumulates the (k,) sums in its output across a
// sequential d-tile grid) and reweight (_reweight_kernel, one (1, k) x
// (k, tile) product per d-tile).
//
// Bound: memory.  sqdist reads Z and y once (4 (k d + d) bytes), reweight
// reads Z once and writes y (4 (k d + d) bytes); each does 2-3 flops per
// element of Z.  Design:
//   * sqdist: a thread owns columns (grid-stride over d) and keeps k
//     running sums in registers; each block writes its (k,) partials, and
//     a one-block kernel reduces them in a fixed order (gmom_common.cuh):
//     no float atomics, bitwise identical run to run.  Rows go in chunks
//     of 64 (the largest register file), so any k works;
//   * reweight: a thread owns columns and sums its k weighted values in
//     row order: no cross-thread sum at all.
//
// Plain C interface for ctypes; every function returns cudaGetLastError()
// checked after each launch (0 on success).

#include "gmom_common.cuh"

namespace {

constexpr int kRowChunk = 64;

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
sqdist_kernel(const float* __restrict__ z, const float* __restrict__ y,
              int k, long long d, float* __restrict__ part) {
  float acc[KMAX];
#pragma unroll
  for (int l = 0; l < KMAX; ++l) acc[l] = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const float yj = y[j];
#pragma unroll
    for (int l = 0; l < KMAX; ++l) {
      if (l < k) {
        const float e = z[(size_t)l * d + j] - yj;
        acc[l] += e * e;
      }
    }
  }
  block_store_partials<KMAX>(acc, k, part);
}

__global__ void sqdist_reduce_kernel(const float* __restrict__ part,
                                     int n_blocks, int k,
                                     float* __restrict__ out) {
  reduce_partials(part, n_blocks, k, out);
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

template <int KMAX>
int launch_sqdist_rows(const float* z, const float* y, int k, long long d,
                       float* part, float* out, int n_blocks,
                       cudaStream_t st) {
  sqdist_kernel<KMAX><<<n_blocks, kThreads, 0, st>>>(z, y, k, d, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sqdist_reduce_kernel<<<1, kReduceThreads, 0, st>>>(part, n_blocks, k, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueue out[i] = ||z_i - y||^2 on `stream`.
//   z (k, d), y (d) f32; scratch part (n_blocks, min(k, 64)) f32;
//   out (k) f32.
int gmom_sqdist(const void* z, const void* y, int k, long long d, void* part,
                void* out, int n_blocks, void* stream) {
  if (k < 1 || d < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  for (int r0 = 0; r0 < k; r0 += kRowChunk) {
    const int kc = k - r0 < kRowChunk ? k - r0 : kRowChunk;
    const float* zc = (const float*)z + (size_t)r0 * d;
    float* oc = (float*)out + r0;
    int rc;
    if (kc <= 16)
      rc = launch_sqdist_rows<16>(zc, (const float*)y, kc, d, (float*)part,
                                  oc, n_blocks, st);
    else if (kc <= 32)
      rc = launch_sqdist_rows<32>(zc, (const float*)y, kc, d, (float*)part,
                                  oc, n_blocks, st);
    else
      rc = launch_sqdist_rows<64>(zc, (const float*)y, kc, d, (float*)part,
                                  oc, n_blocks, st);
    if (rc != 0) return rc;
  }
  return 0;
}

// Enqueue out = sum_i w_i z_i on `stream`.
//   z (k, d), w (k) f32; out (d) f32.
int gmom_reweight(const void* z, const void* w, int k, long long d, void* out,
                  int n_blocks, void* stream) {
  if (k < 1 || d < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  reweight_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)w, k, d, (float*)out);
  return (int)cudaGetLastError();
}

int gmom_geomed_row_chunk() { return kRowChunk; }

const char* gmom_geomed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
