// Flash attention (forward) for Hopper, sm_90a: the entry point and the
// CUDA-core route.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/attention/flash.py: causal and sliding-window GQA
// attention with an f32 online softmax.  q is (B, Tq, H, hd) and k, v are
// (B, Tk, KV, hd), float32 or bfloat16, read in place (no head-major copy,
// no padding); the output has q's layout and type.  Query head h reads kv
// head h / (H / KV).
//
// Two routes, chosen by the caller (`flash.route` in Python) and passed in
// as `route`; there is no fallback from one to the other:
// * 1, tensor cores: bf16 with hd % 8 == 0 and hd <= 256, the wgmma kernel
//   fed by TMA of flash_attention_tc.cuh;
// * 0, CUDA cores: float32, and bf16 of any other width, the kernel below.
//
// What bounds it on this card: the function is 4 * H * hd FLOP per live
// (q, k) pair against reading q, k, v and writing o once, far above the
// H100's 295 operations per byte, so it is bound by operations (989 TFLOP/s
// dense bf16 in the tensor cores, H100 SXM data sheet).  The CUDA-core
// kernel computes in float32 FMAs (67 TFLOP/s at most, same sheet), so it
// sits well above that bound; it stays for float32 because the reference
// computes in f32 throughout and TF32 would cut the f32 check's precision.
//
// The CUDA-core kernel's design:
// * one block of 256 threads per (64-row query tile, head, batch); the
//   block walks the kv tiles of 64 keys in order, so every output row is
//   owned by one block and summed in one fixed order (no atomics; two runs
//   are bitwise equal);
// * the query tile, the transposed key tile and the value tile are staged
//   in shared memory as float32; the probability tile reuses the key
//   tile's space once the scores are taken;
// * a thread owns 4 rows x 4 columns of the 64 x 64 score tile and 4 rows
//   x ceil(hd / 16) columns of the output accumulator (hd up to 256);
// * scores are dot(q, k) in float32, then times hd^-0.5, as the reference
//   scales after the dot; masks: causal k <= q, window k > q - window, and
//   k < Tk (the reference pads k/v with zeros and masks only by causality,
//   so it lets padded keys in when causal is false; here the edge is
//   masked);
// * the mask sentinel is the finite -1e30, never -inf: a row whose first
//   tile lies wholly outside its window then adds finite junk that the
//   first live tile wipes (alpha = exp(-1e30 - m) = 0), where -inf would
//   make exp(-inf - -inf) = NaN;
// * kv tiles wholly above the diagonal or wholly before every row's window
//   are skipped: they would add p = 0 with alpha = 1, so skipping is exact;
// * the output is acc / max(l, 1e-30), rounded once to the output type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention_tc.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 256;    // 16 x 16: thread (ty, tx)
constexpr int KSTR = BK + 1;    // row stride of the transposed key tile
constexpr int PSTR = BK + 16;   // row stride of the probability tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }

// floats of dynamic shared memory for head width hd and NJ column groups
__host__ __device__ inline int smem_floats(int hd, int nj) {
  return BQ * (hd + 1) + max_int(hd * KSTR, BQ * PSTR) + BK * nj * 16;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS, NJ <= 8 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Tq,
                       int Tk, int H, int KV, int hd, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  constexpr int DP = NJ * 16;  // padded width of the value tile
  const int QSTR = hd + 1;
  float* Qs = smem;                                  // BQ x QSTR
  float* Kt = Qs + BQ * QSTR;                        // hd x KSTR (keys^T)
  float* Ps = Kt;                                    // BQ x PSTR, after S
  float* Vs = Kt + max_int(hd * KSTR, BQ * PSTR);    // BK x DP

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int q1 = min(q0 + BQ, Tq);
  const long long qs = (long long)H * hd;   // stride of a query position
  const long long ks = (long long)KV * hd;  // stride of a key position
  const T* qb = q + ((long long)b * Tq * H + h) * hd;
  const T* kb = k + ((long long)b * Tk * KV + kvh) * hd;
  const T* vb = v + ((long long)b * Tk * KV + kvh) * hd;

  // the query tile: a warp per row, lanes over the head width
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int t = q0 + r;
    for (int d = lane; d < hd; d += 32)
      Qs[r * QSTR + d] = t < Tq ? to_f32(qb[t * qs + d]) : 0.f;
  }

  // live kv tiles: below the diagonal of the last row, inside the window of
  // the first row
  const int kv_end = causal ? min(Tk, q1) : Tk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int tile_end = (kv_end + BK - 1) / BK;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int tile = kv_begin / BK; tile < tile_end; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the last tile's P and V are consumed
    for (int r = warp; r < BK; r += THREADS / 32) {
      const int t = k0 + r;
      const bool live = t < Tk;
      for (int d = lane; d < hd; d += 32)
        Kt[d * KSTR + r] = live ? to_f32(kb[t * ks + d]) : 0.f;
      for (int d = lane; d < DP; d += 32)
        Vs[r * DP + d] = (live && d < hd) ? to_f32(vb[t * ks + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QSTR + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * KSTR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    __syncthreads();  // every thread is done with Kt before P overwrites it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool live = kp < Tk;
        if (causal) live = live && kp <= qp;
        if (window > 0) live = live && kp > qp - window;
        s[i][j] = live ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * PSTR + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PSTR + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = Vs[c * DP + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

  T* ob = o + ((long long)b * Tq * H + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < hd) store(&ob[t * qs + d], acc[i][jj] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Tq, int Tk, int H, int KV, int hd, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(hd, NJ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, NJ><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, Tk, H, KV, hd,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Tq, int Tk, int H, int KV, int hd,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 4>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window,
                        scale, stream);
  if (hd <= 128)
    return launch<T, 8>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window,
                        scale, stream);
  return launch<T, 16>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window,
                       scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  window <= 0: no sliding window.  route: 0
// the CUDA-core kernel, 1 the tensor-core kernel (bf16, hd % 8 == 0, hd <=
// 256, else cudaErrorInvalidValue).  The caller checks shapes (hd in [1,
// 256], H a multiple of KV, Tq, Tk >= 1, contiguous tensors, 16-byte
// aligned for route 1); the launch's error code is returned.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int dtype, int B, int Tq, int Tk, int H,
                            int KV, int hd, int causal, int window,
                            float scale, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || hd % 8 != 0 || hd < 8 || hd > 256)
      return (int)cudaErrorInvalidValue;
    return flash_tc::forward(q, k, v, o, B, Tq, Tk, H, KV, hd, causal,
                             window, scale, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal,
                                window, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, Tq, Tk, H, KV, hd,
                                        causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  if (err >= flash_tc::TMAP_ERROR)
    return "cuTensorMapEncodeTiled failed (CUresult = code - 1000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
