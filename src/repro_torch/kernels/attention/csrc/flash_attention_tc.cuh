// Flash attention (forward) on Hopper's tensor cores: the bf16 route.
//
// Replaces, for bfloat16 inputs with head_dim % 8 == 0 and head_dim <= 256,
// the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/attention/flash.py, and computes what its oracle
// `flash_attention_ref` computes: q (B, Tq, H, hd), k and v (B, Tk, KV, hd)
// read in place, query head h reads kv head h / (H / KV), masks causal
// k <= q, window k > q - window and k < Tk (query row i at position
// q_offset + i: a sequence-parallel rank's block of a longer sequence;
// keys at their index), scores dot(q, k) * hd^-0.5, an
// online softmax in float32 with the finite -1e30 as the mask value, and
// the output acc / max(l, 1e-30) in bfloat16.  float32 (and bf16 of any
// other width) stays on the CUDA-core kernel of flash_attention.cu; the
// route is chosen in Python (`flash.route`), never here.
//
// What bounds it on this card: 4 * H * hd FLOP per live (q, k) pair against
// reading q, k, v and writing o once is far above the H100's 295 bf16
// operations per byte, so the bound is the dense bf16 tensor-core rate (989
// TFLOP/s, H100 SXM data sheet).  The design puts both products on `wgmma`
// and keeps every load off the compute warps:
//
// * block: one CTA per (128-row query tile, head, batch), 384 threads.
//   Warpgroups 0 and 1 consume (64 query rows each); warpgroup 2 produces:
//   one elected thread issues every TMA load.  `setmaxnreg` gives the
//   producer 24 registers a thread and the consumers 240.
// * loads: the Q tile once; K and V tiles of BK keys (BK = 128 for a padded
//   width D <= 128, 64 for D = 256) into a ring of STAGES = 2 stages, each
//   with a full and an empty mbarrier.  Tensor maps are 4-D over the
//   natural layout (hd, heads, T, B) with boxes of 64 columns (128 bytes,
//   128-byte swizzle): D / 64 boxes cover a row.  Columns >= hd and rows >= T
//   are out of bounds and TMA fills them with zeros, so QK^T is exact on
//   the padded width, O's padded columns are computed and never stored, and
//   query rows >= Tq are never stored.  TMA needs 16-byte strides: hd % 8
//   == 0.
// * S = Q K^T: wgmma.m64nBKk16.f32.bf16.bf16, both operands K-major in
//   shared memory, the f32 accumulator in registers.
// * softmax: scale (folded with log2 e for exp2), mask and the online
//   softmax run in f32 on the accumulator fragments; a row's max and sum
//   reduce over the 4 lanes of a quad.  The mask arithmetic runs only on
//   tiles that cross the diagonal, the window's lower edge or Tk; tiles
//   wholly above the diagonal or before the window are never loaded (the
//   CTA's range) or skipped (a warpgroup's range).
// * O += P V: P is rounded to bf16 in registers and fed as wgmma's
//   register A operand (the accumulator's fragment layout is the A
//   fragment's, so P never touches shared memory); V is the B operand from
//   shared memory, MN-major (hd contiguous), through the transpose bit.
//   l sums the unrounded f32 p, as the plain bf16 path (probabilities cast
//   to v's type before P V) and FlashAttention-2/3 do.
// * order: every output row is owned by one CTA, which walks its kv tiles
//   in one fixed order with no atomics, so two runs are bitwise equal.  The
//   longest query tiles (the last ones under the causal mask) launch
//   first, so the grid's tail is short.
// * masked rows: the sentinel is the finite -1e30, never -inf; a row whose
//   first tile lies wholly outside its window adds finite junk that the
//   first live tile wipes (alpha = exp2(-1e30 - m) = 0).
//
// Not here yet (later work): overlap of the softmax with the next tile's
// GEMM inside a warpgroup, ping-pong between the consumer warpgroups,
// persistent CTAs, fp8, a backward pass.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tc {

constexpr int BQ = 128;        // query rows per CTA: two warpgroups of 64
constexpr int THREADS = 384;   // consumers: warpgroups 0, 1; producer: 2
constexpr int STAGES = 2;      // K/V ring depth
constexpr float NEG = -1e30f;
constexpr int TMAP_ERROR = 1000;  // + CUresult of a failed tensor-map encode

// Shared memory of one CTA for the padded head width D (64, 128 or 256).
template <int D>
struct Tile {
  static constexpr int BK = D <= 128 ? 128 : 64;  // keys per kv tile
  static constexpr int NB = D / 64;               // 128-byte column blocks
  static constexpr int Q_BLOCK = BQ * 128;        // bytes of a Q column block
  static constexpr int KV_BLOCK = BK * 128;       // bytes of a K/V column block
  static constexpr int Q_BYTES = NB * Q_BLOCK;
  static constexpr int KV_BYTES = NB * KV_BLOCK;  // one K (or V) tile
  // 1024 bytes to align the tiles for the 128-byte swizzle, Q, the ring of
  // K and V, and the barriers (q_full, full[STAGES], empty[STAGES])
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

// ---------------------------------------------------------------------------
// PTX wrappers: shared addresses, mbarriers, TMA, setmaxnreg, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// spin until the barrier's phase differs from `parity`.  No timeout here:
// a clock64 watchdog in this loop makes the hd-256 instance spill
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

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads/writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands (Q,
// K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused.
// MN-major operand (V, hd contiguous): LBO = bytes between 64-column
// blocks, SBO = 1024 bytes between 8-key groups.
__device__ __forceinline__ uint64_t desc_field(uint32_t x) {
  return static_cast<uint64_t>((x & 0x3FFFF) >> 4);
}
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return desc_field(addr) | (desc_field(lbo) << 16) |
         (desc_field(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (m64 x N, f32) (+)= A (m64 x k16, shared, K-major) * B (k16 x N,
// shared, K-major); scale_d = 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D (m64 x N, f32) += A (m64 x k16, bf16 registers) * B (k16 x N, shared,
// MN-major: the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
      "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
      "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}


// ---------------------------------------------------------------------------
// the kernel

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o, int Tq, int Tk,
                             int H, int KV, int hd, int causal, int window,
                             int q_offset, float scale_log2) {
  using T = Tile<D>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;          // 1024-aligned tiles
  const uint32_t sKV = sQ + T::Q_BYTES;               // stage s: K then V
  const uint32_t bars = sKV + STAGES * 2 * T::KV_BYTES;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  // grid (H, B, q tiles): the last query tiles, the longest under the
  // causal mask, launch first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KV);
  const int q_last = min(q0 + BQ, Tq) - 1;
  // live kv tiles: below the diagonal of the last row, inside the window of
  // the first row (row r sits at position q_offset + r)
  const int kv_end = causal ? min(Tk, q_offset + q_last + 1) : Tk;
  const int kv_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every load --------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::NB; ++c)
        tma_load_4d(sQ + c * T::Q_BLOCK, &tm_q, q_full, c * 64, h, q0, b);
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::KV_BYTES);
        const uint32_t k_dst = sKV + s * 2 * T::KV_BYTES;
        const uint32_t v_dst = k_dst + T::KV_BYTES;
#pragma unroll
        for (int c = 0; c < T::NB; ++c) {
          tma_load_4d(k_dst + c * T::KV_BLOCK, &tm_k, full(s), c * 64, kvh,
                      t * BK, b);
          tma_load_4d(v_dst + c * T::KV_BLOCK, &tm_v, full(s), c * 64, kvh,
                      t * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup --------------------------
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int row0 = q0 + wg * 64;                   // warpgroup's first row
    const int r_lo = row0 + warp * 16 + (lane >> 2);  // rows r_lo, r_lo + 8
    const int pos0 = q_offset + row0;                // row0's position
    const uint32_t q_addr = sQ + wg * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int t = t_begin; t < t_end; ++t) {
      const int i = t - t_begin, s = i % STAGES;
      mbar_wait(full(s), (i / STAGES) & 1);
      const int k0 = t * BK;
      // a tile wholly above this warpgroup's diagonal or before its window
      // adds p = 0 with alpha = 1 (or junk the first live tile wipes)
      const bool skip = (causal && k0 > pos0 + 63) ||
                        (window > 0 && k0 + BK - 1 <= pos0 - window);
      if (!skip) {
        const uint32_t k_addr = sKV + s * 2 * T::KV_BYTES;
        const uint32_t v_addr = k_addr + T::KV_BYTES;

        // S = Q K^T over the padded width, 16 columns per instruction
        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk & 3) * 32;  // 16 columns in the block
          wgmma_ss<BK>(sc,
                       smem_desc(q_addr + (kk >> 2) * T::Q_BLOCK + col, 16,
                                 1024),
                       smem_desc(k_addr + (kk >> 2) * T::KV_BLOCK + col, 16,
                                 1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(sc);

        // scale (log2 units) and mask; fragment 4j + e holds row r_lo (e <
        // 2) or r_lo + 8, key k0 + 8j + 2 (lane % 4) + e % 2
        const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > pos0) ||
                          (window > 0 && k0 <= pos0 + 63 - window);
        if (edge) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qp = q_offset + r_lo + (e >> 1) * 8;
              const int kp = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
              bool live = kp < Tk;
              if (causal) live = live && kp <= qp;
              if (window > 0) live = live && kp > qp - window;
              sc[4 * j + e] = live ? sc[4 * j + e] * scale_log2 : NEG;
            }
        } else {
#pragma unroll
          for (int j = 0; j < BK / 2; ++j) sc[j] *= scale_log2;
        }

        // online softmax: row max over the quad, rescale, p = exp2(s - m)
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        // P in bf16 as wgmma's A fragments: for keys 16 kk.. 16 kk + 15 the
        // registers are (row, 2q..), (row + 8, 2q..), (row, 8 + 2q..),
        // (row + 8, 8 + 2q..), i.e. S fragments 8 kk .. 8 kk + 7 in order
        uint32_t pa[BK / 16][4];
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float p00 = exp2f(sc[4 * j] - mx0);
          const float p01 = exp2f(sc[4 * j + 1] - mx0);
          const float p10 = exp2f(sc[4 * j + 2] - mx1);
          const float p11 = exp2f(sc[4 * j + 3] - mx1);
          rs0 += p00 + p01;
          rs1 += p10 + p11;
          pa[j >> 1][(j & 1) * 2] = pack_bf16(p00, p01);
          pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p10, p11);
        }
        l0 = l0 * a0 + rs0;   // a thread's share of the row sum
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= a0;
          acc[4 * j + 1] *= a0;
          acc[4 * j + 2] *= a1;
          acc[4 * j + 3] *= a1;
        }

        // O += P V, 16 keys per instruction (2048 bytes of V)
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D>(acc, pa[kk],
                      smem_desc(v_addr + kk * 2048, T::KV_BLOCK, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

    // epilogue: the row sums over the quad, acc / max(l, 1e-30) in bf16,
    // rows < Tq and columns < hd only (hd % 8 == 0: a pair never straddles)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const long long qs = static_cast<long long>(H) * hd;
    __nv_bfloat16* ob = o + (static_cast<long long>(b) * Tq * H + h) * hd;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + 8 * half;
      if (r >= Tq) continue;
      const float den = half ? d1 : d0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        if (c < hd)
          *reinterpret_cast<__nv_bfloat162*>(ob + r * qs + c) =
              __floats2bfloat162_rn(acc[4 * j + 2 * half] / den,
                                    acc[4 * j + 2 * half + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps through the driver's entry point (no -lcuda), launch

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (hd, heads, T, B) bf16 in its natural layout; boxes of 64 columns x 1
// head x `rows` positions x 1 batch, 128-byte swizzle, zeros out of bounds
inline int encode_map(EncodeTiled enc, CUtensorMap* map, const void* base,
                      int hd, int heads, int T, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)T * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERROR + static_cast<int>(r);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int H, int KV, int hd, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return TMAP_ERROR + CUDA_ERROR_NOT_FOUND;
  CUtensorMap tq, tk, tv;
  int err = encode_map(enc, &tq, q, hd, H, Tq, B, BQ);
  if (err == 0) err = encode_map(enc, &tk, k, hd, KV, Tk, B, T::BK);
  if (err == 0) err = encode_map(enc, &tv, v, hd, KV, Tk, B, T::BK);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(H, B, (Tq + BQ - 1) / BQ);
  flash_attention_wgmma_kernel<D><<<grid, THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Tq, Tk, H, KV, hd, causal,
      window, q_offset, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// hd % 8 == 0, 8 <= hd <= 256, bf16 (checked by the caller); the padded
// width D is 64, 128 or 256
inline int forward(const void* q, const void* k, const void* v, void* o,
                   int B, int Tq, int Tk, int H, int KV, int hd, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  if (hd <= 64)
    return launch<64>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window,
                      q_offset, scale, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window,
                       q_offset, scale, stream);
  return launch<256>(q, k, v, o, B, Tq, Tk, H, KV, hd, causal, window,
                     q_offset, scale, stream);
}

}  // namespace flash_tc
