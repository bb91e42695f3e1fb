// Blockwise online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (body _kernel, flash_attention.py:39-86), together
// with the GQA head expansion of src/repro/kernels/ops.py::flash_attention.
// It computes, per query row, softmax(mask(softcap(q k^T * scale))) v with the
// running max m, denominator l and an f32 accumulator, exactly the update of
// the Pallas kernel; the plain version is repro_torch/kernels/ref.py::
// flash_attention_ref.
//
// What bounds it on an H100: operations.  At gemma2-27b's prefill_32k shape
// one head does 4 * hd flops per (query, key) pair inside the band against
// 2 * hd bytes read per key row, far above the card's ratio of operations to
// bytes.  The input's type picks one of two kernels (a dispatch on the type,
// not a fallback):
//
// bf16: flash_attention_tc, on the tensor cores (989 TFLOP/s).
//   * S = Q K^T is wgmma m64n64k16 with both operands in shared memory: Q's
//     tile and the key tile (keys x hd) are K-major.  O += P V is wgmma
//     m64n{hd}k16 with P in registers: the f32 S fragment is rounded to bf16
//     in place (the accumulator and the register-A layouts line up), and V's
//     tile (keys x hd) is the MN-major B operand through the descriptor's
//     transpose bit, so V is never transposed in memory.
//   * Tiles arrive by TMA (cp.async.bulk.tensor, 4-D maps over the
//     (B, S, H | KV, hd) layout, 128-byte swizzle, or 64 / 32 at hd 32 / 16,
//     matching the wgmma descriptors), tracked by mbarriers.  One producer
//     warp loads the block's Q tiles once and streams K and V through a ring
//     of kStages stages; two consumer warpgroups (64 query rows each) run
//     wgmma and the softmax and release a stage when both are done with it.
//     TMA zero-fills rows past S (past Sk for K and V); the kernel still
//     masks keys >= Sk.
//   * The epilogue works on the S fragment in registers: scale, softcap,
//     masks (only on tiles that cross the diagonal, the window's edge or Sk),
//     row max and sum by shuffles among the 4 threads that share a row, and
//     the correction of the O accumulator.  log2(e) is folded into the scale
//     (or into the softcap's factor) and p = exp2f(s - m); NEG_INF stays
//     -1e30, so the masked arithmetic is the Pallas kernel's.
//   * The one new rounding: P is rounded to bf16 before P V (the reference
//     keeps p in f32).  Products of bf16 values are exact in f32, so Q K^T
//     differs from the reference only in the order of its sums; l is summed
//     from the f32 p, before rounding.  Each p carries a relative error of at
//     most 2^-9, so o moves by about 2^-9 of its row's scale, as much again
//     as the output's own rounding to bf16: held to 2^-7 of each row's norm.
//   * 288 threads per block.  At hd 128 one block per SM, so a thread may
//     hold O (64 floats), S (32) and P (16 words) in registers; at hd <= 64
//     two blocks per SM (at most 112 registers a thread, where ptxas spills
//     32 bytes at hd 64), so one block's softmax overlaps the other's wgmma.
//
// float32: flash_attention_tf32x3, on the tensor cores in 3xTF32 (495
//   TFLOP/s TF32, so 165 TFLOP/s of float32 work after three products).
//   Each product x y becomes x_hi y_hi + x_hi y_lo + x_lo y_hi with x_hi =
//   cvt.rna.tf32(x) and x_lo = cvt.rna.tf32(x - x_hi); the dropped x_lo y_lo
//   is about 2^-22 of x y, so the float32 contract (2e-5) holds where one
//   TF32 product (3 decimal digits) would break it.
//   * wgmma takes tf32 operands only K-major (PTX allows the transpose bits
//     for 16-bit types only).  Q K^T is K-major on both sides; for P V the
//     B operand must be V^T with keys contiguous.  So a pre-pass kernel
//     (split_kv), launched by the same wrapper call, writes K's hi and lo
//     planes in K's layout and V^T's as (B, KV, hd, Sp), Sk padded to 64
//     keys with zeros, into scratch the wrapper allocates.  V^T's keys are
//     permuted within each group of 8 (0, 2, 4, 6, 1, 3, 5, 7), so that the
//     S accumulator's fragment, which holds keys 2t and 2t + 1 of each 8,
//     is P's tf32 A fragment (k-indices t and t + 4) as it stands.
//   * Q arrives once by TMA in float32 (128-byte swizzle); each k-step's A
//     fragment is read from shared memory and split in registers, 4 k-steps
//     (32 registers) at a time: 9 warps a block leave a thread 168
//     registers, and 8 k-steps at a time spilled.  P is split in registers.
//     S = Q K^T is wgmma m64n{kBK}k8, O += P V m64n{hd}k8, three each per
//     k-step, into one float32 accumulator.
//   * Key tiles of 32 at hd 128 (64 at hd <= 64): a stage holds K_hi, K_lo,
//     V^T_hi, V^T_lo, 64 KB at hd 128; two stages and the two warpgroups' Q
//     tiles take 193 KB.  One block an SM at every head width: two at hd
//     <= 32 would leave a thread 96 registers, and spilled, and timed
//     slower.  At hd 64 and 32 ptxas spills 36 bytes; 32-key tiles there
//     spill nothing but timed slower.  TMA boxes are at most 128 bytes wide
//     under the 128-byte swizzle, so a 512-byte K row arrives as four
//     column chunks, and a V^T row of 64 keys as two.
//   * The rest is the bf16 kernel's: the producer warp, the ring, the
//     softmax on the accumulator fragment with exp2f, the masks on edge
//     tiles only.  p stays float32 (split, not rounded), so the softmax
//     is the reference's up to the order of sums.
//
// Both kernels:
//   * take Sk keys (Sk may differ from the S queries), with the Pallas
//     kernel's start-aligned masks: rel = q - k, keys >= Sk never attended;
//   * skip key tiles that lie wholly outside the causal band or the sliding
//     window (gemma2's 4096-wide window at S = 32768 reads 1/8 of the causal
//     band).  This leaves the result unchanged: in the Pallas kernel such a
//     tile gives a row only the transient p = 1 of a row whose m is still
//     NEG_INF, and the row's first valid tile wipes it exactly
//     (corr = exp(-1e30 - m) = 0 in f32);
//   * write 0 for a row with no valid key at all (a window with Sk < S, the
//     queries past the last key's window): its m is still NEG_INF at the
//     end, and its divisor is +inf (row_den).  That is the plain version's
//     and the jnp oracle's answer
//     (repro/kernels/ref.py); the Pallas kernel instead leaves the mean of
//     V over its padded key tiles there (p = 1 on every masked key);
//   * issue query tiles last-first, so the long causal rows start early;
//   * multiply by the scale (1/sqrt(hd), as the Pallas kernel does at :120;
//     the plain version divides by sqrt(hd)); apply the softcap
//     c * tanh(s / c) before the mask, with the accurate tanhf; mask padded
//     keys (k >= Sk), causal (q - k >= 0) and window (q - k < window);
//   * map query head h to KV head h / (H / KV) (the reference's jnp.repeat
//     along the head axis), indexed, not repeated;
//   * take (B, S, H, hd) / (B, Sk, KV, hd), contiguous, and write the output
//     in q's type and layout, with 64-bit element offsets.
// Build without --use_fast_math (tanhf, expf, exp2f stay accurate).  No
// -lcuda: the tensor maps are encoded through cuTensorMapEncodeTiled, reached
// with cudaGetDriverEntryPoint.
//
// The launcher is a plain C function: it launches on the caller's stream
// and returns cudaGetLastError() (0 on success).

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1.0e30f;  // the Pallas kernel's NEG_INF

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (wgmma + TMA)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kConsumers = 2;   // consumer warpgroups per block
constexpr int kRows = 64;       // query rows per consumer warpgroup
constexpr int kBQ = kRows * kConsumers;
constexpr int kBK = 64;         // keys per tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry for head width HD.  A tile row is split into
// chunks of W bytes, one swizzle span each (W = 128, or the whole row at
// hd 16 / 32); a tile of R rows is kChunks slabs of R x W bytes.
template <int HD>
struct Geo {
  static constexpr int W = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kChunks = HD * 2 / W;
  static constexpr int kChunkCols = W / 2;
  static constexpr int kQBytes = kRows * HD * 2;   // one warpgroup's Q tile
  static constexpr int kKVBytes = kBK * HD * 2;    // one K or V tile
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout = W == 128 ? 1 : (W == 64 ? 2 : 3);
  // + 1024 to align the base to the 128-byte swizzle's 1024-byte atom
  static constexpr size_t kSmem =
      1024 + kConsumers * kQBytes + kStages * 2 * kKVBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box {W/2 columns, 1 head, 64 rows, 1 batch} of a 4-D tensor map.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout; base offset 0 (every tile
// starts on a swizzle atom).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous region's fences.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S (64 x 64) (+)= A (64 x 16, shared) . B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// O (64 x 16) += A (64 x 16, registers) . B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 32) += A (64 x 16, registers) . B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 16) wgmma_rs_n16(d, a, b);
  if constexpr (HD == 32) wgmma_rs_n32(d, a, b);
  if constexpr (HD == 64) wgmma_rs_n64(d, a, b);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, b);
}

// A row's divisor: the Pallas kernel's l clamp; +inf for a row that met no
// valid key (its m is still NEG_INF), so that it gives 0 (signed: o / inf),
// as the plain version does.  One select a row, none an element.
__device__ __forceinline__ float row_den(float m, float l) {
  return m == kNegInf ? __int_as_float(0x7f800000) : fmaxf(l, 1e-30f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The S fragment in place: scores in log2 units (scaled, soft-capped), keys
// outside the mask at NEG_INF (EDGE tiles only), and each of the thread's two
// rows' maxima.  Fragment register i holds row a (bit 1 clear) or row b,
// key (i / 4) * 8 + cq + (i & 1) of the tile.
template <bool CAP, bool EDGE>
__device__ __forceinline__ void scores(float (&s)[kBK / 2], float mul,
                                       float cap_l2, int lim, int da, int cq,
                                       int causal, int window, float& mx_a,
                                       float& mx_b) {
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    float x = CAP ? cap_l2 * tanhf(s[i] * mul) : s[i] * mul;
    if (EDGE) {
      const int j = (i / 4) * 8 + cq + (i & 1);    // key - k0
      const int rel = da + ((i & 2) ? 8 : 0) - j;  // row - key
      bool ok = j < lim;
      if (causal) ok = ok && rel >= 0;
      if (window > 0) ok = ok && rel < window;
      x = ok ? x : kNegInf;
    }
    s[i] = x;
    if (i & 2)
      mx_b = fmaxf(mx_b, x);
    else
      mx_a = fmaxf(mx_a, x);
  }
}

// Grid (query tiles of kBQ rows, B * H).  Warps 0-7: two consumer
// warpgroups, rows [q0, q0 + 64) and [q0 + 64, q0 + 128); warp 8: producer.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_attention_tc(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ o, int64_t S, int64_t Sk,
                   int64_t H, int64_t KV, int causal, int window, float scale,
                   float softcap) {
  using G = Geo<HD>;
  extern __shared__ uint8_t smem_raw[];
  // full[kStages], empty[kStages], q
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  const uint32_t kv_smem = base + kConsumers * G::kQBytes;
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[kStages]);
  const uint32_t q_bar = smem_u32(&bars[2 * kStages]);

  const int64_t qt = static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t kvh = h / (H / KV);
  const int64_t q0 = qt * kBQ;

  // keys [k_lo, k_hi) hold every key valid for some row of this block
  // (none when k_lo >= k_hi: the rows past the last key's window)
  const int64_t q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  int64_t k_lo = 0, k_hi = Sk;
  if (causal && q_last + 1 < Sk) k_hi = q_last + 1;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  const int64_t kt_first = k_lo / kBK;
  const int64_t kt_end = (k_hi + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == 4 * kConsumers) {
    // producer: Q once, then K and V tile by tile through the ring
    if (lane == 0) {
      mbar_expect_tx(q_bar, kConsumers * G::kQBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < G::kChunks; ++c)
          tma_load(q_smem + w * G::kQBytes + c * kRows * G::W, &q_map, q_bar,
                   c * G::kChunkCols, static_cast<int>(h),
                   static_cast<int>(q0 + w * kRows), static_cast<int>(b));
      for (int64_t kt = kt_first; kt < kt_end; ++kt) {
        const int64_t t = kt - kt_first;
        const int s = static_cast<int>(t % kStages);
        const uint32_t use = static_cast<uint32_t>(t / kStages);
        mbar_wait(empty0 + 8 * s, (use & 1u) ^ 1u);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * G::kKVBytes);
        const uint32_t kd = kv_smem + 2 * s * G::kKVBytes;
        const uint32_t vd = kd + G::kKVBytes;
        for (int c = 0; c < G::kChunks; ++c) {
          tma_load(kd + c * kBK * G::W, &k_map, full, c * G::kChunkCols,
                   static_cast<int>(kvh), static_cast<int>(kt * kBK),
                   static_cast<int>(b));
          tma_load(vd + c * kBK * G::W, &v_map, full, c * G::kChunkCols,
                   static_cast<int>(kvh), static_cast<int>(kt * kBK),
                   static_cast<int>(b));
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: accumulator rows row_a (fragment registers with
  // bit 1 clear) and row_b = row_a + 8; columns 8 * n + cq + {0, 1}
  const int wg = warp / 4;
  const int64_t r0 = q0 + wg * kRows;
  const int64_t row_a = r0 + (warp % 4) * 16 + lane / 4;
  const int64_t row_b = row_a + 8;
  const int cq = 2 * (lane % 4);
  const uint32_t q_tile = q_smem + wg * G::kQBytes;
  const bool capped = softcap > 0.f;
  // scores in log2 units: cap_l2 * tanh(s * scale / c), or s * scale * log2e
  const float mul = capped ? scale / softcap : scale * kLog2e;
  const float cap_l2 = softcap * kLog2e;

  float o_acc[HD / 2];
  float s_acc[kBK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s_acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  mbar_wait(q_bar, 0);
  for (int64_t kt = kt_first; kt < kt_end; ++kt) {
    const int64_t t = kt - kt_first;
    const int s = static_cast<int>(t % kStages);
    mbar_wait(full0 + 8 * s, static_cast<uint32_t>(t / kStages) & 1u);
    const int64_t k0 = kt * kBK;
    // whole tile outside this warpgroup's band (or rows past S): skip
    const bool skip = r0 >= S || (causal && k0 > r0 + kRows - 1) ||
                      (window > 0 && r0 - (k0 + kBK - 1) >= window);
    if (!skip) {
      const uint32_t kd = kv_smem + 2 * s * G::kKVBytes;
      const uint32_t vd = kd + G::kKVBytes;

      // S = Q K^T
      fence_regs(s_acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int c = ks * 16 / G::kChunkCols;
        const uint32_t off = (ks * 16 % G::kChunkCols) * 2;
        const uint64_t desc_q = make_desc(q_tile + c * kRows * G::W + off,
                                          16, 8 * G::W, G::kLayout);
        const uint64_t desc_k = make_desc(kd + c * kBK * G::W + off, 16,
                                          8 * G::W, G::kLayout);
        wgmma_ss_n64(s_acc, desc_q, desc_k, ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s_acc);

      // scale, softcap, mask (on edge tiles only), row max
      const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > r0) ||
                        (window > 0 && r0 + kRows - 1 - k0 >= window);
      const int lim = static_cast<int>(Sk - k0 < kBK ? Sk - k0 : kBK);
      const int da = static_cast<int>(row_a - k0);  // row - tile's first key
      float mx_a = kNegInf, mx_b = kNegInf;
      if (capped) {
        if (edge)
          scores<true, true>(s_acc, mul, cap_l2, lim, da, cq, causal, window,
                             mx_a, mx_b);
        else
          scores<true, false>(s_acc, mul, cap_l2, lim, da, cq, causal,
                              window, mx_a, mx_b);
      } else {
        if (edge)
          scores<false, true>(s_acc, mul, cap_l2, lim, da, cq, causal,
                              window, mx_a, mx_b);
        else
          scores<false, false>(s_acc, mul, cap_l2, lim, da, cq, causal,
                               window, mx_a, mx_b);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;

      // p in f32 for l, rounded to bf16 pairs as P V's A fragment
      uint32_t p[kBK / 4];
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) {
        const float mn = (j & 1) ? mn_b : mn_a;
        const float p0 = exp2f(s_acc[2 * j] - mn);
        const float p1 = exp2f(s_acc[2 * j + 1] - mn);
        if (j & 1)
          ps_b += p0 + p1;
        else
          ps_a += p0 + p1;
        p[j] = pack_bf16(p0, p1);
      }
      l_a = l_a * corr_a + ps_a;
      l_b = l_b * corr_b + ps_b;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o_acc[i] *= (i & 2) ? corr_b : corr_a;

      // O += P V
      fence_regs(o_acc);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_pv<HD>(o_acc, a,
                     make_desc(vd + kk * 16 * G::W, kBK * G::W, 8 * G::W,
                               G::kLayout));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o_acc);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // l: the four threads of a row hold partial sums
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = row_den(m_a, l_a), den_b = row_den(m_b, l_b);
  const int64_t q_row = H * HD;
  __nv_bfloat16* ob = o + b * S * q_row + h * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = 8 * n + cq;
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_a * q_row + col) =
          __floats2bfloat162_rn(o_acc[4 * n] / den_a,
                                o_acc[4 * n + 1] / den_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_b * q_row + col) =
          __floats2bfloat162_rn(o_acc[4 * n + 2] / den_b,
                                o_acc[4 * n + 3] / den_b);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// 4-D map over a contiguous bf16 (B, S, heads, hd) tensor, innermost first;
// box = {W/2 columns, 1 head, 64 rows, 1 batch}, zero fill out of bounds.
template <int HD>
int make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
             int64_t heads) {
  using G = Geo<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      HD * 2, static_cast<cuuint64_t>(heads * HD * 2),
      static_cast<cuuint64_t>(S * heads * HD * 2)};
  const cuuint32_t box[4] = {G::kChunkCols, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      G::W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : (G::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t S, int64_t Sk, int64_t H, int64_t KV, int64_t causal,
           int64_t window, float scale, float softcap, cudaStream_t stream) {
  // TMA coordinates are 32-bit
  if (S > 2147483647LL - kBQ || Sk > 2147483647LL - kBQ || B * H > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  int err = make_map<HD>(&q_map, q, B, S, H);
  if (err == cudaSuccess) err = make_map<HD>(&k_map, k, B, Sk, KV);
  if (err == cudaSuccess) err = make_map<HD>(&v_map, v, B, Sk, KV);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Geo<HD>::kSmem;
  err = cudaFuncSetAttribute(flash_attention_tc<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * H));
  // q - k <= S - 1 for every query and key, whatever Sk: a window wider
  // than S masks nothing
  const int win = window > 0 ? static_cast<int>(window < S ? window : S) : 0;
  flash_attention_tc<HD><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), S, Sk, H, KV,
      static_cast<int>(causal), win, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: tensor-core kernel in 3xTF32 (wgmma + TMA)
// ---------------------------------------------------------------------------

namespace tc32 {

using tc::fence_regs;
using tc::kConsumers;
using tc::kLog2e;
using tc::kRows;
using tc::kThreads;
using tc::make_desc;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::row_den;
using tc::smem_u32;
using tc::tma_load;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait_all;

constexpr int kBQ = kRows * kConsumers;
constexpr int kStages = 2;    // K/V ring depth
constexpr int kKeyPad = 64;   // the split V^T's key axis is padded to this

// Geometry for head width HD.  A Q or K row of HD floats arrives as chunks
// of W bytes, one swizzle span each (W = 128, or 64 at hd 16); a V^T row
// (one head-dim column, keys along it) as chunks of 128 bytes (32 keys).
// A stage holds four tiles: K_hi, K_lo (kBK keys x HD), V^T_hi, V^T_lo
// (HD x kBK keys).
template <int HD>
struct Geo {
  // keys per tile: 32 at hd 128, where two stages of 64 would not fit
  // beside the Q tiles; 64 below (32 there timed slower, PERF.md)
  static constexpr int kBK = HD == 128 ? 32 : 64;
  static constexpr int W = HD * 4 < 128 ? HD * 4 : 128;
  static constexpr int kChunks = HD * 4 / W;
  static constexpr int kChunkCols = W / 4;
  static constexpr int kVChunks = kBK / 32;
  static constexpr int kQBytes = kRows * HD * 4;  // one warpgroup's Q tile
  static constexpr int kTileBytes = kBK * HD * 4;  // one of a stage's tiles
  // wgmma descriptor layout of the K tiles: 1 = 128-byte swizzle, 2 = 64
  // (Q's tiles, read by the threads, are swizzled alike)
  static constexpr uint64_t kLayout = W == 128 ? 1 : 2;
  // XOR mask of the swizzle on address bits 7.. (into bits 4..)
  static constexpr uint32_t kSwizzle = W == 128 ? 7 : 3;
  // k-steps (8 columns) of Q . K^T whose Q fragments (8 registers each)
  // are in registers at once
  static constexpr int kBatch = HD / 8 < 4 ? HD / 8 : 4;
  // + 1024 to align the base to the 128-byte swizzle's 1024-byte atom
  static constexpr size_t kSmem =
      1024 + kConsumers * kQBytes + kStages * 4 * kTileBytes;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32 (lo rounded too: the tensor core takes tf32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// D (64 x 16) (+)= A (64 x 8, registers, tf32) . B (8 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_n16(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D (64 x 32) (+)= A (64 x 8, registers, tf32) . B (8 x 32, shared, K-major)
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D (64 x 64) (+)= A (64 x 8, registers, tf32) . B (8 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D (64 x 128) (+)= A (64 x 8, registers, tf32) . B (8 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int accumulate) {
  if constexpr (N == 16) wgmma_n16(d, a, b, accumulate);
  if constexpr (N == 32) wgmma_n32(d, a, b, accumulate);
  if constexpr (N == 64) wgmma_n64(d, a, b, accumulate);
  if constexpr (N == 128) wgmma_n128(d, a, b, accumulate);
}

// The S fragment in place, as tc::scores, for tiles of KB keys.
template <int KB, bool CAP, bool EDGE>
__device__ __forceinline__ void scores(float (&s)[KB / 2], float mul,
                                       float cap_l2, int lim, int da, int cq,
                                       int causal, int window, float& mx_a,
                                       float& mx_b) {
#pragma unroll
  for (int i = 0; i < KB / 2; ++i) {
    float x = CAP ? cap_l2 * tanhf(s[i] * mul) : s[i] * mul;
    if (EDGE) {
      const int j = (i / 4) * 8 + cq + (i & 1);    // key - k0
      const int rel = da + ((i & 2) ? 8 : 0) - j;  // row - key
      bool ok = j < lim;
      if (causal) ok = ok && rel >= 0;
      if (window > 0) ok = ok && rel < window;
      x = ok ? x : kNegInf;
    }
    s[i] = x;
    if (i & 2)
      mx_b = fmaxf(mx_b, x);
    else
      mx_a = fmaxf(mx_a, x);
  }
}

// The key stored at position pos of the split V^T (within each group of 8
// keys: 0, 2, 4, 6, 1, 3, 5, 7).  P V's A fragment holds, per thread, the
// accumulator's keys 2t and 2t + 1 of each 8, where the tf32 register
// layout wants k-indices t and t + 4; permuting V^T's keys so makes the two
// agree, and the sum over keys does not care about their order.
__device__ __forceinline__ int vt_key(int pos) {
  return (pos & ~7) | ((pos & 3) << 1) | ((pos >> 2) & 1);
}

// Pre-pass: K -> K_hi, K_lo in K's layout (B, Sk, KV, HD); V -> V^T_hi,
// V^T_lo as (B, KV, HD, Sp), keys permuted within groups of 8 (vt_key)
// and zero for keys in [Sk, Sp).  One block per 32 keys of one (batch, KV
// head), staged through shared memory to transpose.
template <int HD>
__global__ void __launch_bounds__(256)
split_kv(const float* __restrict__ k, const float* __restrict__ v,
         float* __restrict__ ks, float* __restrict__ vts, int64_t Sk,
         int64_t KV, int64_t Sp, int64_t k_plane, int64_t v_plane) {
  __shared__ float tile[32][HD + 1];
  const int tid = threadIdx.x;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int64_t b = blockIdx.y / KV;
  const int64_t kvh = blockIdx.y % KV;
  for (int e = tid; e < 32 * HD; e += 256) {
    const int key = e / HD, col = e % HD;
    const int64_t s = s0 + key;
    float val = 0.f;
    if (s < Sk) {
      const int64_t idx = ((b * Sk + s) * KV + kvh) * HD + col;
      val = v[idx];
      uint32_t hi, lo;
      split(k[idx], hi, lo);
      ks[idx] = __uint_as_float(hi);
      ks[k_plane + idx] = __uint_as_float(lo);
    }
    tile[key][col] = val;
  }
  __syncthreads();
  float* row0 = vts + ((b * KV + kvh) * HD) * Sp + s0;
  for (int e = tid; e < 32 * HD; e += 256) {
    const int n = e / 32, pos = e % 32;
    uint32_t hi, lo;
    split(tile[vt_key(pos)][n], hi, lo);
    row0[n * Sp + pos] = __uint_as_float(hi);
    row0[v_plane + n * Sp + pos] = __uint_as_float(lo);
  }
}

// Grid (query tiles of kBQ rows, B * H).  Warps 0-7: two consumer
// warpgroups, rows [q0, q0 + 64) and [q0 + 64, q0 + 128); warp 8: producer.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tf32x3(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap khi_map,
                       const __grid_constant__ CUtensorMap klo_map,
                       const __grid_constant__ CUtensorMap vhi_map,
                       const __grid_constant__ CUtensorMap vlo_map,
                       float* __restrict__ o, int64_t S, int64_t Sk,
                       int64_t H, int64_t KV, int causal, int window,
                       float scale, float softcap) {
  using G = Geo<HD>;
  constexpr int kBK = G::kBK;
  extern __shared__ uint8_t smem_raw[];
  // full[kStages], empty[kStages], q
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  const uint32_t kv_smem = base + kConsumers * G::kQBytes;
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[kStages]);
  const uint32_t q_bar = smem_u32(&bars[2 * kStages]);

  const int64_t qt = static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t kvh = h / (H / KV);
  const int64_t q0 = qt * kBQ;

  // keys [k_lo, k_hi) hold every key valid for some row of this block
  // (none when k_lo >= k_hi: the rows past the last key's window)
  const int64_t q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  int64_t k_lo = 0, k_hi = Sk;
  if (causal && q_last + 1 < Sk) k_hi = q_last + 1;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  const int64_t kt_first = k_lo / kBK;
  const int64_t kt_end = (k_hi + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == 4 * kConsumers) {
    // producer: Q once, then the four split tiles of K and V^T tile by tile
    // through the ring
    if (lane == 0) {
      mbar_expect_tx(q_bar, kConsumers * G::kQBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < G::kChunks; ++c)
          tma_load(q_smem + w * G::kQBytes + c * kRows * G::W, &q_map, q_bar,
                   c * G::kChunkCols, static_cast<int>(h),
                   static_cast<int>(q0 + w * kRows), static_cast<int>(b));
      for (int64_t kt = kt_first; kt < kt_end; ++kt) {
        const int64_t t = kt - kt_first;
        const int s = static_cast<int>(t % kStages);
        const uint32_t use = static_cast<uint32_t>(t / kStages);
        mbar_wait(empty0 + 8 * s, (use & 1u) ^ 1u);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 4 * G::kTileBytes);
        const uint32_t st = kv_smem + 4 * s * G::kTileBytes;
        for (int c = 0; c < G::kChunks; ++c) {
          tma_load(st + c * kBK * G::W, &khi_map, full, c * G::kChunkCols,
                   static_cast<int>(kvh), static_cast<int>(kt * kBK),
                   static_cast<int>(b));
          tma_load(st + G::kTileBytes + c * kBK * G::W, &klo_map, full,
                   c * G::kChunkCols, static_cast<int>(kvh),
                   static_cast<int>(kt * kBK), static_cast<int>(b));
        }
        // V^T: {keys, head-dim rows, KV head, batch}
        for (int c = 0; c < G::kVChunks; ++c) {
          tma_load(st + 2 * G::kTileBytes + c * HD * 128, &vhi_map, full,
                   static_cast<int>(kt * kBK + 32 * c), 0,
                   static_cast<int>(kvh), static_cast<int>(b));
          tma_load(st + 3 * G::kTileBytes + c * HD * 128, &vlo_map, full,
                   static_cast<int>(kt * kBK + 32 * c), 0,
                   static_cast<int>(kvh), static_cast<int>(b));
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: accumulator rows row_a (fragment registers with
  // bit 1 clear) and row_b = row_a + 8; columns 8 * n + cq + {0, 1}
  const int wg = warp / 4;
  const int64_t r0 = q0 + wg * kRows;
  const int64_t row_a = r0 + (warp % 4) * 16 + lane / 4;
  const int64_t row_b = row_a + 8;
  const int cq = 2 * (lane % 4);
  // the thread's A fragment of Q: rows qa, qa + 8 of the warpgroup's tile,
  // columns 8 ks + lane % 4 (+ 4).  Through the swizzle, 16-byte unit u of
  // either row sits at unit u ^ key; the W / 16 offsets are kept in
  // registers so that every read is a base, a register and an immediate
  const int qa = (warp % 4) * 16 + lane / 4;
  const uint8_t* q_frag = smem_raw +
                         (q_smem + wg * G::kQBytes - smem_u32(smem_raw)) +
                         qa * G::W + (lane % 4) * 4;
  const uint32_t key = ((qa * G::W) >> 7) & G::kSwizzle;
  uint32_t unit_off[G::W / 16];
#pragma unroll
  for (int u = 0; u < G::W / 16; ++u) unit_off[u] = (u ^ key) << 4;
  auto q_at = [&](int row8, int col) {  // row qa + 8 row8, column col + t
    return *reinterpret_cast<const float*>(
        q_frag + row8 * 8 * G::W + (col / G::kChunkCols) * kRows * G::W +
        unit_off[col % G::kChunkCols / 4]);
  };
  const bool capped = softcap > 0.f;
  // scores in log2 units: cap_l2 * tanh(s * scale / c), or s * scale * log2e
  const float mul = capped ? scale / softcap : scale * kLog2e;
  const float cap_l2 = softcap * kLog2e;

  float o_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  mbar_wait(q_bar, 0);
  for (int64_t kt = kt_first; kt < kt_end; ++kt) {
    const int64_t t = kt - kt_first;
    const int s = static_cast<int>(t % kStages);
    mbar_wait(full0 + 8 * s, static_cast<uint32_t>(t / kStages) & 1u);
    const int64_t k0 = kt * kBK;
    // whole tile outside this warpgroup's band (or rows past S): skip
    const bool skip = r0 >= S || (causal && k0 > r0 + kRows - 1) ||
                      (window > 0 && r0 - (k0 + kBK - 1) >= window);
    if (!skip) {
      float s_acc[kBK / 2];
      // descriptors of the stage's four tiles; a k-step adds its byte
      // offset / 16 to the address field (no carry: addresses < 256 KB)
      const uint32_t khi = kv_smem + 4 * s * G::kTileBytes;
      const uint64_t d_khi = make_desc(khi, 16, 8 * G::W, G::kLayout);
      const uint64_t d_klo = d_khi + G::kTileBytes / 16;
      const uint64_t d_vhi =
          make_desc(khi + 2 * G::kTileBytes, 16, 8 * 128, 1);
      const uint64_t d_vlo = d_vhi + G::kTileBytes / 16;

      // S = Q K^T in 3xTF32: Q_hi K_hi + Q_hi K_lo + Q_lo K_hi, Q split in
      // registers kBatch k-steps at a time.  The first wgmma overwrites S;
      // zeroing it first ends its registers' life at P, so that they are
      // free during P V
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s_acc[i] = 0.f;
#pragma unroll
      for (int kb = 0; kb < HD / 8; kb += G::kBatch) {
        uint32_t qh[G::kBatch][4], ql[G::kBatch][4];
#pragma unroll
        for (int j = 0; j < G::kBatch; ++j) {
          const int col = 8 * (kb + j);
          split(q_at(0, col), qh[j][0], ql[j][0]);
          split(q_at(1, col), qh[j][1], ql[j][1]);
          split(q_at(0, col + 4), qh[j][2], ql[j][2]);
          split(q_at(1, col + 4), qh[j][3], ql[j][3]);
          fence_regs(qh[j]);
          fence_regs(ql[j]);
        }
        fence_regs(s_acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < G::kBatch; ++j) {
          const int ks = kb + j;
          const uint32_t off = (ks * 8 / G::kChunkCols) * kBK * G::W +
                               (ks * 8 % G::kChunkCols) * 4;
          const uint64_t dh = d_khi + off / 16, dl = d_klo + off / 16;
          wgmma<kBK>(s_acc, qh[j], dh, ks > 0);
          wgmma<kBK>(s_acc, qh[j], dl, 1);
          wgmma<kBK>(s_acc, ql[j], dh, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s_acc);
      }

      // scale, softcap, mask (on edge tiles only), row max
      const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > r0) ||
                        (window > 0 && r0 + kRows - 1 - k0 >= window);
      const int lim = static_cast<int>(Sk - k0 < kBK ? Sk - k0 : kBK);
      const int da = static_cast<int>(row_a - k0);  // row - tile's first key
      float mx_a = kNegInf, mx_b = kNegInf;
      if (capped) {
        if (edge)
          scores<kBK, true, true>(s_acc, mul, cap_l2, lim, da, cq, causal,
                                  window, mx_a, mx_b);
        else
          scores<kBK, true, false>(s_acc, mul, cap_l2, lim, da, cq, causal,
                                   window, mx_a, mx_b);
      } else {
        if (edge)
          scores<kBK, false, true>(s_acc, mul, cap_l2, lim, da, cq, causal,
                                   window, mx_a, mx_b);
        else
          scores<kBK, false, false>(s_acc, mul, cap_l2, lim, da, cq, causal,
                                    window, mx_a, mx_b);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;

      // p in f32 for l, split into tf32 hi / lo as P V's A fragments: for
      // k-step kk, {row a key 2t, row b key 2t, row a key 2t+1, row b key
      // 2t+1} of its 8 keys (V^T's keys are permuted to match)
      uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const float pa0 = exp2f(s_acc[4 * kk] - mn_a);
        const float pa1 = exp2f(s_acc[4 * kk + 1] - mn_a);
        const float pb0 = exp2f(s_acc[4 * kk + 2] - mn_b);
        const float pb1 = exp2f(s_acc[4 * kk + 3] - mn_b);
        ps_a += pa0 + pa1;
        ps_b += pb0 + pb1;
        split(pa0, ph[kk][0], pl[kk][0]);
        split(pb0, ph[kk][1], pl[kk][1]);
        split(pa1, ph[kk][2], pl[kk][2]);
        split(pb1, ph[kk][3], pl[kk][3]);
      }
      l_a = l_a * corr_a + ps_a;
      l_b = l_b * corr_b + ps_b;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o_acc[i] *= (i & 2) ? corr_b : corr_a;

      // O += P V in 3xTF32: P_hi V_hi + P_hi V_lo + P_lo V_hi
      fence_regs(o_acc);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint32_t off = (kk * 8 / 32) * HD * 128 + (kk * 8 % 32) * 4;
        const uint64_t dh = d_vhi + off / 16, dl = d_vlo + off / 16;
        wgmma<HD>(o_acc, ph[kk], dh, 1);
        wgmma<HD>(o_acc, ph[kk], dl, 1);
        wgmma<HD>(o_acc, pl[kk], dh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o_acc);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // l: the four threads of a row hold partial sums
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = row_den(m_a, l_a), den_b = row_den(m_b, l_b);
  const int64_t q_row = H * HD;
  float* ob = o + b * S * q_row + h * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = 8 * n + cq;
    if (row_a < S)
      *reinterpret_cast<float2*>(ob + row_a * q_row + col) =
          make_float2(o_acc[4 * n] / den_a, o_acc[4 * n + 1] / den_a);
    if (row_b < S)
      *reinterpret_cast<float2*>(ob + row_b * q_row + col) =
          make_float2(o_acc[4 * n + 2] / den_b, o_acc[4 * n + 3] / den_b);
  }
}

// 4-D float32 map, innermost first: dims, byte strides of dims 1..3, box;
// zero fill out of bounds.
int make_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4],
             const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4],
             CUtensorMapSwizzle swizzle) {
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A (B, S, heads, HD) map with boxes of {W / 4 columns, 1 head, rows, 1}.
template <int HD>
int make_rows_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
                  int64_t heads, int rows) {
  using G = Geo<HD>;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      HD * 4, static_cast<cuuint64_t>(heads * HD * 4),
      static_cast<cuuint64_t>(S * heads * HD * 4)};
  const cuuint32_t box[4] = {G::kChunkCols, 1, static_cast<cuuint32_t>(rows),
                             1};
  return make_map(map, ptr, dims, strides, box,
                  G::W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B);
}

// A (B, KV, HD, Sp) V^T map with boxes of {32 keys, HD rows, 1, 1}.
template <int HD>
int make_vt_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t KV,
                int64_t Sp) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Sp), HD,
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(Sp * 4),
                                 static_cast<cuuint64_t>(HD * Sp * 4),
                                 static_cast<cuuint64_t>(KV * HD * Sp * 4)};
  const cuuint32_t box[4] = {32, HD, 1, 1};
  return make_map(map, ptr, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD>
int launch_split(const void* k, const void* v, void* ks, void* vts,
                 int64_t B, int64_t Sk, int64_t KV, int64_t Sp,
                 cudaStream_t stream) {
  if (B * KV > 65535 || Sp / 32 > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(Sp / 32),
                  static_cast<unsigned>(B * KV));
  split_kv<HD><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(ks), static_cast<float*>(vts), Sk, KV, Sp,
      B * Sk * KV * HD, B * KV * HD * Sp);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* ks, const void* vts, void* o,
           int64_t B, int64_t S, int64_t Sk, int64_t H, int64_t KV,
           int64_t Sp, int64_t causal, int64_t window, float scale,
           float softcap, cudaStream_t stream) {
  using G = Geo<HD>;
  // TMA coordinates are 32-bit
  if (S > 2147483647LL - kBQ || Sp > 2147483647LL - kBQ || B * H > 65535)
    return cudaErrorInvalidValue;
  const float* k_hi = static_cast<const float*>(ks);
  const float* v_hi = static_cast<const float*>(vts);
  CUtensorMap q_map, khi_map, klo_map, vhi_map, vlo_map;
  int err = make_rows_map<HD>(&q_map, q, B, S, H, kRows);
  if (err == cudaSuccess)
    err = make_rows_map<HD>(&khi_map, k_hi, B, Sk, KV, G::kBK);
  if (err == cudaSuccess)
    err = make_rows_map<HD>(&klo_map, k_hi + B * Sk * KV * HD, B, Sk, KV,
                            G::kBK);
  if (err == cudaSuccess) err = make_vt_map<HD>(&vhi_map, v_hi, B, KV, Sp);
  if (err == cudaSuccess)
    err = make_vt_map<HD>(&vlo_map, v_hi + B * KV * HD * Sp, B, KV, Sp);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = G::kSmem;
  err = cudaFuncSetAttribute(flash_attention_tf32x3<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * H));
  // q - k <= S - 1 for every query and key, whatever Sk: a window wider
  // than S masks nothing
  const int win = window > 0 ? static_cast<int>(window < S ? window : S) : 0;
  flash_attention_tf32x3<HD><<<grid, kThreads, smem, stream>>>(
      q_map, khi_map, klo_map, vhi_map, vlo_map, static_cast<float*>(o), S,
      Sk, H, KV, static_cast<int>(causal), win, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc32

// f(std::integral_constant<int, hd>()) for a head width with kernels.
template <typename F>
int by_hd(int64_t hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bf16: q, o (B, S, H, hd); k, v (B, Sk, KV, hd).  window <= 0 means no
// window, softcap <= 0 no softcap.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int64_t B, int64_t S, int64_t Sk,
                          int64_t H, int64_t KV, int64_t hd, int64_t causal,
                          int64_t window, float scale, float softcap,
                          int64_t device, void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (Sk <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_hd(hd, [&](auto HD) {
    return tc::launch<decltype(HD)::value>(q, k, v, o, B, S, Sk, H, KV,
                                           causal, window, scale, softcap,
                                           st);
  });
}

// float32, the pre-pass: k, v (B, Sk, KV, hd) -> ks (2, B, Sk, KV, hd) =
// K's tf32 hi and lo planes; vts (2, B, KV, hd, Sp) = V^T's hi and lo
// planes, keys permuted within groups of 8, zero past Sk.  Sp: Sk rounded
// up to a multiple of 64.
int repro_flash_attention_tf32x3_split(const void* k, const void* v,
                                       void* ks, void* vts, int64_t B,
                                       int64_t Sk, int64_t KV, int64_t hd,
                                       int64_t Sp, int64_t device,
                                       void* stream) {
  if (B == 0 || Sk == 0) return cudaSuccess;
  if (KV <= 0 || Sp < Sk || Sp % tc32::kKeyPad) return cudaErrorInvalidValue;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_hd(hd, [&](auto HD) {
    return tc32::launch_split<decltype(HD)::value>(k, v, ks, vts, B, Sk,
                                                   KV, Sp, st);
  });
}

// float32, the attention: q, o (B, S, H, hd); ks, vts from the pre-pass of
// Sk keys.  window <= 0 means no window, softcap <= 0 no softcap.
int repro_flash_attention_tf32x3(const void* q, const void* ks,
                                 const void* vts, void* o, int64_t B,
                                 int64_t S, int64_t Sk, int64_t H, int64_t KV,
                                 int64_t hd, int64_t Sp, int64_t causal,
                                 int64_t window, float scale, float softcap,
                                 int64_t device, void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (Sk <= 0 || KV <= 0 || H % KV != 0 || Sp < Sk || Sp % tc32::kKeyPad)
    return cudaErrorInvalidValue;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_hd(hd, [&](auto HD) {
    return tc32::launch<decltype(HD)::value>(q, ks, vts, o, B, S, Sk, H, KV,
                                             Sp, causal, window, scale,
                                             softcap, st);
  });
}

// Dynamic shared memory of the attention kernel for (hd, dtype: 0 =
// float32, 1 = bf16), in bytes; -1 for a head width with no kernel.
int64_t repro_flash_attention_smem(int64_t hd, int64_t dtype) {
  switch (hd) {
    case 16: return dtype == 1 ? tc::Geo<16>::kSmem : tc32::Geo<16>::kSmem;
    case 32: return dtype == 1 ? tc::Geo<32>::kSmem : tc32::Geo<32>::kSmem;
    case 64: return dtype == 1 ? tc::Geo<64>::kSmem : tc32::Geo<64>::kSmem;
    case 128: return dtype == 1 ? tc::Geo<128>::kSmem : tc32::Geo<128>::kSmem;
    default: return -1;
  }
}

}  // extern "C"
