// Fused quantize-pack / unpack-dequantize transport kernels for Hopper (sm_90a).
//
// They replace the two Pallas TPU kernels of the JAX package:
//   quantize_pack_kernel     <- src/repro/kernels/transport.py::quantize_pack
//                               (body _quant_kernel, transport.py:112)
//   unpack_dequantize_kernel <- src/repro/kernels/transport.py::unpack_dequantize
//                               (body _dequant_kernel, transport.py:133)
// and must give the same wire bytes and the same f32 values, bit for bit, as
// the plain versions in repro_torch/kernels/ref.py.
//
// What bounds them on an H100: device-memory bytes.  Quantize reads 4 B and
// writes 1 B per element (0.5 B at 4 bits); dequantize reads 1 B (0.5 B) and
// writes 4 B.  Each performs a handful of operations per element, far below
// the card's ratio of operations to bytes.
//
// Design.  Both kernels give each warp 512 wire bytes of one row, so every
// warp access is one contiguous span.  Wire byte k of a warp's 512 belongs
// to 128-byte segment k / 128, and lane t owns the 4-byte word t of each of
// the four segments: 4 int8 elements, or 4 low and 4 high int4 nibbles
// (elements k..k+3 and k+128..k+131 of a 256-element block).  So each of the
// lane's 4 (int8) or 8 (int4) float accesses is a float4, and each warp
// float4 access covers 512 contiguous bytes.  The wire side goes through 512
// bytes of shared memory per warp, so that lane t moves wire bytes
// [16 t, 16 t + 16) as one uint4: quantize parks its four words there and
// stores the uint4, dequantize loads the uint4 and takes its four words
// back.  A thread's 16 contiguous wire bytes handled in place would put its
// float4 accesses 64 bytes apart across the warp, each warp access touching
// half sectors over 2 KB.  Quantize puts all its float4 loads in flight
// before it converts any.  Each thread finds its leaf once (binary search
// over the offsets) and selects per element only where a leaf boundary
// falls inside its run; block and segment indices come from shifts.  The
// grid is (column blocks, rows): the row comes from blockIdx.y, so no
// thread divides by the row width.  All flat indices are 64-bit.  Shared
// memory: 4 KB per block (8 warps x 512 bytes) in each kernel.
//
// Numerics match the jnp oracle: IEEE division (__fdiv_rn, never a
// reciprocal multiply), round half to even (rintf, not roundf), clip to
// +-(2^(bits-1)-1); dequantize is one f32 multiply (__fmul_rn).  Build
// without --use_fast_math.
//
// Each launcher is a plain C function: it launches on the caller's stream
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Transport block of the split-half int4 layout: wire byte k of a block holds
// element k in its low nibble and element k + 128 in its high nibble.
constexpr int64_t kBlock = 256;
constexpr int64_t kHalf = kBlock / 2;
constexpr int kThreads = 256;

__device__ __forceinline__ int quantize_one(float x, float scale, float qmax) {
  float q = rintf(__fdiv_rn(x, scale));
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<int>(q);
}

// The leaf of global index idx: leaf l spans [offsets[l], offsets[l+1]),
// and the last l with offsets[l] <= idx wins, empty leaves included (the
// L-1 selects of transport.py:106-108), found by binary search.
__device__ __forceinline__ int64_t leaf_of(int64_t idx,
                                           const int64_t* __restrict__ offsets,
                                           int64_t L) {
  int64_t lo = 0, hi = L - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= idx)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Leaf scales along one thread's increasing global indices in [first,
// last]: one scale for the whole run when no leaf starts inside it, else
// the leaf advanced element by element.
struct LeafCursor {
  const int64_t* offsets;
  const float* scales;
  int64_t L, l;
  float s;
  bool uniform;
  __device__ __forceinline__ LeafCursor(const int64_t* o, const float* sc,
                                        int64_t L_, int64_t first,
                                        int64_t last)
      : offsets(o), scales(sc), L(L_), l(leaf_of(first, o, L_)) {
    s = sc[l];
    uniform = l + 1 >= L || o[l + 1] > last;
  }
  // idx must not decrease from one call to the next
  __device__ __forceinline__ float at(int64_t idx) {
    if (uniform) return s;
    while (l + 1 < L && offsets[l + 1] <= idx) ++l;
    return scales[l];
  }
};

// Values v[k] * scale(idx + k), k < 4, as one float4 store at dst.
__device__ __forceinline__ void store4(float* dst, const int (&v)[4],
                                       LeafCursor& cur, int64_t idx) {
  float s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) s[k] = cur.at(idx + k);  // in index order
  *reinterpret_cast<float4*>(dst) = make_float4(
      __fmul_rn(static_cast<float>(v[0]), s[0]),
      __fmul_rn(static_cast<float>(v[1]), s[1]),
      __fmul_rn(static_cast<float>(v[2]), s[2]),
      __fmul_rn(static_cast<float>(v[3]), s[3]));
}

// Wire bytes per warp: 32 lanes x one uint4.
constexpr int64_t kWarpBytes = 32 * 16;

// wire: (R, Cw) bytes, Cw a multiple of the wire block.  out: (R, Cp) f32,
// Cp = Cw (int8) or 2 * Cw (int4).  Warp w of row i decodes wire bytes
// [512 w, 512 w + 512): lane t loads bytes [16 t, 16 t + 16) of them as one
// uint4 into shared memory, then takes 4-byte word t of each of the four
// 128-byte segments, so that each float4 store of the warp covers 512
// contiguous bytes.
__global__ void unpack_dequantize_kernel(const uint8_t* __restrict__ wire,
                                         float* __restrict__ out,
                                         const int64_t* __restrict__ offsets,
                                         const float* __restrict__ scales,
                                         int64_t L, int64_t Cw, int64_t Cp,
                                         int64_t base, int64_t row_stride,
                                         int bits) {
  __shared__ uint4 stage[kThreads / 32][32];
  const int lane = threadIdx.x & 31;
  const int64_t w0 =
      ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) *
      kWarpBytes;
  if (w0 >= Cw) return;  // whole warps leave together
  const int64_t i = blockIdx.y;
  uint4* st = stage[threadIdx.x >> 5];
  if (w0 + 16 * lane < Cw)
    st[lane] = *reinterpret_cast<const uint4*>(wire + i * Cw + w0 + 16 * lane);
  __syncwarp();
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(st);
  float* orow = out + i * Cp;
  const int64_t g = base + i * row_stride;  // global index of column 0
  const bool int4 = bits == 4;
  // column of segment 0's first element for this lane, and the column step
  // per 128-byte segment (a whole int4 block, or 128 int8 elements)
  const int64_t c0 = (int4 ? (w0 << 1) : w0) + 4 * lane;
  const int64_t step = int4 ? kBlock : 128;
  LeafCursor cur(offsets, scales, L, g + c0,
                 g + c0 + 3 * step + (int4 ? kHalf + 3 : 3));
  int v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (w0 + 128 * j >= Cw) break;
    const uint32_t word = sw[32 * j + lane];
    const int64_t c = c0 + j * step;
    if (int4) {
#pragma unroll
      for (int k = 0; k < 4; ++k)  // low nibbles, sign-extended
        v[k] = static_cast<int32_t>(word << (28 - 8 * k)) >> 28;
      store4(orow + c, v, cur, g + c);
#pragma unroll
      for (int k = 0; k < 4; ++k)  // high nibbles: elements 128 further on
        v[k] = static_cast<int32_t>(word << (24 - 8 * k)) >> 28;
      store4(orow + c + kHalf, v, cur, g + c + kHalf);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = static_cast<int32_t>(word << (24 - 8 * k)) >> 24;
      store4(orow + c, v, cur, g + c);
    }
  }
}

// Wire word of 4 quantized elements at global indices idx..idx+3: 4 int8
// bytes, or (int4) 4 bytes whose low nibbles take lo and high nibbles hi,
// the elements 128 further on.  Scales are taken in index order.
__device__ __forceinline__ uint32_t quantize_word(const float4 lo,
                                                  const float4 hi, bool int4,
                                                  LeafCursor& cur, int64_t idx,
                                                  float qmax) {
  const float xl[4] = {lo.x, lo.y, lo.z, lo.w};
  const float xh[4] = {hi.x, hi.y, hi.z, hi.w};
  int ql[4], qh[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    ql[k] = quantize_one(xl[k], cur.at(idx + k), qmax);
  uint32_t word = 0;
  if (int4) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      qh[k] = quantize_one(xh[k], cur.at(idx + kHalf + k), qmax);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word |= static_cast<uint32_t>((ql[k] & 0xF) | ((qh[k] & 0xF) << 4))
              << (8 * k);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word |= static_cast<uint32_t>(ql[k] & 0xFF) << (8 * k);
  }
  return word;
}

// x: (R, C) f32, C a multiple of kBlock, 16-byte aligned.  out: (R, Cw)
// bytes, Cw = C (int8) or C / 2 (packed int4).  Element (i, c) sits at
// global index base + i * row_stride + c.  Warp w of row i writes wire
// bytes [512 w, 512 w + 512): lane t loads the elements of word t of each
// 128-byte segment as float4s (each warp load 512 contiguous bytes),
// quantizes them into shared memory, and stores bytes [16 t, 16 t + 16) of
// the warp's 512 as one uint4.
__global__ void quantize_pack_kernel(const float* __restrict__ x,
                                     uint8_t* __restrict__ out,
                                     const int64_t* __restrict__ offsets,
                                     const float* __restrict__ scales,
                                     int64_t L, int64_t C, int64_t Cw,
                                     int64_t base, int64_t row_stride,
                                     int bits) {
  __shared__ uint4 stage[kThreads / 32][32];
  const int lane = threadIdx.x & 31;
  const int64_t w0 =
      ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) *
      kWarpBytes;
  if (w0 >= Cw) return;  // whole warps leave together
  const int64_t i = blockIdx.y;
  const float* xr = x + i * C;
  const int64_t g = base + i * row_stride;  // global index of column 0
  const bool int4 = bits == 4;
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  // as in the dequantize: segment 0's first column for this lane, and the
  // column step per 128-byte segment
  const int64_t c0 = (int4 ? (w0 << 1) : w0) + 4 * lane;
  const int64_t step = int4 ? kBlock : 128;
  // every load in flight before the first conversion
  float4 lo[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = hi[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (w0 + 128 * j >= Cw) continue;
    const float* p = xr + c0 + j * step;
    lo[j] = __ldg(reinterpret_cast<const float4*>(p));
    if (int4) hi[j] = __ldg(reinterpret_cast<const float4*>(p + kHalf));
  }
  LeafCursor cur(offsets, scales, L, g + c0,
                 g + c0 + 3 * step + (int4 ? kHalf + 3 : 3));
  uint32_t* sw = reinterpret_cast<uint32_t*>(stage[threadIdx.x >> 5]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (w0 + 128 * j >= Cw) break;
    sw[32 * j + lane] =
        quantize_word(lo[j], hi[j], int4, cur, g + c0 + j * step, qmax);
  }
  __syncwarp();
  if (w0 + 16 * lane < Cw)
    *reinterpret_cast<uint4*>(out + i * Cw + w0 + 16 * lane) =
        stage[threadIdx.x >> 5][lane];
}

int launch_dims(int64_t cols, int64_t rows, dim3* grid) {
  const int64_t blocks = (cols + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL || rows > 65535) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(rows), 1);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Returns the block width the kernels are compiled for.
int repro_transport_block() { return static_cast<int>(kBlock); }

int repro_quantize_pack(const void* x, void* out, const void* offsets,
                        const void* scales, int64_t L, int64_t R, int64_t C,
                        int64_t base, int64_t row_stride, int64_t bits,
                        int64_t device, void* stream) {
  if (R == 0 || C == 0) return cudaSuccess;
  if (C % kBlock != 0 || bits < 2 || bits > 8) return cudaErrorInvalidValue;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int64_t Cw = bits == 4 ? C / 2 : C;
  dim3 grid;
  err = launch_dims((Cw + kWarpBytes - 1) / kWarpBytes * 32, R, &grid);
  if (err != cudaSuccess) return err;
  quantize_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(offsets), static_cast<const float*>(scales),
      L, C, Cw, base, row_stride, static_cast<int>(bits));
  return static_cast<int>(cudaGetLastError());
}

int repro_unpack_dequantize(const void* wire, void* out, const void* offsets,
                            const void* scales, int64_t L, int64_t R,
                            int64_t Cw, int64_t base, int64_t row_stride,
                            int64_t bits, int64_t device, void* stream) {
  if (R == 0 || Cw == 0) return cudaSuccess;
  const int64_t wblock = bits == 4 ? kHalf : kBlock;
  if (Cw % wblock != 0 || bits < 2 || bits > 8) return cudaErrorInvalidValue;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(wire) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int64_t Cp = (Cw / wblock) * kBlock;
  dim3 grid;
  err = launch_dims((Cw + kWarpBytes - 1) / kWarpBytes * 32, R, &grid);
  if (err != cudaSuccess) return err;
  unpack_dequantize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wire), static_cast<float*>(out),
      static_cast<const int64_t*>(offsets), static_cast<const float*>(scales),
      L, Cw, Cp, base, row_stride, static_cast<int>(bits));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
