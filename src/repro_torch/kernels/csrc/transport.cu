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
// Design: one thread per output byte (quantize) or output element
// (dequantize).  Neighbouring threads touch neighbouring addresses, so the
// f32 loads and the one-byte stores coalesce within a warp.  Widening the
// stores to 16-byte vectors (16 elements per thread) is left to a later
// change.  The grid is (column blocks, rows): the row comes from blockIdx.y,
// so no thread divides by the row width.  All flat indices are 64-bit.
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

// Per-element leaf scale: leaf l spans global indices [offsets[l],
// offsets[l+1]); the last leaf whose offset is <= idx wins, exactly the L-1
// selects of transport.py:106-108.
__device__ __forceinline__ float leaf_scale(int64_t idx,
                                            const int64_t* __restrict__ offsets,
                                            const float* __restrict__ scales,
                                            int64_t L) {
  float s = scales[0];
  for (int64_t l = 1; l < L; ++l) {
    if (idx >= offsets[l]) s = scales[l];
  }
  return s;
}

__device__ __forceinline__ int quantize_one(float x, float scale, float qmax) {
  float q = rintf(__fdiv_rn(x, scale));
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<int>(q);
}

// x: (R, C) f32, C a multiple of kBlock.  out: (R, Cw) bytes, Cw = C (int8)
// or C / 2 (packed int4).  Element (i, c) sits at global index
// base + i * row_stride + c.
__global__ void quantize_pack_kernel(const float* __restrict__ x,
                                     uint8_t* __restrict__ out,
                                     const int64_t* __restrict__ offsets,
                                     const float* __restrict__ scales,
                                     int64_t L, int64_t C, int64_t Cw,
                                     int64_t base, int64_t row_stride,
                                     int bits) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= Cw) return;
  const int64_t i = blockIdx.y;
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const int64_t row_base = base + i * row_stride;
  const float* xr = x + i * C;
  uint8_t byte;
  if (bits == 4) {
    const int64_t c_lo = (k / kHalf) * kBlock + (k % kHalf);
    const int64_t c_hi = c_lo + kHalf;
    const int lo = quantize_one(
        xr[c_lo], leaf_scale(row_base + c_lo, offsets, scales, L), qmax);
    const int hi = quantize_one(
        xr[c_hi], leaf_scale(row_base + c_hi, offsets, scales, L), qmax);
    byte = static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4));
  } else {
    const int q = quantize_one(
        xr[k], leaf_scale(row_base + k, offsets, scales, L), qmax);
    byte = static_cast<uint8_t>(static_cast<int8_t>(q));
  }
  out[i * Cw + k] = byte;
}

// wire: (R, Cw) bytes.  out: (R, Cp) f32, Cp = Cw (int8) or 2 * Cw (int4).
__global__ void unpack_dequantize_kernel(const uint8_t* __restrict__ wire,
                                         float* __restrict__ out,
                                         const int64_t* __restrict__ offsets,
                                         const float* __restrict__ scales,
                                         int64_t L, int64_t Cw, int64_t Cp,
                                         int64_t base, int64_t row_stride,
                                         int bits) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= Cp) return;
  const int64_t i = blockIdx.y;
  const uint8_t* wr = wire + i * Cw;
  int v;
  if (bits == 4) {
    const int64_t kk = c % kBlock;
    const uint8_t b = wr[(c / kBlock) * kHalf + (kk % kHalf)];
    const int nib = kk < kHalf ? (b & 0xF) : ((b >> 4) & 0xF);
    v = nib > 7 ? nib - 16 : nib;
  } else {
    v = static_cast<int>(static_cast<int8_t>(wr[c]));
  }
  const float s = leaf_scale(base + i * row_stride + c, offsets, scales, L);
  out[i * Cp + c] = __fmul_rn(static_cast<float>(v), s);
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
  const int64_t Cw = bits == 4 ? C / 2 : C;
  dim3 grid;
  err = launch_dims(Cw, R, &grid);
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
  const int64_t Cp = (Cw / wblock) * kBlock;
  dim3 grid;
  err = launch_dims(Cp, R, &grid);
  if (err != cudaSuccess) return err;
  unpack_dequantize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wire), static_cast<float*>(out),
      static_cast<const int64_t*>(offsets), static_cast<const float*>(scales),
      L, Cw, Cp, base, row_stride, static_cast<int>(bits));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
