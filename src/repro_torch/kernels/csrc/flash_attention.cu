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
// bytes.  This first kernel does its products as float32 FMAs on the SIMT
// cores (67 TFLOP/s on an H100 SXM, against 989 TFLOP/s for bf16 on the
// tensor cores), so it runs well below the bf16 bound; wgmma / mma.sync
// tiles are left to a later change.  What the design does about the work:
//   * key tiles that lie wholly outside the causal band or the sliding
//     window are skipped (gemma2's 4096-wide window at S = 32768 reads 1/8 of
//     the causal band).  This leaves the result unchanged: in the Pallas
//     kernel such a tile gives a row only the transient p = 1 of a row whose
//     m is still NEG_INF, and the row's first valid tile wipes it exactly
//     (corr = exp(-1e30 - m) = 0 in f32); every row of a causal or windowed
//     call has a valid key;
//   * query tiles are issued last-first, so the long causal rows start early;
//   * one block of 256 threads owns a 64-row query tile; a 16 x 16 thread grid
//     computes a 64 x 64 score tile as 4 x 4 register micro-tiles from
//     shared memory (rows padded by one float against bank conflicts), and
//     each thread keeps 4 rows x hd/16 columns of the accumulator in
//     registers, on the same rows as its scores, so m, l and the correction
//     need only shuffles within a half-warp.
//
// The scale multiplies (1/sqrt(hd), as the Pallas kernel does at :120; the
// plain version divides by sqrt(hd)).  The softcap c * tanh(s / c) comes
// before the mask.  Masks: padded keys (k >= S), causal (q - k >= 0), window
// (q - k < window).  GQA: query head h reads KV head h / (H / KV) (the
// reference's jnp.repeat along the head axis), indexed here, not repeated.
// Inputs are (B, S, H, hd) / (B, S, KV, hd), contiguous, float32 or bf16
// (read with __bfloat162float); the output has q's type and layout.  All
// element offsets are 64-bit.  Build without --use_fast_math (tanhf, expf).
//
// The launcher is a plain C function: it launches on the caller's stream
// and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per staged tile
constexpr float kNegInf = -1.0e30f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int64_t S,
                       int64_t H, int64_t KV, int causal, int64_t window,
                       float scale, float softcap) {
  constexpr int QS = HD + 1;   // padded row of the Q and K tiles
  constexpr int PS = kBK + 1;  // padded row of the probability tile
  constexpr int CPT = HD / 16; // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * HD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // score column / accumulator column group
  const int ty = tid >> 4;   // score row group
  const int64_t qt = static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t kvh = h / (H / KV);
  const int64_t q_row = H * HD;
  const int64_t kv_row = KV * HD;
  const T* qb = q + b * S * q_row + h * HD;
  const T* kb = k + b * S * kv_row + kvh * HD;
  const T* vb = v + b * S * kv_row + kvh * HD;
  T* ob = o + b * S * q_row + h * HD;
  const int64_t q0 = qt * kBQ;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int64_t s = q0 + r;
    Qs[r * QS + d] = s < S ? to_float(qb[s * q_row + d]) : 0.f;
  }

  // keys [k_lo, k_hi) hold every key valid for some row of this tile
  const int64_t q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  int64_t k_lo = 0, k_hi = S;
  if (causal) k_hi = q_last + 1;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  const int64_t kt_first = k_lo / kBK;
  const int64_t kt_end = (k_hi + kBK - 1) / kBK;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int64_t kt = kt_first; kt < kt_end; ++kt) {
    const int64_t k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const int64_t s = k0 + r;
      const bool in = s < S;
      Ks[r * QS + d] = in ? to_float(kb[s * kv_row + d]) : 0.f;
      Vs[r * HD + d] = in ? to_float(vb[s * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        bool ok = col < S;
        if (causal) ok = ok && row >= col;
        if (window > 0) ok = ok && row - col < window;
        sc[i][j] = ok ? s : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Vs[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ob[row * q_row + tx + 16 * c] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t S, int64_t H, int64_t KV, int64_t causal, int64_t window,
           float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  int err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t n_q = (S + kBQ - 1) / kBQ;
  if (n_q > 2147483647LL || B * H > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_q), static_cast<unsigned>(B * H));
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV,
      static_cast<int>(causal), window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o,
                int64_t B, int64_t S, int64_t H, int64_t KV, int64_t hd,
                int64_t causal, int64_t window, float scale, float softcap,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, causal, window, scale, softcap, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, window, scale, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, window, scale, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, window, scale, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd); dtype 0 = float32, 1 = bf16.
// window <= 0 means no window, softcap <= 0 no softcap.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int64_t B, int64_t S, int64_t H,
                          int64_t KV, int64_t hd, int64_t dtype,
                          int64_t causal, int64_t window, float scale,
                          float softcap, int64_t device, void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, B, S, H, KV, hd, causal, window,
                              scale, softcap, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal,
                                      window, scale, softcap, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
