// The RWKV6 time-mix recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py::
// rwkv6_scan_pallas (body _kernel, rwkv6_scan.py:33-62).  Per (batch, head),
// with an hd x hd float32 state S that starts at 0:
//   o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// in this order, over every time step.  The plain version is
// repro_torch/kernels/ref.py::rwkv6_scan_ref.
//
// What bounds it on an H100: device-memory bytes and the serial chain of
// time steps.  Each step reads 4 * hd inputs and writes hd outputs of a head
// and needs 5 * hd * hd operations on the resident state (r.S, then
// w * S + k * v); the state never leaves the SM.  Design: one block per (batch, head), hd threads;
// thread j keeps column j of the state in registers (hd floats) and the
// bonus u in registers.  The TPU's sequential chunk grid becomes a loop over
// all S steps inside the block: r, k, w and v are staged through shared
// memory kChunk steps at a time (each thread loads its own column, so the
// loads coalesce), and r_t, k_t, w_t are read back as float4 broadcasts.
// Four partial sums break the dependency chain of o_t[j].  No time padding
// is needed (the Pallas kernel pads w with 1.0 to a whole chunk): the loop
// runs to S.  The blocks are small (hd threads), one per (batch, head):
// filling the card needs B * H in the hundreds, as rwkv6-1.6b's 32 heads at
// batch 8 give, and even then each SM holds only a few warps to hide the
// latency of the step's chain.
//
// Inputs are (B, S, H, hd), contiguous, float32 or bf16 (read with
// __bfloat162float); u is float32 (Bu, H, hd) with Bu = 1 (one bonus per
// head, shared by the batch) or Bu = B; the output is float32 (B, S, H, hd).
// All element offsets are 64-bit.  Build without --use_fast_math.
//
// The launcher is a plain C function: it launches on the caller's stream
// and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // time steps staged per pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ o,
                  int64_t S, int64_t H, int64_t u_batch_stride) {
  __shared__ __align__(16) float sr[kChunk][HD];
  __shared__ __align__(16) float sk[kChunk][HD];
  __shared__ __align__(16) float sw[kChunk][HD];
  __shared__ float sv[kChunk][HD];

  const int j = threadIdx.x;
  const int64_t b = blockIdx.x / H;
  const int64_t h = blockIdx.x % H;
  const int64_t row = H * HD;
  const int64_t base = b * S * row + h * HD;

  float st[HD], uu[HD];
  const float* ub = u + b * u_batch_stride + h * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    st[i] = 0.f;
    uu[i] = ub[i];
  }

  for (int64_t t0 = 0; t0 < S; t0 += kChunk) {
    const int n = S - t0 < kChunk ? static_cast<int>(S - t0) : kChunk;
    __syncthreads();  // the previous chunk is consumed
    for (int tt = 0; tt < n; ++tt) {
      const int64_t off = base + (t0 + tt) * row + j;
      sr[tt][j] = to_float(r[off]);
      sk[tt][j] = to_float(k[off]);
      sw[tt][j] = to_float(w[off]);
      sv[tt][j] = to_float(v[off]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      const float4* r4 = reinterpret_cast<const float4*>(sr[tt]);
      const float4* k4 = reinterpret_cast<const float4*>(sk[tt]);
      const float4* w4 = reinterpret_cast<const float4*>(sw[tt]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i4 = 0; i4 < HD / 4; ++i4) {
        const float4 rv = r4[i4], kv4 = k4[i4], wv = w4[i4];
        const float rs[4] = {rv.x, rv.y, rv.z, rv.w};
        const float ks[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
        const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * i4 + q;
          const float kv = ks[q] * vj;
          part[q] = fmaf(rs[q], fmaf(uu[i], kv, st[i]), part[q]);
          st[i] = fmaf(ws[q], st[i], kv);
        }
      }
      o[base + (t0 + tt) * row + j] = (part[0] + part[1]) + (part[2] + part[3]);
    }
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* o, int64_t B, int64_t S, int64_t H,
           int64_t u_batch_stride, cudaStream_t stream) {
  if (B * H > 2147483647LL) return cudaErrorInvalidValue;
  rwkv6_scan_kernel<T, HD><<<static_cast<unsigned>(B * H), HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<float*>(o), S, H,
      u_batch_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* o, int64_t B, int64_t S, int64_t H,
                int64_t hd, int64_t u_batch_stride, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, o, B, S, H, u_batch_stride, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, o, B, S, H, u_batch_stride, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, o, B, S, H, u_batch_stride, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v, w: (B, S, H, hd); u: float32 (Bu, H, hd), u_batch_stride = 0 when
// Bu = 1, else H * hd; o: float32 (B, S, H, hd); dtype 0 = float32, 1 = bf16.
int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* o, int64_t B,
                     int64_t S, int64_t H, int64_t hd, int64_t u_batch_stride,
                     int64_t dtype, int64_t device, void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(r, k, v, w, u, o, B, S, H, hd, u_batch_stride,
                              st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(r, k, v, w, u, o, B, S, H, hd,
                                      u_batch_stride, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
