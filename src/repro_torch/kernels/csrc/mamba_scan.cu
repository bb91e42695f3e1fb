// The Mamba (S6) selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py::
// mamba_scan_pallas (body _kernel, mamba_scan.py:32-63).  Per batch row and
// channel d, with N float32 state values that start at 0:
//   dA = exp(dt_t[d] * A[d][n])
//   state[n] = state[n] * dA + (dt_t[d] * x_t[d]) * B_t[n]
//   y_t[d] = sum_n state[n] * C_t[n]
// over every time step.  The caller adds the D-skip and the gating.  The
// plain version is repro_torch/kernels/ref.py::mamba_scan_ref.
//
// What bounds it on an H100: device-memory bytes (x and dt read, y written:
// 12 B per element at float32) against about 7 * N operations per element,
// one of them an accurate expf; at N = 16 the two are within a small factor
// of each other, and the serial chain of time steps sets the latency.
// Design: grid (channel blocks, batch), one thread per channel with its N
// state values and its row of A in registers.  The TPU's sequential chunk
// grid becomes a loop over all S steps inside the block.  B_t and C_t are
// shared by every channel of a row, so a chunk of kChunk steps of them is
// staged in shared memory; x and dt of the chunk are staged there too, so
// that all of a chunk's loads are in flight together (each thread loads its
// own channel, so they coalesce across the block).  Ragged d is masked.
//
// Inputs x, dt: (Bsz, S, d); B, C: (Bsz, S, N), all of one type, float32 or
// bf16 (read with __bfloat162float; the reference's mamba_full may stream
// dt, B and C as bf16); A: float32 (d, N); y: float32 (Bsz, S, d).  N is 4,
// 8 or 16.  All element offsets are 64-bit.  Build without --use_fast_math
// (expf).
//
// The launcher is a plain C function: it launches on the caller's stream
// and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kChunk = 64;    // time steps staged per pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, float* __restrict__ y, int64_t S,
                  int64_t D) {
  __shared__ float sx[kChunk][kThreads];
  __shared__ float sdt[kChunk][kThreads];
  __shared__ float sB[kChunk][N];
  __shared__ float sC[kChunk][N];

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const bool live = d < D;

  float a[N], st[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[d * N + n] : 0.f;
    st[n] = 0.f;
  }

  for (int64_t t0 = 0; t0 < S; t0 += kChunk) {
    const int nt = S - t0 < kChunk ? static_cast<int>(S - t0) : kChunk;
    __syncthreads();  // the previous chunk is consumed
    for (int tt = 0; tt < nt; ++tt) {
      const int64_t off = (b * S + t0 + tt) * D + d;
      sx[tt][tid] = live ? to_float(x[off]) : 0.f;
      sdt[tt][tid] = live ? to_float(dt[off]) : 0.f;
    }
    const int64_t bc0 = (b * S + t0) * N;
    for (int e = tid; e < nt * N; e += kThreads) {
      sB[e / N][e % N] = to_float(Bm[bc0 + e]);
      sC[e / N][e % N] = to_float(Cm[bc0 + e]);
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = sdt[tt][tid];
      const float dx = dtv * sx[tt][tid];
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float dA = expf(dtv * a[n]);
        st[n] = fmaf(st[n], dA, dx * sB[tt][n]);
        yv = fmaf(st[n], sC[tt][n], yv);
      }
      if (live) y[(b * S + t0 + tt) * D + d] = yv;
    }
  }
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, int64_t Bsz, int64_t S, int64_t D,
           cudaStream_t stream) {
  const int64_t blocks = (D + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL || Bsz > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(Bsz));
  mamba_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y), S, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(const void* x, const void* dt, const void* A, const void* B,
               const void* C, void* y, int64_t Bsz, int64_t S, int64_t D,
               int64_t N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, 4>(x, dt, A, B, C, y, Bsz, S, D, stream);
    case 8: return launch<T, 8>(x, dt, A, B, C, y, Bsz, S, D, stream);
    case 16: return launch<T, 16>(x, dt, A, B, C, y, Bsz, S, D, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, dt: (Bsz, S, D); A: float32 (D, N); B, C: (Bsz, S, N); y: float32
// (Bsz, S, D); dtype 0 = float32, 1 = bf16 (x, dt, B, C).
int repro_mamba_scan(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, void* y, int64_t Bsz,
                     int64_t S, int64_t D, int64_t N, int64_t dtype,
                     int64_t device, void* stream) {
  if (Bsz == 0 || S == 0 || D == 0) return cudaSuccess;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_n<float>(x, dt, A, B, C, y, Bsz, S, D, N, st);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(x, dt, A, B, C, y, Bsz, S, D, N, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
