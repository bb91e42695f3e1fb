// The Mamba (S6) selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py::
// mamba_scan_pallas (body _kernel, mamba_scan.py:32-63).  Per batch row and
// channel d, with N float32 state values that start at 0:
//   dA = exp(dt_t[d] * A[d][n])
//   state[n] = state[n] * dA + (dt_t[d] * x_t[d]) * B_t[n]
//   y_t[d] = sum_n state[n] * C_t[n]
// over every time step.  A is a general float32 (d, N) matrix.  The caller
// adds the D-skip and the gating.  The plain version is
// repro_torch/kernels/ref.py::mamba_scan_ref.
//
// What bounds it on an H100: the special-function unit.  Every state entry
// and step costs one exponential (one MUFU.EX2), and the SM issues 16 of
// those a clock: at jamba-1.5-large's width (d 16384, N 16, S 4096) that is
// 1.07e9 of them, 0.26 ms at 1.98 GHz, against 0.24 ms for the bytes (x and
// dt read, y written, 12 B per element at float32).  The FP32 pipe carries
// 4 instructions per state entry and step (dt * a, dx * B and two FMAs)
// and the step's shared loads and sum, about half as long.
//
// Design.  Grid (channel blocks of kChannels, batch rows).  Each channel's N
// states are split across threads of up to kStates = 8 states each (2
// threads a channel at N 16, one at N 4 and 8), the threads of a channel in
// adjacent lanes: jamba's width runs 1,024 warps (7.75 an SM, against 512
// of one thread a channel before), each thread with 8 independent state
// chains.  4 states a thread (2,048 warps, 15.5 an SM) and 16 timed slower
// (PERF.md); 8 halve the per-step loads and shuffles per state entry
// against 4, but which of that and the longer chains decides is not
// measured.  The row of A sits in registers, scaled by log2(e), so that
// dA = 2^(dt * a2) is one ex2.approx.ftz (exp2f adds a fix-up for
// subnormal results, expf a range reduction).  y_t's two partial sums at
// N 16 are added by one __shfl_xor_sync, the step loop's only
// cross-thread work (partial sums in shared memory, RWKV6's way, would
// push the block past 48 KB); the first lane of a channel stores y_t to
// shared memory and the chunk leaves as float4 rows once it is done, so the
// step loop holds no global store.
//
// Staging overlaps compute: x and dt of the block's channels and B and C of
// the row arrive kChunk = 32 steps at a time by cp.async (16-byte copies;
// 8-byte copies for bf16 B / C at N 4, whose step rows are 8 bytes) into a
// ring of kStages = 3 chunks, two chunks ahead of the one being computed.
// One __syncthreads per chunk: after it, chunk c has landed for every thread
// (cp.async.wait_group 1 before it), every thread is done with chunk c-1,
// whose buffer then takes chunk c+2, and y of chunk c-1 is complete and is
// written while chunk c runs.  bf16 is staged raw and widened on read.  A
// ragged last chunk copies and computes only its steps; a ragged last
// channel block computes on stale lanes and never stores them.
//
// Inputs x, dt: (Bsz, S, D) with row stride ld elements (ld >= D, ld *
// element size a multiple of 16 bytes: the wrapper pads rows that are not);
// B, C: (Bsz, S, N); all of one type, float32 or bf16, 16-byte aligned.  A:
// float32 (D, N); y: float32 (Bsz, S, ld), 16-byte aligned (columns D..ld
// are scratch).  N is 4, 8 or 16.  All element offsets are 64-bit.  Build
// without --use_fast_math.
//
// The launcher is a plain C function: it launches on the caller's stream
// and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;  // channels per block
constexpr int kStates = 8;     // state entries per thread (at most)
constexpr int kChunk = 32;     // time steps per staged chunk
constexpr int kStages = 3;     // chunks in the ring
constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU.EX2 (2 ulp; results below 2^-126 flush to 0, where
// exp2f would return a subnormal: a decay factor that small leaves a state
// of at most 1e-38 of its old value either way).
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive staged values as floats (bf16 widens by a shift, exactly
// __bfloat162float).
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16), o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16), o[3] = __uint_as_float(v.y & 0xffff0000u);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared memory of one block: the ring (x, dt, B, C of kChunk steps each)
// and two chunks of y.
template <typename T, int N>
struct Smem {
  T x[kStages][kChunk][kChannels];
  T dt[kStages][kChunk][kChannels];
  T B[kStages][kChunk][N];
  T C[kStages][kChunk][N];
  float y[2][kChunk][kChannels];
};

template <int N>
__host__ __device__ constexpr int threads_of() {
  return kChannels * N / (N < kStates ? N : kStates);
}

template <typename T, int N>
__global__ void __launch_bounds__(threads_of<N>())
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, float* __restrict__ y, int64_t S,
                  int64_t D, int64_t ld) {
  constexpr int kThreads = threads_of<N>();
  constexpr int kParts = kThreads / kChannels;      // threads a channel
  constexpr int kS = N / kParts;                    // states a thread
  constexpr int kVec = 16 / sizeof(T);              // elements a 16-byte copy
  constexpr int kRowPieces = kChannels / kVec;      // copies an x step row
  constexpr int kBCBytes = N * sizeof(T) < 16 ? N * sizeof(T) : 16;
  constexpr int kBCVec = kBCBytes / sizeof(T);
  static_assert(kS % 4 == 0, "whole float4s of B and C a thread");
  __shared__ __align__(16) Smem<T, N> sm;

  const int tid = threadIdx.x;
  const int ch = tid / kParts;      // channel within the block
  const int part = tid % kParts;    // which kS states of it
  const int64_t b = blockIdx.y;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kChannels;
  const int64_t d = d0 + ch;
  // 16-byte pieces of an x / dt step row inside the padded row
  const int64_t row_left = ld - d0;
  const int row_pieces = static_cast<int>(
      row_left >= kChannels ? kRowPieces : row_left / kVec);
  const int64_t nchunks = (S + kChunk - 1) / kChunk;
  auto steps = [&](int64_t c) {
    return static_cast<int>(S - c * kChunk < kChunk ? S - c * kChunk
                                                    : kChunk);
  };

  // chunk c into ring buffer c % kStages (nothing past the last chunk), then
  // one commit either way, so that groups and chunks stay one to one
  auto stage = [&](int64_t c) {
    if (c < nchunks) {
      const int64_t t0 = c * kChunk;
      const int n = steps(c);
      const int buf = static_cast<int>(c % kStages);
      for (int q = tid; q < n * row_pieces; q += kThreads) {
        const int tt = q / row_pieces, e = (q % row_pieces) * kVec;
        const int64_t off = (b * S + t0 + tt) * ld + d0 + e;
        cp_async<16>(&sm.x[buf][tt][e], x + off);
        cp_async<16>(&sm.dt[buf][tt][e], dt + off);
      }
      const int64_t bc0 = (b * S + t0) * N;  // B and C chunks are contiguous
      for (int q = tid; q < n * N / kBCVec; q += kThreads) {
        const int e = q * kBCVec;
        cp_async<kBCBytes>(&sm.B[buf][0][0] + e, Bm + bc0 + e);
        cp_async<kBCBytes>(&sm.C[buf][0][0] + e, Cm + bc0 + e);
      }
    }
    cp_async_commit();
  };

  // y of chunk c: float4 rows of the block's channels
  auto finish = [&](int64_t c) {
    const int64_t t0 = c * kChunk;
    const int pieces = row_left >= kChannels ? kChannels / 4
                                             : static_cast<int>(row_left / 4);
    for (int q = tid; q < steps(c) * pieces; q += kThreads) {
      const int tt = q / pieces, e = (q % pieces) * 4;
      *reinterpret_cast<float4*>(y + (b * S + t0 + tt) * ld + d0 + e) =
          *reinterpret_cast<const float4*>(&sm.y[c & 1][tt][e]);
    }
  };

  float a2[kS], st[kS];
#pragma unroll
  for (int n = 0; n < kS; ++n) {
    a2[n] = d < D ? A[d * N + part * kS + n] * kLog2e : 0.f;
    st[n] = 0.f;
  }

  stage(0);
  stage(1);
  for (int64_t c = 0; c < nchunks; ++c) {
    cp_async_wait_one();  // this thread's copies of chunk c have landed
    __syncthreads();      // everyone's have, and everyone is done with
                          // chunk c-1 and with y of chunk c-2
    stage(c + 2);         // into chunk c-1's buffer
    if (c > 0) finish(c - 1);
    const int buf = static_cast<int>(c % kStages);
    const int n = steps(c);
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const float dtv = widen(sm.dt[buf][tt][ch]);
      const float dx = dtv * widen(sm.x[buf][tt][ch]);
      float bv[kS], cv[kS];
#pragma unroll
      for (int k = 0; k < kS; k += 4) {
        load4(&sm.B[buf][tt][part * kS + k], bv + k);
        load4(&sm.C[buf][tt][part * kS + k], cv + k);
      }
      float yv = 0.f;
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const float dA = exp2_ftz(dtv * a2[k]);
        st[k] = fmaf(st[k], dA, dx * bv[k]);
        yv = fmaf(st[k], cv[k], yv);
      }
#pragma unroll
      for (int off = 1; off < kParts; off <<= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (part == 0) sm.y[c & 1][tt][ch] = yv;
    }
  }
  __syncthreads();
  finish(nchunks - 1);
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, int64_t Bsz, int64_t S, int64_t D,
           int64_t ld, cudaStream_t stream) {
  const int64_t blocks = (D + kChannels - 1) / kChannels;
  if (blocks > 2147483647LL || Bsz > 65535) return cudaErrorInvalidValue;
  if (ld < D || ld * static_cast<int64_t>(sizeof(T)) % 16)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(Bsz));
  mamba_scan_kernel<T, N><<<grid, threads_of<N>(), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y), S, D, ld);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(const void* x, const void* dt, const void* A, const void* B,
               const void* C, void* y, int64_t Bsz, int64_t S, int64_t D,
               int64_t ld, int64_t N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, 4>(x, dt, A, B, C, y, Bsz, S, D, ld, stream);
    case 8: return launch<T, 8>(x, dt, A, B, C, y, Bsz, S, D, ld, stream);
    case 16: return launch<T, 16>(x, dt, A, B, C, y, Bsz, S, D, ld, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, dt: (Bsz, S, D) with row stride ld; A: float32 (D, N); B, C:
// (Bsz, S, N); y: float32 (Bsz, S, ld); dtype 0 = float32, 1 = bf16 (x, dt,
// B, C).  x, dt, B, C and y 16-byte aligned, ld * element size a multiple
// of 16 bytes.
int repro_mamba_scan(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, void* y, int64_t Bsz,
                     int64_t S, int64_t D, int64_t ld, int64_t N,
                     int64_t dtype, int64_t device, void* stream) {
  if (Bsz == 0 || S == 0 || D == 0) return cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
       reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return cudaErrorMisalignedAddress;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_n<float>(x, dt, A, B, C, y, Bsz, S, D, ld, N, st);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(x, dt, A, B, C, y, Bsz, S, D, ld, N,
                                     st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
