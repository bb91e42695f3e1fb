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
// w * S + k * v); the state never leaves the SM.  One head's steps form one
// chain, so a block works on one head, and rwkv6-1.6b's B 8 x H 32 puts two
// heads on most of the 132 SMs.  Which SM resource then sets the time (the
// issue of the 4 * hd * hd floating-point instructions a step, the
// shared-memory loads that feed them, or latency) is not measured yet.
//
// Design.  One block per (batch, head).  The hd x hd state is cut into
// tiles of hd / kSplit rows by kCols columns, one tile a thread, in
// registers: at hd 64, 8 rows x 4 columns, 128 threads (4 warps); at hd 32,
// 4 x 4, 64 threads; at hd 16, 4 x 2, 32 threads, so every head fills whole
// warps and none is packed with another.  A step's r_t, k_t, w_t values of
// a row feed all the columns of the thread's tile: 4 columns a thread read
// each of them a quarter as often as one column a thread (shared-memory
// loads per state entry 7/32 instead of 13/16); of the tilings timed, this
// one was the fastest (PERF.md).
// Each thread adds its rows' terms of o_t[j] for its columns and stores
// the sums to shared memory; once the chunk is done, the row slices'
// partial sums are added pairwise as a tree and written as float4 rows, so
// the step loop holds no shuffle and no global store.  The state update per
// element is the fmaf of the reference order; only the summation order of
// o_t[j] differs from a column walked by one thread.
//
// Staging overlaps compute: r, k, w, v arrive kChunk = 16 time steps at a
// time by cp.async (16-byte copies, L2 only) into a ring of kStages = 3
// buffers, two chunks ahead of the one being computed.  One __syncthreads
// per chunk: after it, chunk c has landed for every thread
// (cp.async.wait_group 1 before it), every thread is done with chunk c-1,
// whose buffer then takes chunk c+2, and the partial sums of chunk c-1 are
// complete and are added up while chunk c runs.  bf16 tiles are staged raw
// and widened on read.  Shared memory is dynamic: the ring,
// kStages * 4 * kChunk * hd inputs, and two chunks of partial sums,
// 2 * kChunk * kSplit * hd floats; 112 KB at hd 64 and float32, so the
// launcher opts in with cudaFuncSetAttribute (two blocks fit an SM; 32
// steps a chunk would leave one, 8 steps timed slower).  The launcher
// passes kChunk to the kernel as an argument: with the chunk a
// compile-time constant in the kernel, ptxas schedules the step loop
// differently (86 registers instead of 136 at hd 64, float32) and the scan
// takes longer at rwkv6-1.6b (PERF.md).  No time padding is needed (the Pallas kernel pads
// w with 1.0 to a whole chunk): a ragged last chunk copies and computes
// only its steps.
//
// Inputs are (B, S, H, hd), contiguous, 16-byte aligned, float32 or bf16; u
// is float32 (Bu, H, hd) with Bu = 1 (one bonus per head, shared by the
// batch) or Bu = B; the output is float32 (B, S, H, hd).  All element offsets
// are 64-bit.  Build without --use_fast_math.
//
// The launcher is a plain C function: it launches on the caller's stream
// and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;   // time steps a staged chunk (the launcher's)
constexpr int kStages = 3;   // chunk buffers in the ring
constexpr int kUnroll = 4;   // time steps unrolled in the step loop
constexpr int kMaxSmem = 232448;

// Row slices of the state: a thread takes hd / split_of(hd) rows (8 at hd
// 64, 4 at hd 32 and 16) of cols_of(hd) columns (4, or 2 at hd 16, so that
// a head still fills a warp).
__host__ __device__ constexpr int split_of(int hd) {
  return hd / 4 < 8 ? hd / 4 : 8;
}
__host__ __device__ constexpr int cols_of(int hd) { return hd == 16 ? 2 : 4; }
__host__ __device__ constexpr int threads_of(int hd) {
  return split_of(hd) * hd / cols_of(hd);
}

// N consecutive staged values (N = 2, 4) from shared memory as floats;
// bf16 widens by a shift (exactly __bfloat162float).
template <int N>
__device__ __forceinline__ void loadn(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x, o[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void loadn(const __nv_bfloat16* p, float (&o)[N]) {
  uint32_t word[N / 2];
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    word[0] = v.x, word[1] = v.y;
  } else {
    word[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int q = 0; q < N; ++q)  // little-endian: element 2m in the low half
    o[q] = __uint_as_float(q & 1 ? word[q / 2] & 0xffff0000u
                                 : word[q / 2] << 16);
}
template <int N>
__device__ __forceinline__ void storen(float* p, const float (&x)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Dynamic shared memory of one block: the ring of input chunks, then two
// chunks of partial outputs (one row per slice).
int64_t smem_bytes(int64_t hd, int64_t esize) {
  return kStages * 4 * kChunk * hd * esize +
         2 * kChunk * split_of(static_cast<int>(hd)) * hd * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(threads_of(HD))
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ o,
                  int64_t S, int64_t H, int64_t u_batch_stride, int chunk) {
  constexpr int kSplit = split_of(HD);
  constexpr int kCols = cols_of(HD);
  constexpr int kThreads = threads_of(HD);
  static_assert(kCols == 2 || kCols == 4, "2 or 4 columns");
  constexpr int kRows = HD / kSplit;      // state rows per thread
  constexpr int kChains = 4 / kCols;      // partial sums per column, 1 or 2
  constexpr int kVec = 16 / sizeof(T);    // elements per cp.async
  constexpr int kPieces = HD / kVec;      // cp.asyncs per step row
  extern __shared__ __align__(16) unsigned char smem[];
  // input buffer b, tensor m (r, k, w, v), step tt:
  //   ring + ((b * 4 + m) * chunk + tt) * HD
  T* ring = reinterpret_cast<T*>(smem);
  // partial outputs, buffer p, step tt, row slice q:
  //   parts + ((p * chunk + tt) * kSplit + q) * HD
  float* parts = reinterpret_cast<float*>(
      smem + kStages * 4 * chunk * HD * sizeof(T));

  const int tid = threadIdx.x;
  const int slice = tid / (HD / kCols);      // 2 or 4 slices a warp
  const int j = tid % (HD / kCols) * kCols;  // first state column
  const int i0 = slice * kRows;              // first state row
  const int64_t b = blockIdx.x / H;
  const int64_t h = blockIdx.x % H;
  const int64_t row = H * HD;
  const int64_t base = b * S * row + h * HD;
  const int64_t nchunks = (S + chunk - 1) / chunk;
  auto steps = [&](int64_t c) {
    return static_cast<int>(S - c * chunk < chunk ? S - c * chunk : chunk);
  };

  // chunk c into input buffer c % kStages (nothing past the last chunk),
  // then one commit either way, so that groups and chunks stay one to one
  auto stage = [&](int64_t c) {
    if (c < nchunks) {
      const int64_t t0 = c * chunk;
      const int n = steps(c);
      T* dst = ring + (c % kStages) * 4 * chunk * HD;
      const T* src[4] = {r, k, w, v};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        for (int q = tid; q < n * kPieces; q += kThreads) {
          const int tt = q / kPieces, e = (q % kPieces) * kVec;
          cp_async16(dst + (m * chunk + tt) * HD + e,
                     src[m] + base + (t0 + tt) * row + e);
        }
      }
    }
    cp_async_commit();
  };

  // o of chunk c: the row slices' partials summed pairwise as a tree, 4
  // columns a thread, float4 stores (a warp writes whole 256-byte step rows
  // at hd 64)
  auto finish = [&](int64_t c) {
    const float* pc = parts + (c & 1) * chunk * kSplit * HD;
    const int64_t t0 = c * chunk;
    for (int q = tid; q < steps(c) * (HD / 4); q += kThreads) {
      const int tt = q / (HD / 4), c4 = (q % (HD / 4)) * 4;
      float4 sum[kSplit];
#pragma unroll
      for (int s = 0; s < kSplit; ++s)
        sum[s] = *reinterpret_cast<const float4*>(
            pc + (tt * kSplit + s) * HD + c4);
#pragma unroll
      for (int width = 1; width < kSplit; width *= 2)
#pragma unroll
        for (int s = 0; s < kSplit; s += 2 * width) {
          sum[s].x += sum[s + width].x;
          sum[s].y += sum[s + width].y;
          sum[s].z += sum[s + width].z;
          sum[s].w += sum[s + width].w;
        }
      *reinterpret_cast<float4*>(o + base + (t0 + tt) * row + c4) = sum[0];
    }
  };

  float st[kRows][kCols], uu[kRows];
  const float* ub = u + b * u_batch_stride + h * HD + i0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    uu[i] = ub[i];
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) st[i][cc] = 0.f;
  }

  stage(0);
  stage(1);
  for (int64_t c = 0; c < nchunks; ++c) {
    cp_async_wait_one();  // this thread's copies of chunk c have landed
    __syncthreads();      // everyone's have, and everyone is done with
                          // chunk c-1 and with the partials of chunk c-2
    stage(c + 2);         // into chunk c-1's input buffer
    if (c > 0) finish(c - 1);
    const T* buf = ring + (c % kStages) * 4 * chunk * HD;
    float* pc = parts + (c & 1) * chunk * kSplit * HD + slice * HD + j;
    const int n = steps(c);
#pragma unroll kUnroll
    for (int tt = 0; tt < n; ++tt) {
      const T* rt = buf + (0 * chunk + tt) * HD + i0;
      const T* kt = buf + (1 * chunk + tt) * HD + i0;
      const T* wt = buf + (2 * chunk + tt) * HD + i0;
      float vj[kCols];
      loadn<kCols>(buf + (3 * chunk + tt) * HD + j, vj);
      float part[kCols][kChains] = {};
#pragma unroll
      for (int i4 = 0; i4 < kRows / 4; ++i4) {
        float rs[4], ks[4], ws[4];
        loadn<4>(rt + 4 * i4, rs);
        loadn<4>(kt + 4 * i4, ks);
        loadn<4>(wt + 4 * i4, ws);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * i4 + q;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            float& acc = part[cc][q % kChains];
            const float kv = ks[q] * vj[cc];
            acc = fmaf(rs[q], fmaf(uu[i], kv, st[i][cc]), acc);
            st[i][cc] = fmaf(ws[q], st[i][cc], kv);
          }
        }
      }
      float sum[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        if constexpr (kChains == 2)
          sum[cc] = part[cc][0] + part[cc][1];
        else
          sum[cc] = part[cc][0];
      }
      storen<kCols>(pc + tt * kSplit * HD, sum);
    }
  }
  __syncthreads();
  finish(nchunks - 1);
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* o, int64_t B, int64_t S, int64_t H,
           int64_t u_batch_stride, cudaStream_t stream) {
  if (B * H > 2147483647LL) return cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(HD, sizeof(T));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // opt in, and ask for all of L1 as shared memory
    int err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv6_scan_kernel<T, HD>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  rwkv6_scan_kernel<T, HD>
      <<<static_cast<unsigned>(B * H), threads_of(HD), smem, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(w),
          static_cast<const float*>(u), static_cast<float*>(o), S, H,
          u_batch_stride, kChunk);
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

// Dynamic shared memory of one block, in bytes, for head width hd, dtype
// (0 = float32, 1 = bf16); -1 for a width or type the kernel does not take.
int64_t repro_rwkv6_scan_smem(int64_t hd, int64_t dtype) {
  const int64_t esize = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (esize == 0 || (hd != 16 && hd != 32 && hd != 64)) return -1;
  return smem_bytes(hd, esize);
}

// r, k, v, w: (B, S, H, hd), 16-byte aligned; u: float32 (Bu, H, hd),
// u_batch_stride = 0 when Bu = 1, else H * hd; o: float32 (B, S, H, hd);
// dtype 0 = float32, 1 = bf16.
int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* o, int64_t B,
                     int64_t S, int64_t H, int64_t hd, int64_t u_batch_stride,
                     int64_t dtype, int64_t device,
                     void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) % 16)
    return cudaErrorMisalignedAddress;
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
