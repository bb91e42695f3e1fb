// AdamW's update and the sum of squares of its gradients for Hopper (sm_90a).
//
// They replace no TPU kernel: the JAX package's optim/adamw.py is plain jnp,
// which XLA fuses into one pass a leaf.  Run eagerly on the card, the port's
// plain version (repro_torch/optim/adamw.py, global_norm and _update_leaves)
// makes about twenty float32 passes over each leaf, with temporaries as
// large as the leaf.  Here the norm's sum of squares is one pass over the
// gradients and the update one pass over each leaf:
//   sq_norm_partials_kernel + sq_norm_finish_kernel <- global_norm's sum
//   adamw_apply_kernel                              <- _update_leaves
//
// What bounds them on an H100: device-memory bytes.  adamw_apply_kernel
// reads g, p, m and v and writes p, m and v, 22 B an element for bf16
// parameters and gradients with float32 moments, against about twenty
// floating-point operations an element (two divisions and a square root
// among them), far below the card's ratio of operations to bytes.  The norm
// reads each gradient once.
//
// Design.  A thread moves 8 elements at a time: one 16-byte access of a
// bf16 tensor, two of a float32 one, neighbouring threads on neighbouring
// groups.  A leaf whose pointers are not all 16-byte aligned, and the last
// n % 8 elements of any leaf, take one access an element.  Indices are
// 64-bit: a stacked expert leaf of deepseek-moe-16b holds 369 M elements.
// The norm: a fixed grid of kNormBlocks blocks walks tiles of kTile
// elements over a table of up to kMaxLeaves leaves passed by value (more
// leaves take more launches), each block writes one float32 partial sum,
// and one block then adds every partial in a fixed order.  No float atomics:
// two calls on the same gradients give the same bits.
//
// Numerics.  adamw_apply_kernel gives _update_leaves' results bit for bit:
// each product, sum, quotient and root is rounded on its own, as PyTorch's
// element-wise kernels round them (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn, which nvcc never contracts into FMAs); the clip
// runs in the gradient's dtype (g * bf16(scale), rounded to bf16, as
// `g * scale.to(g.dtype)`); the python scalars arrive as the float32 values
// PyTorch casts them to; the moments and the parameter are rounded to
// their dtypes once, at the end.  The clip scale, the bias corrections and
// the learning rate stay on the card and are read through pointers, so the
// step needs no host sync.  The norm's sum is taken in another order than
// torch.sum's (float32 FMAs), so it may differ from the plain version's in
// the last bits.  Build without --use_fast_math.
//
// Each launcher is a plain C function: it launches on the caller's stream
// and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;             // elements a thread moves at once
constexpr int kMaxLeaves = 64;      // leaves of one sq_norm launch
constexpr int kNormBlocks = 1024;   // partial sums of one sq_norm launch
constexpr int kFinishThreads = 1024;
// elements one block of the norm reads a step: two groups a thread
constexpr int64_t kTile = 2 * kThreads * kVec;

// dtype codes of the C interface (kernels/adamw.py::_DTYPE_CODES)
constexpr int64_t kFloat32 = 0;
constexpr int64_t kBFloat16 = 1;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, as a float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// 8 elements from 16-byte aligned src, as floats
__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* src, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // element 2k in the low half (exact)
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// 8 floats to 16-byte aligned dst, rounded to its dtype
__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(bf16* dst, const float (&x)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k + 1])))
            << 16);
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// the update
// ---------------------------------------------------------------------------

// The python scalars of adamw_update as PyTorch hands them to its float32
// kernels: each cast from the double once.
struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps, wd;
};

// _update_leaves on one element, g already clipped and in float32:
//   m = m*b1 + g*(1-b1);  v = v*b2 + (g*g)*(1-b2)
//   u = (m / c1) / (sqrt(v / c2) + eps);  u += wd*p where decayed
//   p = p - u*lr
__device__ __forceinline__ void adamw_one(float& p, float g, float& m,
                                          float& v, const Hyper& h, float c1,
                                          float c2, float lr, bool decay) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.one_minus_b1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.one_minus_b2));
  float u = __fdiv_rn(__fdiv_rn(m, c1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(u, lr));
}

// p, m, v updated in place from g; n elements.  scale is null without
// clipping.  vec: every pointer 16-byte aligned, so groups of 8 move as
// 16-byte accesses; the remaining elements (all of them when !vec) one by
// one.  Grid-stride over 64-bit indices.
template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
    adamw_apply_kernel(P* __restrict__ p, const G* __restrict__ g,
                       M* __restrict__ m, M* __restrict__ v, int64_t n,
                       Hyper h, const float* __restrict__ scale,
                       const float* __restrict__ c1p,
                       const float* __restrict__ c2p,
                       const float* __restrict__ lrp, bool decay, bool vec) {
  const float c1 = *c1p, c2 = *c2p, lr = *lrp;
  const bool clip = scale != nullptr;
  const float sg = clip ? round_to<G>(*scale) : 0.f;  // scale.to(g.dtype)
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t groups = vec ? n / kVec : 0;
  for (int64_t i = t; i < groups; i += stride) {
    const int64_t e = i * kVec;
    float gf[kVec], pf[kVec], mf[kVec], vf[kVec];
    load8(g + e, gf);
    load8(p + e, pf);
    load8(m + e, mf);
    load8(v + e, vf);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float gk = clip ? round_to<G>(__fmul_rn(gf[k], sg)) : gf[k];
      adamw_one(pf[k], gk, mf[k], vf[k], h, c1, c2, lr, decay);
    }
    store8(p + e, pf);
    store8(m + e, mf);
    store8(v + e, vf);
  }
  for (int64_t e = groups * kVec + t; e < n; e += stride) {
    float gk = to_float(g[e]);
    if (clip) gk = round_to<G>(__fmul_rn(gk, sg));
    float pk = to_float(p[e]), mk = to_float(m[e]), vk = to_float(v[e]);
    adamw_one(pk, gk, mk, vk, h, c1, c2, lr, decay);
    p[e] = from_float<P>(pk);
    m[e] = from_float<M>(mk);
    v[e] = from_float<M>(vk);
  }
}

// ---------------------------------------------------------------------------
// the sum of squares
// ---------------------------------------------------------------------------

// Up to kMaxLeaves non-empty leaves, passed by value (1.8 KB of the 4 KB of
// kernel parameters; __grid_constant__, so that indexing it makes no
// per-thread copy).  Leaf l covers tiles [tile0[l], tile0[l + 1]).
struct LeafTable {
  const void* ptr[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t tile0[kMaxLeaves + 1];
  int32_t dtype[kMaxLeaves];
  int32_t count;
};

// acc[k] += x[e + k]^2 for the group of 8 at element e of an n-element leaf
template <typename T>
__device__ __forceinline__ void add_squares(const T* __restrict__ x,
                                            int64_t n, int64_t e, bool vec,
                                            float (&acc)[kVec]) {
  if (vec && e + kVec <= n) {
    float f[kVec];
    load8(x + e, f);
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = fmaf(f[k], f[k], acc[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (e + k < n) {
        const float f = to_float(x[e + k]);
        acc[k] = fmaf(f, f, acc[k]);
      }
  }
}

// Block b adds the squares of tiles b, b + gridDim.x, ... and writes its
// sum to partials[b]: each thread's 8 lanes, then the warp's by shuffles,
// then the block's 8 warps, always in the same order.
__global__ void __launch_bounds__(kThreads)
    sq_norm_partials_kernel(const __grid_constant__ LeafTable t,
                            float* __restrict__ partials) {
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int64_t tiles = t.tile0[t.count];
  int l = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    while (t.tile0[l + 1] <= tile) ++l;  // tiles rise: the cursor only advances
    const int64_t n = t.n[l];
    const int64_t e = (tile - t.tile0[l]) * kTile + threadIdx.x * kVec;
    const bool vec = (reinterpret_cast<uintptr_t>(t.ptr[l]) & 15) == 0;
    if (t.dtype[l] == kBFloat16) {
      const bf16* x = static_cast<const bf16*>(t.ptr[l]);
      add_squares(x, n, e, vec, acc);
      add_squares(x, n, e + kThreads * kVec, vec, acc);
    } else {
      const float* x = static_cast<const float*>(t.ptr[l]);
      add_squares(x, n, e, vec, acc);
      add_squares(x, n, e + kThreads * kVec, vec, acc);
    }
  }
  float s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
            ((acc[4] + acc[5]) + (acc[6] + acc[7]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  __shared__ float warp_sum[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) b += warp_sum[w];
    partials[blockIdx.x] = b;
  }
}

// One block: *out = the sum of count partials, in a fixed order.
__global__ void __launch_bounds__(kFinishThreads)
    sq_norm_finish_kernel(const float* __restrict__ partials, int64_t count,
                          float* __restrict__ out) {
  float s = 0.f;
  for (int64_t i = threadIdx.x; i < count; i += kFinishThreads)
    s += partials[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  __shared__ float warp_sum[kFinishThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.f;
    for (int w = 0; w < kFinishThreads / 32; ++w) b += warp_sum[w];
    *out = b;
  }
}

int64_t norm_launches(int64_t L) { return (L + kMaxLeaves - 1) / kMaxLeaves; }

template <typename P, typename G, typename M>
int launch_apply(void* p, const void* g, void* m, void* v, int64_t n,
                 const Hyper& h, const float* scale, const float* c1,
                 const float* c2, const float* lr, bool decay,
                 cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int64_t work = vec ? n / kVec + n % kVec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) blocks = 2147483647LL;  // the loops stride on
  adamw_apply_kernel<P, G, M><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<M*>(m),
      static_cast<M*>(v), n, h, scale, c1, c2, lr, decay, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int apply_by_moment(int64_t m_dtype, void* p, const void* g, void* m, void* v,
                    int64_t n, const Hyper& h, const float* scale,
                    const float* c1, const float* c2, const float* lr,
                    bool decay, cudaStream_t stream) {
  if (m_dtype == kFloat32)
    return launch_apply<P, G, float>(p, g, m, v, n, h, scale, c1, c2, lr,
                                     decay, stream);
  return launch_apply<P, G, bf16>(p, g, m, v, n, h, scale, c1, c2, lr, decay,
                                  stream);
}

template <typename P>
int apply_by_grad(int64_t g_dtype, int64_t m_dtype, void* p, const void* g,
                  void* m, void* v, int64_t n, const Hyper& h,
                  const float* scale, const float* c1, const float* c2,
                  const float* lr, bool decay, cudaStream_t stream) {
  if (g_dtype == kFloat32)
    return apply_by_moment<P, float>(m_dtype, p, g, m, v, n, h, scale, c1, c2,
                                     lr, decay, stream);
  return apply_by_moment<P, bf16>(m_dtype, p, g, m, v, n, h, scale, c1, c2,
                                  lr, decay, stream);
}

bool known_dtype(int64_t code) { return code == kFloat32 || code == kBFloat16; }

}  // namespace

extern "C" {

// Floats of scratch that repro_sq_norm needs for L leaves.
int64_t repro_sq_norm_partials(int64_t L) {
  return kNormBlocks * norm_launches(L);
}

// *out = the sum over the L leaves of their squared elements, in float32.
// ptrs / ns / dtypes are host arrays: each leaf's device pointer, element
// count and dtype code.  partials: device scratch of
// repro_sq_norm_partials(L) floats.
int repro_sq_norm(const void* const* ptrs, const int64_t* ns,
                  const int64_t* dtypes, int64_t L, void* partials, void* out,
                  int64_t device, void* stream) {
  if (L <= 0) return cudaErrorInvalidValue;
  for (int64_t i = 0; i < L; ++i)
    if (ns[i] < 0 || !known_dtype(dtypes[i])) return cudaErrorInvalidValue;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  const int64_t launches = norm_launches(L);
  for (int64_t c = 0; c < launches; ++c) {
    LeafTable t = {};
    int64_t tiles = 0;
    for (int64_t i = c * kMaxLeaves; i < L && i < (c + 1) * kMaxLeaves; ++i) {
      if (ns[i] == 0) continue;
      t.ptr[t.count] = ptrs[i];
      t.n[t.count] = ns[i];
      t.dtype[t.count] = static_cast<int32_t>(dtypes[i]);
      t.tile0[t.count] = tiles;
      tiles += (ns[i] + kTile - 1) / kTile;
      ++t.count;
    }
    t.tile0[t.count] = tiles;
    sq_norm_partials_kernel<<<kNormBlocks, kThreads, 0, s>>>(
        t, part + c * kNormBlocks);
    err = static_cast<int>(cudaGetLastError());
    if (err != cudaSuccess) return err;
  }
  sq_norm_finish_kernel<<<1, kFinishThreads, 0, s>>>(
      part, launches * kNormBlocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One AdamW step on one leaf of n elements, in place: p (p_dtype), g
// (g_dtype), m and v (m_dtype).  scale (null: no clipping), c1, c2 and lr
// are device float32 scalars; b1 ... wd the python scalars as float32;
// decay: p has two or more dimensions.
int repro_adamw_apply(void* p, const void* g, void* m, void* v, int64_t n,
                      int64_t p_dtype, int64_t g_dtype, int64_t m_dtype,
                      const void* scale, const void* c1, const void* c2,
                      const void* lr, float b1, float b2, float one_minus_b1,
                      float one_minus_b2, float eps, float wd, int64_t decay,
                      int64_t device, void* stream) {
  if (n < 0 || !known_dtype(p_dtype) || !known_dtype(g_dtype) ||
      !known_dtype(m_dtype) || c1 == nullptr || c2 == nullptr || lr == nullptr)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const Hyper h = {b1, b2, one_minus_b1, one_minus_b2, eps, wd};
  const float* sc = static_cast<const float*>(scale);
  const float* c1f = static_cast<const float*>(c1);
  const float* c2f = static_cast<const float*>(c2);
  const float* lrf = static_cast<const float*>(lr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == kFloat32)
    return apply_by_grad<float>(g_dtype, m_dtype, p, g, m, v, n, h, sc, c1f,
                                c2f, lrf, decay != 0, s);
  return apply_by_grad<bf16>(g_dtype, m_dtype, p, g, m, v, n, h, sc, c1f, c2f,
                             lrf, decay != 0, s);
}

}  // extern "C"
