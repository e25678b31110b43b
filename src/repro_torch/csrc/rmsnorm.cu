// RMSNorm over the last axis on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm_pallas`
// (src/repro/kernels/rmsnorm.py, body `_rmsnorm_kernel`), which normalises
// a [bm, d] row tile per grid step in VMEM.
//
// Semantics (repro_torch/kernels/ref.py rmsnorm, within a float tolerance:
// the sum of squares is taken in another order):
//   out[r, :] = cast(x_f32[r, :] * rsqrt(mean(x_f32[r, :]^2) + eps)
//                    * gamma_f32)
// with one cast to x's dtype at the end (the normalised x is not rounded
// before the gamma product). x, gamma and out share one dtype: f32 or bf16.
//
// Bound on this card: memory. A launch must read R*d elements of x and d of
// gamma and write R*d elements; it does 4 flops an element.
//
// Two bodies; the launch plan (repro_torch/kernels/rmsnorm.py
// `rmsnorm_plan`) picks one from the shape and the alignment before the
// launch, and this file checks it:
//
// * register body (d a multiple of the 16-byte vector, 16-byte aligned
//   pointers, d <= 32 * W * kSlots vectors: up to 8192 bf16 / 4096 f32):
//   a group of G = 32 * W lanes (W = 1, 2, 4 or 8 warps) owns a row; lane
//   t holds vectors t, t + G, t + 2G, t + 3G of it, and the same vectors of
//   gamma, in registers. Every load of a lane is issued before its first
//   use, the row is read from device memory once, and the lane scales and
//   stores from its registers (16-byte stores). The sum of squares is a
//   butterfly of warp shuffles, plus one shared-memory step when W > 1. A
//   block holds 256 / G rows (d = 896 bf16: a warp a row, 3.5 of 4 slots a
//   lane, 8 rows a block), one block per tile of rows.
// * block body (any other d or alignment): one block per row, 16-byte
//   vectors where d and the pointers allow them, else single elements; a
//   block reduction, then a second pass over the row (from L1/L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
// register body: 16-byte vectors of a row a lane holds, and at most 85
// registers a thread, so that 3 blocks of 256 threads stay on an SM
constexpr int kSlots = 4;
constexpr int kMinBlocks = 3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);              // round to nearest even
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// -- block body: one block per row ------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_block(const T* __restrict__ x, const T* __restrict__ gamma,
              T* __restrict__ out, int d, float eps) {
  using P = Pack<T, VEC>;
  __shared__ float warp_sum[kMaxThreads / 32];
  const size_t row = blockIdx.x;
  const int nvec = d / VEC;
  const P* xrow = reinterpret_cast<const P*>(x + row * d);
  const P* g = reinterpret_cast<const P*>(gamma);
  P* orow = reinterpret_cast<P*>(out + row * d);

  float ss = 0.f;
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    const P p = xrow[j];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f32(p.v[e]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sum[warp] = ss;
  __syncthreads();
  float total = 0.f;
  const int nwarps = blockDim.x >> 5;
  for (int w = 0; w < nwarps; ++w) total += warp_sum[w];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    const P p = xrow[j];
    const P gp = g[j];
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_f32<T>(to_f32(p.v[e]) * r * to_f32(gp.v[e]));
    orow[j] = o;
  }
}

// -- register body: a group of 32 * W lanes per row -------------------------

// A 16-byte vector as raw words, so that masked slots are plain zeros.
// bf16 element 2i is the low half of word i (little-endian).
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static float get(const uint4& u, int e) {
    const uint32_t w = e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w;
    return __uint_as_float(w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static float get(const uint4& u, int e) {
    const int i = e >> 1;
    const uint32_t w = i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <typename T>
__device__ __forceinline__ uint4 scale_vec(const uint4& xv,
                                           const uint4& gv, float r);
template <>
__device__ __forceinline__ uint4 scale_vec<float>(const uint4& xv,
                                              const uint4& gv, float r) {
  using V = Vec16<float>;
  uint4 o;
  o.x = __float_as_uint(V::get(xv, 0) * r * V::get(gv, 0));
  o.y = __float_as_uint(V::get(xv, 1) * r * V::get(gv, 1));
  o.z = __float_as_uint(V::get(xv, 2) * r * V::get(gv, 2));
  o.w = __float_as_uint(V::get(xv, 3) * r * V::get(gv, 3));
  return o;
}
template <>
__device__ __forceinline__ uint4 scale_vec<__nv_bfloat16>(const uint4& xv,
                                                      const uint4& gv,
                                                      float r) {
  using V = Vec16<__nv_bfloat16>;
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = V::get(xv, 2 * i) * r * V::get(gv, 2 * i);
    const float hi = V::get(xv, 2 * i + 1) * r * V::get(gv, 2 * i + 1);
    w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
            << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int W>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
rmsnorm_regs(const T* __restrict__ x, const T* __restrict__ gamma,
             T* __restrict__ out, int R, int d, float eps) {
  constexpr int VEC = Vec16<T>::kN;
  constexpr int G = 32 * W;
  __shared__ float warp_sum[kMaxThreads / 32];
  const int nvec = d / VEC;
  const int group = threadIdx.x / G;       // the row of the block
  const int lane = threadIdx.x % G;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / G) + group;
  const bool live = row < R;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + row * nvec + lane;
  const uint4* gv = reinterpret_cast<const uint4*>(gamma) + lane;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // every load first (a masked slot or a row past R reads as zeros), then
  // the sums: loads guarded inside the sum loop would be issued one by one
  bool on[kSlots];
  uint4 xs[kSlots], gs[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    on[k] = k * G + lane < nvec;
    gs[k] = on[k] ? gv[k * G] : zero;
    xs[k] = on[k] && live ? xv[k * G] : zero;
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = Vec16<T>::get(xs[k], e);
      ss = fmaf(f, f, ss);
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if constexpr (W > 1) {
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = warp_sum[group * W];
#pragma unroll
    for (int w = 1; w < W; ++w) ss += warp_sum[group * W + w];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  if (!live) return;
  uint4* ov = reinterpret_cast<uint4*>(out) + row * nvec + lane;
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    if (on[k]) ov[k * G] = scale_vec<T>(xs[k], gs[k], r);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, void* out, int R, int d,
                   float eps, int body, int vec, int warps,
                   int rows_per_block, int grid, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  T* op = static_cast<T*>(out);
  const bool vectors = vec == kVec && d % kVec == 0 && aligned16(x) &&
                       aligned16(gamma) && aligned16(out);
  if (warps < 1 || rows_per_block < 1 ||
      warps * rows_per_block > kMaxThreads / 32 ||
      grid != (static_cast<long long>(R) + rows_per_block - 1) /
                  rows_per_block ||
      !(vectors || (body == 0 && vec == 1)))
    return cudaErrorInvalidValue;
  const int threads = 32 * warps * rows_per_block;
  if (body == 0) {                         // block body
    if (rows_per_block != 1) return cudaErrorInvalidValue;
    if (vectors)
      rmsnorm_block<T, kVec><<<grid, threads, 0, stream>>>(xp, gp, op, d,
                                                             eps);
    else
      rmsnorm_block<T, 1><<<grid, threads, 0, stream>>>(xp, gp, op, d, eps);
    return cudaGetLastError();
  }
  if (body != 1 || 32 * warps * kSlots < d / kVec)
    return cudaErrorInvalidValue;
  switch (warps) {
    case 1: rmsnorm_regs<T, 1><<<grid, threads, 0, stream>>>(xp, gp, op, R,
                                                             d, eps); break;
    case 2: rmsnorm_regs<T, 2><<<grid, threads, 0, stream>>>(xp, gp, op, R,
                                                             d, eps); break;
    case 4: rmsnorm_regs<T, 4><<<grid, threads, 0, stream>>>(xp, gp, op, R,
                                                             d, eps); break;
    case 8: rmsnorm_regs<T, 8><<<grid, threads, 0, stream>>>(xp, gp, op, R,
                                                             d, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16. body: 0 = block per row, 1 = registers; vec,
// warps, rows_per_block and grid as the plan gives them
// (repro_torch/kernels/rmsnorm.py `RmsnormPlan`). Launches on `stream` of
// `device` and returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue for a plan this file cannot run). Does not
// synchronise; sets the device only when it is not current already.
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* out,
                              int R, int d, float eps, int dtype, int body,
                              int vec, int warps, int rows_per_block,
                              int grid, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  if (R == 0 || d == 0) return cudaSuccess;
  if (R < 0 || d < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, out, R, d, eps, body, vec, warps,
                         rows_per_block, grid, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, out, R, d, eps, body, vec, warps,
                                 rows_per_block, grid, s);
  return cudaErrorInvalidValue;
}
