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
// Design: one block per row. Each thread takes 16-byte vectors of the row
// (8 bf16 or 4 f32; single elements when d or an address does not allow
// vectors), sums their squares in f32, and the block reduces the sum with
// warp shuffles and one shared-memory step. A second pass re-reads its
// vectors (from L1/L2: the row was just read by this block), applies the
// scale and gamma, and writes. Any R >= 0 and any d > 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;

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

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
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

template <typename T>
cudaError_t launch(const void* x, const void* gamma, void* out, int R, int d,
                   float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(gamma) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int nvec = vec ? d / kVec : d;
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                        : threads);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  T* op = static_cast<T*>(out);
  if (vec)
    rmsnorm_kernel<T, kVec><<<R, threads, 0, stream>>>(xp, gp, op, d, eps);
  else
    rmsnorm_kernel<T, 1><<<R, threads, 0, stream>>>(xp, gp, op, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16. Launches on `stream` of `device` and returns
// the launch's cudaError_t (0 on success). Does not synchronise.
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* out,
                              int R, int d, float eps, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R == 0 || d == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, gamma, out, R, d, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, gamma, out, R, d, eps, s);
  return cudaErrorInvalidValue;
}
