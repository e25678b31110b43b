// RMSNorm backward over the last axis on Hopper (sm_90a).
//
// The Pallas TPU kernel `rmsnorm_pallas` (src/repro/kernels/rmsnorm.py)
// has no backward: there is no custom_vjp on it, and the JAX package
// trains through the jnp rmsnorm. This kernel is the port's own, so that
// training on the card runs on hand-written kernels end to end.
//
// Semantics (repro_torch/kernels/ref.py rmsnorm_backward, within a float
// tolerance: the sums are taken in another order), for x [R, d], gamma
// [d] and the output's gradient g [R, d], contiguous, one dtype (f32 or
// bf16), f32 math:
//   rstd   = rsqrt(mean(x^2) + eps)            (recomputed from x)
//   dx     = rstd * (g*gamma - x*rstd * mean(g*gamma*x*rstd))
//   dgamma = sum over rows of g * x * rstd
// dx cast once to x's dtype, dgamma once to gamma's.
//
// Deterministic: no atomics, every sum in a fixed order.
//   1. One block per chunk of consecutive rows. For each row the block
//      sums x^2 and g*gamma*x (a butterfly of shuffles a warp, then the
//      warps' partials in order), writes dx in a second pass over the row
//      (from L1/L2), and adds g*x*rstd to its per-column partial of dgamma
//      in shared memory, each column owned by one thread.
//   2. One thread per column sums the chunks' partials in chunk order.
//
// Bound on this card: memory. A launch must read x and g (R*d elements
// each) and gamma, and write dx (R*d) and dgamma; the [chunks, d] f32
// partials add 2 * chunks * d * 4 bytes (1024 chunks at most).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ gamma,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ partial, int R, int d, float eps,
                 int rows_per_chunk) {
  extern __shared__ float acc[];              // [d] this chunk's dgamma
  __shared__ float red[2][2][kWarps];         // [row parity][sum][warp]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.x * rows_per_chunk;
  const int r1 = min(R, r0 + rows_per_chunk);
  for (int c = tid; c < d; c += kThreads) acc[c] = 0.f;

  for (int r = r0; r < r1; ++r) {
    const T* xr = x + static_cast<long long>(r) * d;
    const T* gr = g + static_cast<long long>(r) * d;
    float ss = 0.f, sg = 0.f;
    for (int c = tid; c < d; c += kThreads) {
      const float xv = to_f32(xr[c]);
      ss += xv * xv;
      sg += to_f32(gr[c]) * to_f32(gamma[c]) * xv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sg += __shfl_xor_sync(0xffffffffu, sg, off);
    }
    // two buffers by row parity: a warp writing row r + 1's partials
    // cannot overwrite row r's before every warp has read them (row r + 1's
    // barrier comes after those reads)
    const int par = (r - r0) & 1;
    if (lane == 0) {
      red[par][0][warp] = ss;
      red[par][1][warp] = sg;
    }
    __syncthreads();
    ss = sg = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ss += red[par][0][w];
      sg += red[par][1][w];
    }
    const float rstd = rsqrtf(ss / d + eps);
    // x*rstd * mean(g*gamma*x*rstd) = x * (rstd^2 * sg / d)
    const float coef = rstd * rstd * sg / d;
    T* dxr = dx + static_cast<long long>(r) * d;
    for (int c = tid; c < d; c += kThreads) {
      const float xv = to_f32(xr[c]);
      const float gv = to_f32(gr[c]);
      dxr[c] = from_f32<T>(rstd * (gv * to_f32(gamma[c]) - xv * coef));
      acc[c] += gv * xv * rstd;
    }
  }
  // each column's partial was written by the thread that reads it here
  for (int c = tid; c < d; c += kThreads)
    partial[static_cast<long long>(blockIdx.x) * d + c] = acc[c];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_gamma(const float* __restrict__ partial, T* __restrict__ dgamma,
                  int chunks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k)
    s += partial[static_cast<long long>(k) * d + c];
  dgamma[c] = from_f32<T>(s);
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* g, void* dx,
                   void* dgamma, void* partial, int R, int d, float eps,
                   int chunks, cudaStream_t stream) {
  const int rows_per_chunk = (R + chunks - 1) / chunks;
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_rows<T><<<chunks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(partial), R, d, eps, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_gamma<T><<<(d + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(static_cast<const float*>(partial),
                                   static_cast<T*>(dgamma), chunks, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16. x, g, dx [R, d] and gamma, dgamma [d]
// contiguous; `partial` a [chunks, d] f32 scratch buffer with
// 1 <= chunks <= R, and every chunk of ceil(R / chunks) rows holding at
// least one row (the wrapper picks chunks so). Launches two kernels on
// `stream` of `device` and returns the first failing launch's cudaError_t
// (0 on success). Does not synchronise.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* gamma,
                                  const void* g, void* dx, void* dgamma,
                                  void* partial, int R, int d, float eps,
                                  int chunks, int dtype, int device,
                                  void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  if (R <= 0 || d <= 0 || chunks <= 0 || chunks > R)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, g, dx, dgamma, partial, R, d, eps, chunks,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, g, dx, dgamma, partial, R, d, eps,
                                 chunks, s);
  return cudaErrorInvalidValue;
}
