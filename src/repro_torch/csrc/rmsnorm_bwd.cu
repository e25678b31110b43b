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
// Deterministic: no atomics, every sum in a fixed order. The launch plan
// of the forward (repro_torch/kernels/rmsnorm.py `rmsnorm_plan`) picks the
// body:
//   * register body (the plan's register body: d a multiple of the 16-byte
//     vector, 16-byte aligned x, g, gamma and dx, d <= 32 * W * kSlots
//     vectors): the forward's layout. A group of G = 32 * W lanes owns a
//     row; lane t holds vectors t, t + G, t + 2G, t + 3G of x and g as
//     16-byte words in registers (gamma, loaded once, in shared memory),
//     so each row is read once. Both row sums (sum x^2 and sum g*gamma*x)
//     run in one butterfly (plus one shared-memory step when W > 1), and
//     dx is written from the registers. A block of 256 threads holds
//     256 / G groups and owns a chunk of consecutive rows, which its groups
//     take in turn (group q: rows q, q + 256 / G, ...). Each lane owns the
//     same columns in every row, so its dgamma partial over the chunk
//     stays in registers; the groups' partials are added in group order
//     in shared memory into the chunk's row of `partial`.
//   * block body (any other input): one block per chunk of consecutive
//     rows. For each row the block sums x^2 and g*gamma*x (a butterfly of
//     shuffles a warp, then the warps' partials in order), writes dx in a
//     second pass over the row (from L1/L2), and adds g*x*rstd to its
//     per-column partial of dgamma in shared memory, each column owned by
//     one thread.
// Then a second kernel sums the chunks' partials of each column: eight
// runs of consecutive chunks, each in chunk order, then the runs in order.
//
// Bound on this card: memory. A launch must read x and g (R*d elements
// each) and gamma, and write dx (R*d) and dgamma; the [chunks, d] f32
// partials add 2 * chunks * d * 4 bytes.

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

// -- register body -----------------------------------------------------------

// 16-byte vectors of a row a lane holds (the forward's kSlots); at most
// 128 registers a thread, so that two blocks of 256 threads stay on an SM
// (bf16 takes 113-117 with gamma in shared memory; with gamma in
// registers too it took 158, one block an SM)
constexpr int kSlots = 4;
constexpr int kRegsMinBlocks = 2;

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

// one 16-byte vector of f32 or (eight) bf16 values, rounded to nearest
__device__ __forceinline__ uint4 pack_vec(const float (&o)[4]) {
  return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                    __float_as_uint(o[2]), __float_as_uint(o[3]));
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(x)));
}
__device__ __forceinline__ uint4 pack_vec(const float (&o)[8]) {
  return make_uint4(bf16_bits(o[0]) | bf16_bits(o[1]) << 16,
                    bf16_bits(o[2]) | bf16_bits(o[3]) << 16,
                    bf16_bits(o[4]) | bf16_bits(o[5]) << 16,
                    bf16_bits(o[6]) | bf16_bits(o[7]) << 16);
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, kRegsMinBlocks)
rmsnorm_bwd_regs(const T* __restrict__ x, const T* __restrict__ gamma,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ partial, int R, int d, float eps,
                 int rows_per_chunk) {
  constexpr int VEC = Vec16<T>::kN;
  constexpr int G = 32 * W;                   // lanes a row
  constexpr int NG = kThreads / G;            // groups (rows at once) a block
  using V = Vec16<T>;
  // [nvec] gamma's vectors, then [NG][d] the groups' dgamma
  extern __shared__ uint4 smem[];
  uint4* sgam = smem;
  float* part = reinterpret_cast<float*>(smem + d / VEC);
  __shared__ float red[2][2][kWarps];         // [row parity][sum][warp]
  const int nvec = d / VEC;
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const int warp = threadIdx.x / 32;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long r1 = min(static_cast<long long>(R), r0 + rows_per_chunk);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // gamma is read once, into shared memory (in registers it would push
  // the lane past 128 registers)
  for (int j = threadIdx.x; j < nvec; j += kThreads)
    sgam[j] = reinterpret_cast<const uint4*>(gamma)[j];
  bool on[kSlots];
  float acc[kSlots][VEC];                     // this lane's dgamma partial
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    on[k] = k * G + lane < nvec;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
  }
  __syncthreads();

  const int steps = (rows_per_chunk + NG - 1) / NG;
  for (int it = 0; it < steps; ++it) {
    const long long row = r0 + static_cast<long long>(it) * NG + grp;
    const bool live = row < r1;
    const uint4* xr = reinterpret_cast<const uint4*>(x) + row * nvec + lane;
    const uint4* gr = reinterpret_cast<const uint4*>(g) + row * nvec + lane;
    // every load first (a masked slot or a row past the chunk reads as
    // zeros), then the sums
    uint4 xs[kSlots], gs[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      xs[k] = on[k] && live ? xr[k * G] : zero;
      gs[k] = on[k] && live ? gr[k * G] : zero;
    }
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const uint4 gm = on[k] ? sgam[k * G + lane] : zero;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xv = V::get(xs[k], e);
        ss = fmaf(xv, xv, ss);
        sg = fmaf(V::get(gs[k], e) * V::get(gm, e), xv, sg);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sg += __shfl_xor_sync(0xffffffffu, sg, off);
    }
    if constexpr (W > 1) {
      // two buffers by row parity, as in rmsnorm_bwd_rows
      const int par = it & 1;
      if ((threadIdx.x & 31) == 0) {
        red[par][0][warp] = ss;
        red[par][1][warp] = sg;
      }
      __syncthreads();
      ss = red[par][0][grp * W];
      sg = red[par][1][grp * W];
#pragma unroll
      for (int w = 1; w < W; ++w) {
        ss += red[par][0][grp * W + w];
        sg += red[par][1][grp * W + w];
      }
    }
    if (!live) continue;
    const float rstd = rsqrtf(ss / d + eps);
    // x*rstd * mean(g*gamma*x*rstd) = x * (rstd^2 * sg / d)
    const float coef = rstd * rstd * sg / d;
    uint4* dxr = reinterpret_cast<uint4*>(dx) + row * nvec + lane;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (!on[k]) continue;
      const uint4 gm = sgam[k * G + lane];
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xv = V::get(xs[k], e), gv = V::get(gs[k], e);
        o[e] = rstd * (gv * V::get(gm, e) - xv * coef);
        acc[k][e] += gv * xv * rstd;
      }
      dxr[k * G] = pack_vec(o);
    }
  }

  // the groups' partials, added in group order
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    if (on[k])
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        part[grp * d + (k * G + lane) * VEC + e] = acc[k][e];
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sum = part[c];
    for (int q = 1; q < NG; ++q) sum += part[q * d + c];
    partial[static_cast<long long>(blockIdx.x) * d + c] = sum;
  }
}

// -- dgamma: the chunks' partials, in a fixed order --------------------------

// One block per 32 columns: warp w sums the w-th of kWarps runs of
// consecutive chunks in chunk order (eight loads issued before their adds),
// then the runs' sums are added in run order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_gamma(const float* __restrict__ partial, T* __restrict__ dgamma,
                  int chunks, int d) {
  __shared__ float runs[kWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const int per = (chunks + kWarps - 1) / kWarps;
  const int k1 = min(chunks, (warp + 1) * per);
  float s = 0.f;
  if (c < d) {
    int k = warp * per;
    for (; k + 8 <= k1; k += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = partial[static_cast<long long>(k + u) * d + c];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; k < k1; ++k) s += partial[static_cast<long long>(k) * d + c];
  }
  runs[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = runs[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += runs[w][lane];
    dgamma[c] = from_f32<T>(t);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int W>
cudaError_t launch_regs(const T* x, const T* gamma, const T* g, T* dx,
                        float* partial, int R, int d, float eps, int chunks,
                        int rows_per_chunk, cudaStream_t stream) {
  const size_t smem = (sizeof(float) * (kThreads / (32 * W)) + sizeof(T)) *
                      static_cast<size_t>(d);
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_regs<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_regs<T, W><<<chunks, kThreads, smem, stream>>>(
      x, gamma, g, dx, partial, R, d, eps, rows_per_chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* g, void* dx,
                   void* dgamma, void* partial, int R, int d, float eps,
                   int chunks, int body, int warps, cudaStream_t stream) {
  const int rows_per_chunk = (R + chunks - 1) / chunks;
  const T* xp = static_cast<const T*>(x);
  const T* gam = static_cast<const T*>(gamma);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  if (body == 1) {                            // register body
    constexpr int kVec = 16 / sizeof(T);
    if (d % kVec != 0 || !aligned16(x) || !aligned16(gamma) ||
        !aligned16(g) || !aligned16(dx) || 32 * warps * kSlots < d / kVec)
      return cudaErrorInvalidValue;
    switch (warps) {
      case 1: err = launch_regs<T, 1>(xp, gam, gp, dxp, part, R, d, eps,
                                      chunks, rows_per_chunk, stream); break;
      case 2: err = launch_regs<T, 2>(xp, gam, gp, dxp, part, R, d, eps,
                                      chunks, rows_per_chunk, stream); break;
      case 4: err = launch_regs<T, 4>(xp, gam, gp, dxp, part, R, d, eps,
                                      chunks, rows_per_chunk, stream); break;
      case 8: err = launch_regs<T, 8>(xp, gam, gp, dxp, part, R, d, eps,
                                      chunks, rows_per_chunk, stream); break;
      default: return cudaErrorInvalidValue;
    }
  } else if (body == 0) {                     // block body
    const size_t smem = sizeof(float) * static_cast<size_t>(d);
    err = cudaFuncSetAttribute(rmsnorm_bwd_rows<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    rmsnorm_bwd_rows<T><<<chunks, kThreads, smem, stream>>>(
        xp, gam, gp, dxp, part, R, d, eps, rows_per_chunk);
    err = cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_gamma<T><<<(d + 31) / 32, kThreads, 0, stream>>>(
      part, static_cast<T*>(dgamma), chunks, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16. x, g, dx [R, d] and gamma, dgamma [d]
// contiguous; `partial` a [chunks, d] f32 scratch buffer with
// 1 <= chunks <= R, and every chunk of ceil(R / chunks) rows holding at
// least one row (the wrapper picks chunks so). body: 0 = block per chunk,
// 1 = registers with `warps` warps a row (the forward's plan; d a multiple
// of the 16-byte vector, x, g, gamma and dx 16-byte aligned). Launches two
// kernels on `stream` of `device` and returns the first failing launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for a body this file
// cannot run). Does not synchronise.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* gamma,
                                  const void* g, void* dx, void* dgamma,
                                  void* partial, int R, int d, float eps,
                                  int chunks, int body, int warps, int dtype,
                                  int device, void* stream) {
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
                         body, warps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, g, dx, dgamma, partial, R, d, eps,
                                 chunks, body, warps, s);
  return cudaErrorInvalidValue;
}
