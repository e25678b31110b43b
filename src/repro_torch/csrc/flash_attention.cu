// Flash attention (online softmax, causal or not, GQA) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`). That kernel
// walks a (q-head, q-block, kv-block) grid whose kv axis runs in order on
// one core, carrying the running max, sum and accumulator in VMEM scratch
// from step to step. Blocks of a CUDA grid run in no order, so here the kv
// axis is a loop inside the block.
//
// Semantics (repro_torch/kernels/ref.py flash_attention, within a float
// tolerance: the softmax is taken online, tile by tile):
//   q [B*Hq, Tq, d], k and v [B*Hkv, Tk, d], out [B*Hq, Tq, d], one dtype
//   (f32 or bf16); f32 math; out = softmax(scale * q k^T + mask) v.
//   - GQA: flat q head h = b*Hq + i reads kv row b*Hkv + i / (Hq / Hkv).
//   - causal: query row r sees keys kpos <= r + (Tk - Tq) (aligned
//     bottom-right, so a decode step's rows see the whole prefix).
//   - masked scores are the finite NEG_INF = -1e30, never -inf, as in the
//     Pallas kernel: a row that sees no key (causal with Tk < Tq) comes out
//     as the mean of V over all Tk keys, not NaN.
//   - ragged tails: any Tq and Tk; keys past Tk take no part at all.
//   - d <= 128, a multiple of 8.
//
// Bound on this card: operations at the model's shapes (Tq = Tk = 4096,
// d = 64: 4*d flops per visible (query, key) pair against 2*d*2 bytes of
// K/V per key), far above the bytes' time. This first version does the
// products with scalar f32 FMAs on the CUDA cores, not the tensor cores,
// so it runs far from that bound; mma/wgmma and TMA are later work.
//
// Design: one block of 256 threads per (flat q head, 64-row q tile). The
// block stages its q tile, then each 64-key K and V tile, in shared memory
// as f32 (rows padded by one float against bank conflicts). Thread
// (ty, tx) of a 16 x 16 layout owns query rows ty + 16*i (i < 4), key
// columns tx + 16*j (j < 4) of the score tile, and output columns
// tx + 16*j (j < d_max/16) of the accumulator, all in registers. Row max
// and row sum are reduced over the 16 threads of a half warp by shuffles.
// The running max starts at NEG_INF and the sum at 0, as in the Pallas
// kernel. Causal blocks stop after the last kv tile that any of their rows
// sees, but only when every row of the tile sees at least one key
// (q0 + Tk - Tq >= 0): a fully masked tile adds exactly nothing to a row
// that sees a key, while a row that sees none must average all Tk keys.
// Heavy (late) q tiles are launched first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per kv tile
static_assert(kBQ == kBK, "load_tile stages 64-row tiles of q, k and v");
constexpr int kThreads = 256;   // 16 x 16
constexpr float kNegInf = -1e30f;

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
  return __float2bfloat16(x);
}

// sum / max over the 16 lanes of a half warp (one query row)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// rows [r0, r0 + 64) of a [T, d] matrix into s[64][ld] as f32; rows past
// T are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* s, int ld,
                                          const T* __restrict__ g, int r0,
                                          int rows, int d) {
  for (int idx = threadIdx.x; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    s[r * ld + c] = r0 + r < rows
        ? to_f32(g[static_cast<size_t>(r0 + r) * d + c]) : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
             int Tq, int Tk, int d, int causal, float scale, int n_qtiles) {
  constexpr int LQ = DMAX + 1, LK = DMAX + 1, LV = DMAX, LP = kBK + 1;
  constexpr int NO = DMAX / 16;               // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                           // [kBQ][LQ]
  float* sK = sQ + kBQ * LQ;                  // [kBK][LK]
  float* sV = sK + kBK * LK;                  // [kBK][LV]
  float* sP = sV + kBK * LV;                  // [kBQ][LP]

  const int h = blockIdx.x / n_qtiles;
  const int qt = n_qtiles - 1 - blockIdx.x % n_qtiles;   // heavy tiles first
  const int q0 = qt * kBQ;
  const int b = h / Hq;
  const int kvh = b * Hkv + (h - b * Hq) / (Hq / Hkv);
  const T* qh = q + static_cast<size_t>(h) * Tq * d;
  const T* kh = k + static_cast<size_t>(kvh) * Tk * d;
  const T* vh = v + static_cast<size_t>(kvh) * Tk * d;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int offset = Tk - Tq;

  for (int idx = threadIdx.x; idx < kBK * LV; idx += kThreads)
    sV[idx] = 0.f;                            // columns d..DMAX stay zero
  load_tile(sQ, LQ, qh, q0, Tq, d);

  int kend = Tk;
  if (causal && q0 + offset >= 0) {
    const int q_last = min(q0 + kBQ, Tq) - 1;
    kend = min(Tk, q_last + offset + 1);
  }

  float m[4], l[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                          // last tile's sK/sV/sP done
    load_tile(sK, LK, kh, k0, Tk, d);
    load_tile(sV, LV, vh, k0, Tk, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LQ + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LK + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && kpos > qpos + offset) x = kNegInf;
        if (kpos >= Tk) x = -INFINITY;        // past the end: no weight
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * LP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[NO];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < NO; ++j) vv[j] = sV[c * LV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NO; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* oh = out + static_cast<size_t>(h) * Tq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = tx + 16 * j;
      if (c < d) oh[static_cast<size_t>(r) * d + c] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Hq, int Hkv, int Tq, int Tk, int d, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (kBQ * (DMAX + 1) + kBK * (DMAX + 1) + kBK * DMAX + kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(      // above 48 KB: opt in
      flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qtiles = (Tq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(B) * Hq * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_kernel<T, DMAX><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Tq, Tk, d,
      causal, scale, n_qtiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int B, int Hq, int Hkv, int Tq, int Tk, int d,
                     int causal, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Tq, Tk, d, causal, scale,
                         stream);
  return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Tq, Tk, d, causal, scale,
                        stream);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16. Needs d <= 128 with d % 8 == 0 and Hq % Hkv
// == 0 (the wrapper checks). Launches on `stream` of `device` and returns
// the launch's cudaError_t (0 on success). Does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Hq, int Hkv, int Tq, int Tk, int d,
                                      int causal, float scale, int dtype,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (d <= 0 || d > 128 || d % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Tq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, Hq, Hkv, Tq, Tk, d, causal,
                           scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Tq, Tk, d,
                                   causal, scale, s);
  return cudaErrorInvalidValue;
}
