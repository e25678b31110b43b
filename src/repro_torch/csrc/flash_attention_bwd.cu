// Flash attention backward (causal or not, GQA) on Hopper (sm_90a).
//
// The Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py) has no backward: there is no
// custom_vjp on it, and the JAX package trains through blockwise jnp
// attention. This kernel is the port's own, so that training on the card
// runs on hand-written kernels end to end; flash_attention.cu's forward
// writes the `lse` it reads.
//
// Semantics (repro_torch/kernels/ref.py flash_attention_backward, within a
// float tolerance: the sums are taken in another order):
//   q, dout, dq [B, Hq, Tq, d]; k, v, dk, dv [B, Hkv, Tk, d]; out
//   [B, Hq, Tq, d] (the forward's); each a strided view (element strides
//   of the first three dimensions, the last one contiguous), one dtype
//   (f32 or bf16); lse [B, Hq, Tq] f32 contiguous; f32 math:
//     P  = exp(scale * q k^T + mask - lse)      (recomputed, never stored)
//     D  = rowsum(dout * out)
//     dS = P * (dout v^T - D), 0 where masked
//     dq = scale * dS k,  dk = scale * dS^T q,  dv = P^T dout
//   each cast once to its output's dtype. GQA: q head i reads kv head
//   i / (Hq / Hkv); dk and dv sum over the Hq / Hkv q heads of the group.
//   Causal masks as the forward (key j hidden from query i when
//   j > i + Tk - Tq); a masked score has no gradient. A row that sees no
//   key has lse = log(Tk) (flash_attention.cu) and reads its masked scores
//   as 0, so it adds dout / Tk to dv of every key and nothing to dq, dk.
//
// Deterministic: no float atomics, and every sum runs in a fixed order,
// so two runs on the same inputs give the same bits.
//   1. D: one warp a row, a butterfly of shuffles.
//   2. dk, dv: one block per (kv tile of 64 keys, b, kv head); the block
//      holds its K and V tiles in shared memory and its dk, dv in
//      registers, and loops over the group's q heads and their 64-row q
//      tiles in order (causal: skipping tiles none of whose rows sees
//      these keys, unless a row of the tile sees no key at all). A q tile
//      brings Q, dout, lse and D into shared memory; the block recomputes
//      P^T and dS^T for the [64 keys x 64 queries] pair tile, stages them
//      in shared memory and accumulates dV += P^T dO, dK += dS^T Q.
//   3. dq: one block per (q tile, b, q head); it holds Q, dout, lse, D and
//      its dq, loops over the kv tiles the rows see, recomputes P and dS,
//      and accumulates dQ += dS K.
// Heavy tiles (early keys, late queries under the causal mask) are
// launched first. Products are f32 FMAs on tiles staged in shared memory
// as f32 (a 16 x 16 thread grid, 4 x 4 products a thread): simple and
// exact to f32, far from the tensor cores' rate.
//
// Bound on this card: operations. Five products of 2*d flops a visible
// (query, key) pair (S, dP, dV, dK, dQ; this design recomputes S and dP in
// the dq pass, seven in all) against reading q, k, v, out, dout once and
// writing dq, dk, dv once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kT = 64;          // rows of a q tile, keys of a kv tile
constexpr int kThreads = 256;   // 16 x 16

struct Strides {
  long long b, h, t;
};

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

// D[row] = sum_c dout[row, c] * out[row, c]; rows enumerate (b, head, t)
template <typename T>
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
              float* __restrict__ D, Strides so, Strides sdo, int Hq, int Tq,
              int d, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32)
                        + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int t = static_cast<int>(row % Tq);
  const long long bh = row / Tq;
  const int i = static_cast<int>(bh % Hq);
  const long long b = bh / Hq;
  const T* o = out + b * so.b + i * so.h + t * so.t;
  const T* g = dout + b * sdo.b + i * sdo.h + t * sdo.t;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_f32(o[c]) * to_f32(g[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

// rows [r0, r0 + 64) of a [rows, d] matrix with row stride `ld_g` into
// s[64][ld] as f32; rows past `rows` are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* s, int ld,
                                          const T* __restrict__ g,
                                          long long ld_g, int r0, int rows,
                                          int d) {
  for (int idx = threadIdx.x; idx < kT * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    s[r * ld + c] = r0 + r < rows ? to_f32(g[(r0 + r) * ld_g + c]) : 0.f;
  }
}

// 64 values of a contiguous row vector from `g + r0` into s; 0 past `rows`
__device__ __forceinline__ void load_vec(float* s, const float* g, int r0,
                                         int rows) {
  if (threadIdx.x < kT)
    s[threadIdx.x] = r0 + threadIdx.x < rows ? g[r0 + threadIdx.x] : 0.f;
}

// the masked score of (query qpos, key kpos) as the forward defines it, or
// the scaled score when the pair is visible; `*masked` says which
__device__ __forceinline__ float score(float s, float scale, int qpos,
                                       int kpos, int offset, int causal,
                                       bool* masked) {
  *masked = causal && kpos > qpos + offset;
  if (!*masked) return s * scale;
  return qpos + offset < 0 ? 0.f : kNegInf;   // a row that sees no key
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
            Strides sv, Strides sdo, Strides sdk, Strides sdv, int BHkv,
            int Hq, int Hkv, int Tq, int Tk, int d, int causal, float scale) {
  constexpr int LD = DMAX + 1, LP = kT + 1;
  constexpr int NO = DMAX / 16;               // output columns a thread
  extern __shared__ float smem[];
  float* sK = smem;                           // [kT][LD]
  float* sV = sK + kT * LD;                   // [kT][LD]
  float* sQ = sV + kT * LD;                   // [kT][LD]
  float* sO = sQ + kT * LD;                   // dout [kT][LD]
  float* sP = sO + kT * LD;                   // P^T [key][query]
  float* sS = sP + kT * LP;                   // dS^T [key][query]
  float* sL = sS + kT * LP;                   // lse [kT]
  float* sD = sL + kT;                        // D [kT]

  const int kt = static_cast<int>(blockIdx.x) / BHkv;  // early keys first
  const int h = static_cast<int>(blockIdx.x) % BHkv;
  const int b = h / Hkv, kvi = h - b * Hkv;
  const int group = Hq / Hkv;
  const int k0 = kt * kT;
  const int offset = Tk - Tq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(sK, LD, k + b * sk.b + kvi * sk.h, sk.t, k0, Tk, d);
  load_tile(sV, LD, v + b * sv.b + kvi * sv.h, sv.t, k0, Tk, d);

  float acc_k[4][NO], acc_v[4][NO];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NO; ++j) acc_k[r][j] = acc_v[r][j] = 0.f;

  const int n_qtiles = (Tq + kT - 1) / kT;
  for (int gi = 0; gi < group; ++gi) {
    const int i = kvi * group + gi;
    const long long row_base = (static_cast<long long>(b) * Hq + i) * Tq;
    for (int qt = 0; qt < n_qtiles; ++qt) {
      const int q0 = qt * kT;
      const int q_last = min(q0 + kT, Tq) - 1;
      // no row of the tile sees these keys, and every row sees some key
      if (causal && q_last + offset < k0 && q0 + offset >= 0) continue;
      __syncthreads();                        // the last tile's reads done
      load_tile(sQ, LD, q + b * sq.b + i * sq.h, sq.t, q0, Tq, d);
      load_tile(sO, LD, dout + b * sdo.b + i * sdo.h, sdo.t, q0, Tq, d);
      load_vec(sL, lse + row_base, q0, Tq);
      load_vec(sD, D + row_base, q0, Tq);
      __syncthreads();

      // S^T and dP^T for keys ty + 16r, queries tx + 16c
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          kv[r] = sK[(ty + 16 * r) * LD + dd];
          vv[r] = sV[(ty + 16 * r) * LD + dd];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qv[c] = sQ[(tx + 16 * c) * LD + dd];
          ov[c] = sO[(tx + 16 * c) * LD + dd];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(kv[r], qv[c], s[r][c]);
            dp[r][c] = fmaf(vv[r], ov[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kpos = k0 + ty + 16 * r, qpos = q0 + tx + 16 * c;
          bool masked;
          const float x = score(s[r][c], scale, qpos, kpos, offset, causal,
                                &masked);
          const bool valid = kpos < Tk && qpos < Tq;
          const float p = valid ? expf(x - sL[tx + 16 * c]) : 0.f;
          const float ds =
              valid && !masked ? p * (dp[r][c] - sD[tx + 16 * c]) : 0.f;
          sP[(ty + 16 * r) * LP + tx + 16 * c] = p;
          sS[(ty + 16 * r) * LP + tx + 16 * c] = ds;
        }
      __syncthreads();

      // dV[key][col] += P^T dO, dK[key][col] += dS^T Q over the 64 queries
      for (int qq = 0; qq < kT; ++qq) {
        float pv[4], sv_[4], ov[NO], qv[NO];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = sP[(ty + 16 * r) * LP + qq];
          sv_[r] = sS[(ty + 16 * r) * LP + qq];
        }
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          ov[j] = sO[qq * LD + tx + 16 * j];
          qv[j] = sQ[qq * LD + tx + 16 * j];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < NO; ++j) {
            acc_v[r][j] = fmaf(pv[r], ov[j], acc_v[r][j]);
            acc_k[r][j] = fmaf(sv_[r], qv[j], acc_k[r][j]);
          }
      }
    }
  }

  T* dkh = dk + b * sdk.b + kvi * sdk.h;
  T* dvh = dv + b * sdv.b + kvi * sdv.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty + 16 * r;
    if (row >= Tk) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        dkh[row * sdk.t + c] = from_f32<T>(acc_k[r][j] * scale);
        dvh[row * sdv.t + c] = from_f32<T>(acc_v[r][j]);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
          Strides sdo, Strides sdq, int BH, int Hq, int Hkv, int Tq, int Tk,
          int d, int causal, float scale, int n_qtiles) {
  constexpr int LD = DMAX + 1, LP = kT + 1;
  constexpr int NO = DMAX / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                           // [kT][LD]
  float* sO = sQ + kT * LD;                   // dout [kT][LD]
  float* sK = sO + kT * LD;                   // [kT][LD]
  float* sV = sK + kT * LD;                   // [kT][LD]
  float* sS = sV + kT * LD;                   // dS [query][key]
  float* sL = sS + kT * LP;                   // lse [kT]
  float* sD = sL + kT;                        // D [kT]

  // late (heavy) q tiles of every head first
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / BH;
  const int h = static_cast<int>(blockIdx.x) % BH;
  const int b = h / Hq, i = h - b * Hq;
  const int kvi = i / (Hq / Hkv);
  const int q0 = qt * kT;
  const int offset = Tk - Tq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row_base = static_cast<long long>(h) * Tq;

  load_tile(sQ, LD, q + b * sq.b + i * sq.h, sq.t, q0, Tq, d);
  load_tile(sO, LD, dout + b * sdo.b + i * sdo.h, sdo.t, q0, Tq, d);
  load_vec(sL, lse + row_base, q0, Tq);
  load_vec(sD, D + row_base, q0, Tq);

  // keys past the last one any row sees carry no gradient to dq
  int kend = Tk;
  if (causal) kend = min(Tk, max(0, min(q0 + kT, Tq) + offset));

  float acc[4][NO];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[r][j] = 0.f;

  const T* kh = k + b * sk.b + kvi * sk.h;
  const T* vh = v + b * sv.b + kvi * sv.h;
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();                          // the last tile's reads done
    load_tile(sK, LD, kh, sk.t, k0, Tk, d);
    load_tile(sV, LD, vh, sv.t, k0, Tk, d);
    __syncthreads();

    // S and dP for queries ty + 16r, keys tx + 16c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = sQ[(ty + 16 * r) * LD + dd];
        ov[r] = sO[(ty + 16 * r) * LD + dd];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = sK[(tx + 16 * c) * LD + dd];
        vv[c] = sV[(tx + 16 * c) * LD + dd];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qpos = q0 + ty + 16 * r, kpos = k0 + tx + 16 * c;
        bool masked;
        const float x = score(s[r][c], scale, qpos, kpos, offset, causal,
                              &masked);
        const bool valid = kpos < Tk && qpos < Tq && !masked;
        sS[(ty + 16 * r) * LP + tx + 16 * c] =
            valid ? expf(x - sL[ty + 16 * r]) * (dp[r][c] - sD[ty + 16 * r])
                  : 0.f;
      }
    __syncthreads();

    for (int kk = 0; kk < kT; ++kk) {
      float sv_[4], kv[NO];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv_[r] = sS[(ty + 16 * r) * LP + kk];
#pragma unroll
      for (int j = 0; j < NO; ++j) kv[j] = sK[kk * LD + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < NO; ++j)
          acc[r][j] = fmaf(sv_[r], kv[j], acc[r][j]);
    }
  }

  T* dqh = dq + b * sdq.b + i * sdq.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Tq) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = tx + 16 * j;
      if (c < d) dqh[row * sdq.t + c] = from_f32<T>(acc[r][j] * scale);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const float* lse,
                         float* D, void* dq, void* dk, void* dv,
                         const Strides* st, int B, int Hq, int Hkv, int Tq,
                         int Tk, int d, int causal, float scale,
                         cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(out);
  const T* gp = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * Hq * Tq;
  const long long dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (dot_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rowdot_kernel<T><<<static_cast<unsigned>(dot_blocks), kThreads, 0,
                     stream>>>(op, gp, D, st[3], st[4], Hq, Tq, d, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int LD = DMAX + 1, LP = kT + 1;
  const size_t smem_kv = sizeof(float) * (4 * kT * LD + 2 * kT * LP + 2 * kT);
  const size_t smem_q = sizeof(float) * (4 * kT * LD + kT * LP + 2 * kT);
  err = cudaFuncSetAttribute(dkdv_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;

  const long long bhkv = static_cast<long long>(B) * Hkv;
  const long long kv_blocks = bhkv * ((Tk + kT - 1) / kT);
  const long long bh = static_cast<long long>(B) * Hq;
  const int n_qtiles = (Tq + kT - 1) / kT;
  const long long q_blocks = bh * n_qtiles;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (kv_blocks > 0) {
    dkdv_kernel<T, DMAX><<<static_cast<unsigned>(kv_blocks), kThreads,
                           smem_kv, stream>>>(
        qp, kp, vp, gp, lse, D, static_cast<T*>(dk), static_cast<T*>(dv),
        st[0], st[1], st[2], st[4], st[6], st[7], static_cast<int>(bhkv), Hq,
        Hkv, Tq, Tk, d, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dq_kernel<T, DMAX><<<static_cast<unsigned>(q_blocks), kThreads, smem_q,
                       stream>>>(
      qp, kp, vp, gp, lse, D, static_cast<T*>(dq), st[0], st[1], st[2],
      st[4], st[5], static_cast<int>(bh), Hq, Hkv, Tq, Tk, d, causal, scale,
      n_qtiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const float* lse,
                         float* D, void* dq, void* dk, void* dv,
                         const Strides* st, int B, int Hq, int Hkv, int Tq,
                         int Tk, int d, int causal, float scale,
                         cudaStream_t stream) {
  if (d <= 64)
    return launch_typed<T, 64>(q, k, v, out, dout, lse, D, dq, dk, dv, st, B,
                               Hq, Hkv, Tq, Tk, d, causal, scale, stream);
  return launch_typed<T, 128>(q, k, v, out, dout, lse, D, dq, dk, dv, st, B,
                              Hq, Hkv, Tq, Tk, d, causal, scale, stream);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16. `strides` holds 24 element strides: (batch,
// head, row) of q, k, v, out, dout, dq, dk and dv in that order; the last
// dimension of each is contiguous. lse and the scratch D are contiguous
// [B, Hq, Tq] f32 buffers. Needs B, Hq, Tq, Tk > 0, d <= 128 with d % 8 ==
// 0 and Hq % Hkv == 0 (the wrapper checks; it answers empty inputs
// itself). Launches three kernels on `stream` of `device` and returns the
// first failing launch's cudaError_t (0 on success). Does not synchronise.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
    int B, int Hq, int Hkv, int Tq, int Tk, int d, const long long* strides,
    int causal, float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (d <= 0 || d > 128 || d % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B <= 0 || Hq <= 0 || Tq <= 0 || Tk <= 0)
    return cudaErrorInvalidValue;
  Strides st[8];
  for (int t = 0; t < 8; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* Dp = static_cast<float*>(D);
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, out, dout, l, Dp, dq, dk, dv, st, B,
                               Hq, Hkv, Tq, Tk, d, causal, scale, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, out, dout, l, Dp, dq, dk, dv,
                                       st, B, Hq, Hkv, Tq, Tk, d, causal,
                                       scale, s);
  return cudaErrorInvalidValue;
}
