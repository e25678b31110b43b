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
//   (f32 or bf16); lse [B, Hq, Tq] f32 contiguous; f32 math (the bf16
//   body rounds P and dS to bf16 as operands, below):
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
// so two runs on the same inputs give the same bits. Three kernels:
//   1. a pre-pass, one warp a row (a butterfly of shuffles): D, and for
//      bf16 also lse * log2(e), into a scratch of rows padded to 64;
//   2. dk, dv: one block per (kv tile, b, kv head), looping over the GQA
//      group's q heads and their q tiles in order (causal: skipping tiles
//      none of whose rows sees these keys, unless a row of the tile sees
//      no key at all); dk and dv stay in registers, so the group's sum runs
//      in that loop's order;
//   3. dq: one block per (q tile, b, q head), looping over the kv tiles
//      the rows see and recomputing S and dP (two of the seven products a
//      pair; a one-pass dq that stays deterministic would write and read
//      back f32 partials per (kv tile, q tile), about 1 GB at the model's
//      shape, more time than the recompute).
// Heavy tiles (early keys, late queries under the causal mask) launch
// first.
//
// bf16 body (the model's path), for the tensor cores. Every product is a
// wgmma (hopper.cuh) with bf16 operands and f32 accumulators:
//   - dk/dv: a block of two warpgroups owns 128 keys, 64 a warpgroup. K
//     and V come in once by TMA; the q steps (64 queries) of Q and dO,
//     with their lse * log2(e) and D, arrive through a two-stage ring
//     (TMA and bulk copies completing on mbarriers); the second warpgroup
//     to finish with a stage refills it (a count in shared memory says
//     which), so neither waits for the other. A step computes
//     S^T = K Q^T and dP^T = V dO^T (m64n64, both operands K-major in
//     shared memory), P^T = exp2 on the fragment with scale * log2(e)
//     folded in and lse read per column, dS^T = P^T (dP^T - D), packs P^T
//     and dS^T to bf16 pairs in registers (the A-operand layout) and
//     accumulates dV += P^T dO and dK += dS^T Q (A from registers, dO and Q
//     MN-major from shared memory).
//   - dq: a block of two warpgroups owns 128 query rows, 64 a warpgroup;
//     Q and dO come in once, K and V tiles of 128 keys through a two-stage
//     ring refilled the same way; S = Q K^T and dP = dO V^T (m64n128) in
//     two commit groups, so that P = exp2(S - lse) per row runs while dP
//     is still on the tensor cores; dS = P (dP - D), dQ += dS K (K
//     MN-major). (The same split in the dk/dv kernel, with or without dV
//     issued before dS^T is formed, was slower there.)
//   - masks are applied only on tiles that reach the causal diagonal, Tk
//     or Tq; rows past T and columns past d arrive zero-filled by TMA, so
//     ragged T and d < 64 need no special loads.
//   - P and dS are rounded to bf16 as the products' operands (as SDPA's
//     own backward does); S, dP and every sum stay f32, and dq, dk, dv are
//     cast once at the end.
//
// f32 inputs (not on the model's path) keep a scalar body: 64-row tiles
// staged in shared memory as f32, f32 FMAs on a 16 x 16 thread grid (4 x 4
// products a thread); the tensor cores' TF32 would not hold f32
// tolerances.
//
// Bound on this card: operations. Five products of 2*d flops a visible
// (query, key) pair (S, dP, dV, dK, dQ; this design recomputes S and dP in
// the dq pass, seven in all) against reading q, k, v, out, dout once and
// writing dq, dk, dv once.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kT = 64;          // f32 body: rows of a q tile, keys a kv tile
constexpr int kThreads = 256;   // 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// D[bh, t] = sum_c dout[bh, t, c] * out[bh, t, c] at row bh * ld + t of
// the scratch (ld >= Tq; entries Tq <= t < ld are 0); with L2 (the bf16
// body) also L2[bh * ld + t] = lse[bh, t] * log2(e)
template <typename T>
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
              float* __restrict__ D, const float* __restrict__ lse,
              float* __restrict__ L2, Strides so, Strides sdo, int Hq,
              int Tq, int ld, int d, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32)
                        + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int t = static_cast<int>(row % ld);
  const long long bh = row / ld;
  float acc = 0.f;
  if (t < Tq) {                              // the whole warp's row
    const int i = static_cast<int>(bh % Hq);
    const long long b = bh / Hq;
    const T* o = out + b * so.b + i * so.h + t * so.t;
    const T* g = dout + b * sdo.b + i * sdo.h + t * sdo.t;
    for (int c = lane; c < d; c += 32) acc += to_f32(o[c]) * to_f32(g[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    D[row] = acc;
    if (L2 != nullptr) L2[row] = t < Tq ? lse[bh * Tq + t] * kLog2e : 0.f;
  }
}

template <typename T>
cudaError_t launch_rowdot(const void* out, const void* dout, float* D,
                          const float* lse, float* L2, const Strides* st,
                          int B, int Hq, int Tq, int ld, int d,
                          cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Hq * ld;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rowdot_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), D, lse, L2,
      st[3], st[4], Hq, Tq, ld, d, rows);
  return cudaGetLastError();
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
  const T* gp = static_cast<const T*>(dout);
  cudaError_t err = launch_rowdot<T>(out, dout, D, nullptr, nullptr, st, B,
                                     Hq, Tq, Tq, d, stream);
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

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* D, void* dq, void* dk, void* dv,
                       const Strides* st, int B, int Hq, int Hkv, int Tq,
                       int Tk, int d, int causal, float scale,
                       cudaStream_t stream) {
  if (d <= 64)
    return launch_typed<float, 64>(q, k, v, out, dout, lse, D, dq, dk, dv,
                                   st, B, Hq, Hkv, Tq, Tk, d, causal, scale,
                                   stream);
  return launch_typed<float, 128>(q, k, v, out, dout, lse, D, dq, dk, dv, st,
                                  B, Hq, Hkv, Tq, Tk, d, causal, scale,
                                  stream);
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                    // threads per warpgroup
constexpr int kStages = 2;                  // ring depth of both kernels
constexpr int kKT = 128;                    // keys a dk/dv block, a dq kv tile
constexpr int kQS = 64;                     // queries a dk/dv step
constexpr int kQT = 128;                    // query rows a dq block
constexpr uint32_t kRowBytes = kSwizzleCols * 2;     // a box row: 128 B
constexpr uint32_t kBox128 = 128 * kRowBytes;        // [128][64] bf16
constexpr uint32_t kBox64 = 64 * kRowBytes;          // [64][64]: also a
                                                     // warpgroup's 64 rows

// NB boxes of 64 columns: d <= 64 * NB. ws: [2][B*Hq][ld] f32, lse*log2(e)
// then D (rowdot_kernel), ld a multiple of kQS.
template <int NB>
__global__ void __launch_bounds__(2 * kWG, 1)
dkdv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,   // 64-row boxes
                 const __grid_constant__ CUtensorMap map_do,  // 64-row boxes
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const float* __restrict__ ws,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, Strides sdk, Strides sdv,
                 int BHkv, int Hq, int Hkv, int Tq, int Tk, int ld, int d,
                 int causal, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  __shared__ int released[kStages];   // warpgroups done with each stage
  // boxes must start on 1024 bytes: the swizzle pattern repeats there
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  constexpr uint32_t kStepBytes = NB * kBox64;          // a step of Q or dO
  const uint32_t sK = base;                             // [NB] boxes
  const uint32_t sV = sK + NB * kBox128;                // [NB]
  const uint32_t sQ = sV + NB * kBox128;                // [kStages][NB]
  const uint32_t sO = sQ + kStages * kStepBytes;        // [kStages][NB]
  const uint32_t sLD = sO + kStages * kStepBytes;       // [kStages][2][kQS]
  const float* lds = reinterpret_cast<const float*>(smem_raw + (sLD - raw));
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);         // [kStages]

  const int tid = threadIdx.x;
  const int wg = tid / kWG, wtid = tid % kWG;
  const int warp = wtid / 32, lane = tid % 32;
  const int kt = static_cast<int>(blockIdx.x) / BHkv;  // early keys first
  const int h = static_cast<int>(blockIdx.x) % BHkv;
  const int b = h / Hkv, kvi = h - b * Hkv;
  const int group = Hq / Hkv;
  const int k0 = kt * kKT;
  const int offset = Tk - Tq;
  const int n_qs = (Tq + kQS - 1) / kQS;
  const long long d_off = static_cast<long long>(BHkv) * group * ld;

  // a q step is skipped when no row of it sees these keys and every row
  // sees some key; (gi, qs) walks the group's q heads and their live steps
  auto live = [&](int qs) {
    const int q0 = qs * kQS;
    const int q_last = min(q0 + kQS, Tq) - 1;
    return !(causal && q_last + offset < k0 && q0 + offset >= 0);
  };
  auto advance = [&](int& gi, int& qs) {
    do {
      if (++qs == n_qs) {
        qs = 0;
        ++gi;
      }
    } while (gi < group && !live(qs));
  };
  auto load_step = [&](int gi, int qs, int s) {
    const int i = kvi * group + gi;
    const int q0 = qs * kQS;
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect_tx(bar, 2 * kStepBytes + 2 * kQS * 4);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_load_4d(sQ + s * kStepBytes + x * kBox64, &map_q, bar,
                  x * kSwizzleCols, q0, i, b);
      tma_load_4d(sO + s * kStepBytes + x * kBox64, &map_do, bar,
                  x * kSwizzleCols, q0, i, b);
    }
    const float* row = ws + (static_cast<long long>(b) * Hq + i) * ld + q0;
    bulk_load(sLD + s * 2 * kQS * 4, row, kQS * 4, bar);
    bulk_load(sLD + s * 2 * kQS * 4 + kQS * 4, row + d_off, kQS * 4, bar);
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    int pg = 0, pq = -1;
    mbar_expect_tx(bar_kv, 2 * NB * kBox128);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_load_4d(sK + x * kBox128, &map_k, bar_kv, x * kSwizzleCols, k0,
                  kvi, b);
      tma_load_4d(sV + x * kBox128, &map_v, bar_kv, x * kSwizzleCols, k0,
                  kvi, b);
    }
    for (int s = 0; s < kStages; ++s) {
      advance(pg, pq);
      if (pg < group) load_step(pg, pq, s);
    }
  }
  __syncwarp();

  // this thread's keys (two) and query column pairs: register r of an
  // m64nN accumulator holds row (warp*16 + lane/4 + 8*((r>>1)&1)), column
  // (8*(r>>2) + 2*(lane%4) + (r&1))
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float dka[NB][32], dva[NB][32];
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int r = 0; r < 32; ++r) dka[x][r] = dva[x][r] = 0.f;

  mbar_wait(bar_kv, 0);
  int gi = 0, qs = -1;
  advance(gi, qs);
  for (int j = 0; gi < group; ++j, advance(gi, qs)) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(bar_full + 8 * st, parity);
    const uint32_t q_s = sQ + st * kStepBytes, o_s = sO + st * kStepBytes;

    // S^T = K Q^T and dP^T = V dO^T over the d columns in steps of 16
    // (d >= 8: the first step always runs and writes s and dp afresh)
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (x * kSwizzleCols + kk * 16 >= d) continue;
        const uint32_t a_off = x * kBox128 + wg * kBox64 + kk * 32;
        const uint64_t ka = smem_desc(sK + a_off, 16, 1024);
        const uint64_t va = smem_desc(sV + a_off, 16, 1024);
        const uint64_t qb = smem_desc(q_s + x * kBox64 + kk * 32, 16, 1024);
        const uint64_t ob = smem_desc(o_s + x * kBox64 + kk * 32, 16, 1024);
        if (x + kk == 0) {
          wgmma_m64n64_ss_first(s, ka, qb);
          wgmma_m64n64_ss_first(dp, va, ob);
        } else {
          wgmma_m64n64_ss(s, ka, qb);
          wgmma_m64n64_ss(dp, va, ob);
        }
      }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T; lse (log2 units) and D are per column (query)
    const int q0 = qs * kQS;
    const float* l2 = lds + st * 2 * kQS;
    const float* dd = l2 + kQS;
    const bool edge = (causal && kw0 + 63 > q0 + offset) || kw0 + 64 > Tk ||
                      q0 + kQS > Tq;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int c = 8 * (r >> 2) + col0 + (r & 1);
      float p = exp2f(s[r] * scale_log2 - l2[c]);
      float ds = p * (dp[r] - dd[c]);
      if (edge) {
        const int kpos = key0 + 8 * ((r >> 1) & 1), qpos = q0 + c;
        if (kpos >= Tk || qpos >= Tq) {
          p = 0.f;
          ds = 0.f;
        } else if (causal && kpos > qpos + offset) {
          // a row that sees no key reads its masked scores as 0
          p = qpos + offset < 0 ? exp2f(-l2[c]) : 0.f;
          ds = 0.f;
        }
      }
      s[r] = p;
      dp[r] = ds;
    }

    // dV += P^T dO and dK += dS^T Q, 16 queries a step; the bf16 pairs of
    // P^T and dS^T are the A fragments, dO and Q MN-major B operands
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        sa[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      }
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      fence_regs(dva[x]);
      fence_regs(dka[x]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        if (x * kSwizzleCols >= d) continue;
        const uint32_t off = x * kBox64 + kk * 16 * kRowBytes;
        wgmma_m64n64_rs(dva[x], pa[kk], smem_desc(o_s + off, kBox64, 1024));
        wgmma_m64n64_rs(dka[x], sa[kk], smem_desc(q_s + off, kBox64, 1024));
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      fence_regs(dva[x]);
      fence_regs(dka[x]);
    }

    // the second warpgroup done with this stage refills it with step j + 2
    // (the count is never reset: an odd count before the add means second),
    // so neither warpgroup waits for the other
    if (wtid == 0 && atomicAdd(&released[st], 1) % 2 == 1) {
      int g2 = gi, q2 = qs;
      advance(g2, q2);
      advance(g2, q2);
      if (g2 < group) load_step(g2, q2, st);
    }
    __syncwarp();
  }

  __nv_bfloat16* dkh = dk + b * sdk.b + kvi * sdk.h;
  __nv_bfloat16* dvh = dv + b * sdv.b + kvi * sdv.h;
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int row = key0 + 8 * ((r >> 1) & 1);
      const int c = x * kSwizzleCols + 8 * (r >> 2) + col0;
      if (row < Tk && c < d) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + row * sdk.t + c) =
            __floats2bfloat162_rn(dka[x][r] * scale, dka[x][r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvh + row * sdv.t + c) =
            __floats2bfloat162_rn(dva[x][r], dva[x][r + 1]);
      }
    }
}

template <int NB>
__global__ void __launch_bounds__(2 * kWG, 1)
dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,   // 128-row boxes
               const __grid_constant__ CUtensorMap map_do,  // 128-row boxes
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const float* __restrict__ ws, __nv_bfloat16* __restrict__ dq,
               Strides sdq, int BH, int Hq, int Hkv, int Tq, int Tk, int ld,
               int d, int causal, float scale_log2, float scale,
               int n_qtiles) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  __shared__ int released[kStages];   // warpgroups done with each stage
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                              // [NB] boxes
  const uint32_t sO = sQ + NB * kBox128;                 // [NB]
  const uint32_t sK = sO + NB * kBox128;                 // [kStages][NB]
  const uint32_t sV = sK + kStages * NB * kBox128;       // [kStages][NB]
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);          // [kStages]

  const int tid = threadIdx.x;
  const int wg = tid / kWG, wtid = tid % kWG;
  const int warp = wtid / 32, lane = tid % 32;
  // late (heavy) q tiles of every head first
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / BH;
  const int h = static_cast<int>(blockIdx.x) % BH;
  const int b = h / Hq, i = h - b * Hq;
  const int kvi = i / (Hq / Hkv);
  const int q0 = qt * kQT;
  const int offset = Tk - Tq;
  // keys past the last one any row sees carry no gradient to dq
  int kend = Tk;
  if (causal) kend = min(Tk, max(0, min(q0 + kQT, Tq) + offset));
  const int n_tiles = (kend + kKT - 1) / kKT;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int tile, int s) {
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect_tx(bar, 2 * NB * kBox128);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_load_4d(sK + (s * NB + x) * kBox128, &map_k, bar,
                  x * kSwizzleCols, tile * kKT, kvi, b);
      tma_load_4d(sV + (s * NB + x) * kBox128, &map_v, bar,
                  x * kSwizzleCols, tile * kKT, kvi, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * NB * kBox128);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_load_4d(sQ + x * kBox128, &map_q, bar_q, x * kSwizzleCols, q0, i,
                  b);
      tma_load_4d(sO + x * kBox128, &map_do, bar_q, x * kSwizzleCols, q0, i,
                  b);
    }
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_kv(t, t);
  }
  __syncwarp();

  // this thread's rows (two) and key column pairs, as in dkdv_bf16_kernel
  const int qw0 = q0 + 64 * wg;
  const int row0 = qw0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float l2[2], dd[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = row0 + 8 * h2;
    const long long at = static_cast<long long>(h) * ld + row;
    l2[h2] = row < Tq ? ws[at] : 0.f;
    dd[h2] = row < Tq ? ws[static_cast<long long>(BH) * ld + at] : 0.f;
  }
  float dqa[NB][32];
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int r = 0; r < 32; ++r) dqa[x][r] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(bar_full + 8 * st, parity);

    // S = Q K^T and dP = dO V^T over the d columns in steps of 16, one
    // commit group each (the first step writes s and dp afresh; columns
    // past d are zeros in both operands)
    float s[64], dp[64];
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t qa = smem_desc(
            sQ + x * kBox128 + wg * kBox64 + kk * 32, 16, 1024);
        const uint64_t kb = smem_desc(
            sK + (st * NB + x) * kBox128 + kk * 32, 16, 1024);
        if (x + kk == 0) wgmma_m64n128_ss_first(s, qa, kb);
        else wgmma_m64n128_ss(s, qa, kb, 1);
      }
    wgmma_commit();
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t oa = smem_desc(
            sO + x * kBox128 + wg * kBox64 + kk * 32, 16, 1024);
        const uint64_t vb = smem_desc(
            sV + (st * NB + x) * kBox128 + kk * 32, 16, 1024);
        if (x + kk == 0) wgmma_m64n128_ss_first(dp, oa, vb);
        else wgmma_m64n128_ss(dp, oa, vb, 1);
      }
    wgmma_commit();

    // P = exp2(S - lse) per row (log2 units) while dP runs, then
    // dS = P (dP - D), 0 where masked
    wgmma_wait1();
    fence_regs(s);
#pragma unroll
    for (int r = 0; r < 64; ++r)
      s[r] = exp2f(s[r] * scale_log2 - l2[(r >> 1) & 1]);
    wgmma_wait0();
    fence_regs(dp);
    const int k0 = j * kKT;
    const bool edge = (causal && k0 + kKT - 1 > qw0 + offset) ||
                      k0 + kKT > Tk || qw0 + 64 > Tq;
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      const int h2 = (r >> 1) & 1;
      float ds = s[r] * (dp[r] - dd[h2]);
      if (edge) {
        const int kpos = k0 + 8 * (r >> 2) + col0 + (r & 1);
        const int qpos = row0 + 8 * h2;
        if (kpos >= Tk || qpos >= Tq || (causal && kpos > qpos + offset))
          ds = 0.f;
      }
      dp[r] = ds;
    }

    // dQ += dS K, 16 keys a step; dS's bf16 pairs are the A fragment
    uint32_t sa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sa[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
#pragma unroll
    for (int x = 0; x < NB; ++x) fence_regs(dqa[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        const uint32_t off = (st * NB + x) * kBox128 + kk * 16 * kRowBytes;
        wgmma_m64n64_rs(dqa[x], sa[kk], smem_desc(sK + off, kBox128, 1024));
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int x = 0; x < NB; ++x) fence_regs(dqa[x]);

    // the second warpgroup done with this stage refills it with tile j + 2
    if (wtid == 0 && atomicAdd(&released[st], 1) % 2 == 1 &&
        j + kStages < n_tiles)
      load_kv(j + kStages, st);
    __syncwarp();
  }

  __nv_bfloat16* dqh = dq + b * sdq.b + i * sdq.h;
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int row = row0 + 8 * ((r >> 1) & 1);
      const int c = x * kSwizzleCols + 8 * (r >> 2) + col0;
      if (row < Tq && c < d)
        *reinterpret_cast<__nv_bfloat162*>(dqh + row * sdq.t + c) =
            __floats2bfloat162_rn(dqa[x][r] * scale, dqa[x][r + 1] * scale);
    }
}

// maps: q and dout in 64-row boxes, q and dout in 128-row boxes, k, v
template <int NB>
cudaError_t launch_bf16_nb(const CUtensorMap* maps, const float* ws,
                           void* dq, void* dk, void* dv, const Strides* st,
                           int B, int Hq, int Hkv, int Tq, int Tk, int ld,
                           int d, int causal, float scale,
                           cudaStream_t stream) {
  const size_t smem_kv = 1024 + static_cast<size_t>(NB) *
      (2 * kBox128 + kStages * 2 * kBox64) + kStages * 2 * kQS * 4;
  const size_t smem_q = 1024 + static_cast<size_t>(NB) * kBox128 *
      (2 + 2 * kStages);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_bf16_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_bf16_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  const long long bhkv = static_cast<long long>(B) * Hkv;
  const long long kv_blocks = bhkv * ((Tk + kKT - 1) / kKT);
  const long long bh = static_cast<long long>(B) * Hq;
  const int n_qtiles = (Tq + kQT - 1) / kQT;
  const long long q_blocks = bh * n_qtiles;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const float scale_log2 = scale * kLog2e;
  dkdv_bf16_kernel<NB><<<static_cast<unsigned>(kv_blocks), 2 * kWG, smem_kv,
                         stream>>>(
      maps[0], maps[1], maps[4], maps[5], ws,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      st[6], st[7], static_cast<int>(bhkv), Hq, Hkv, Tq, Tk, ld, d, causal,
      scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_bf16_kernel<NB><<<static_cast<unsigned>(q_blocks), 2 * kWG, smem_q,
                       stream>>>(
      maps[2], maps[3], maps[4], maps[5], ws,
      static_cast<__nv_bfloat16*>(dq), st[5], static_cast<int>(bh), Hq, Hkv,
      Tq, Tk, ld, d, causal, scale_log2, scale, n_qtiles);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const float* lse,
                        float* ws, void* dq, void* dk, void* dv,
                        const Strides* st, int B, int Hq, int Hkv, int Tq,
                        int Tk, int d, int causal, float scale,
                        cudaStream_t stream) {
  const int ld = (Tq + kQS - 1) / kQS * kQS;
  CUtensorMap maps[6];
  cudaError_t err = encode_map(&maps[0], q, B, Hq, Tq, d, st[0], kQS);
  if (err == cudaSuccess)
    err = encode_map(&maps[1], dout, B, Hq, Tq, d, st[4], kQS);
  if (err == cudaSuccess)
    err = encode_map(&maps[2], q, B, Hq, Tq, d, st[0], kQT);
  if (err == cudaSuccess)
    err = encode_map(&maps[3], dout, B, Hq, Tq, d, st[4], kQT);
  if (err == cudaSuccess)
    err = encode_map(&maps[4], k, B, Hkv, Tk, d, st[1], kKT);
  if (err == cudaSuccess)
    err = encode_map(&maps[5], v, B, Hkv, Tk, d, st[2], kKT);
  if (err != cudaSuccess) return err;
  const long long bh_ld = static_cast<long long>(B) * Hq * ld;
  err = launch_rowdot<__nv_bfloat16>(out, dout, ws + bh_ld, lse, ws, st, B,
                                     Hq, Tq, ld, d, stream);
  if (err != cudaSuccess) return err;
  if (d <= 64)
    return launch_bf16_nb<1>(maps, ws, dq, dk, dv, st, B, Hq, Hkv, Tq, Tk,
                             ld, d, causal, scale, stream);
  return launch_bf16_nb<2>(maps, ws, dq, dk, dv, st, B, Hq, Hkv, Tq, Tk, ld,
                           d, causal, scale, stream);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16. `strides` holds 24 element strides: (batch,
// head, row) of q, k, v, out, dout, dq, dk and dv in that order; the last
// dimension of each is contiguous. lse is a contiguous [B, Hq, Tq] f32
// buffer; `ws` a scratch of 2 * B * Hq * ceil(Tq / 64) * 64 f32. Needs B,
// Hq, Tq, Tk > 0, d <= 128 with d % 8 == 0 and Hq % Hkv == 0, and for
// bf16 16-byte aligned bases and strides and a 16-byte aligned `ws` (the
// wrapper checks; it answers empty inputs itself). Launches three kernels
// on `stream` of `device` and returns the first failing launch's
// cudaError_t (0 on success). Does not synchronise.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* ws, void* dq, void* dk, void* dv,
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
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return launch_f32(q, k, v, out, dout, l, w, dq, dk, dv, st, B, Hq, Hkv,
                      Tq, Tk, d, causal, scale, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, dout, l, w, dq, dk, dv, st, B, Hq, Hkv,
                       Tq, Tk, d, causal, scale, s);
  return cudaErrorInvalidValue;
}
