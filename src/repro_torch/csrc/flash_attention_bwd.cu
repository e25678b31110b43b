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
//   q, dq [B, Hq, Tq, dqk]; k, dk [B, Hkv, Tk, dqk]; v, dv [B, Hkv, Tk,
//   dv]; out, dout [B, Hq, Tq, dv] (out is the forward's); each a strided
//   view (element strides of the first three dimensions, the last one
//   contiguous), one dtype (f32 or bf16); lse [B, Hq, Tq] f32 contiguous;
//   dqk <= 192 and dv <= 128, each a multiple of 8 (MLA: 128 nope + 64
//   rope and v 128; the other models dqk = dv); f32 math (the bf16 body
//   rounds P and dS to bf16 as operands, below):
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
//     and V come in once by TMA; the q steps (QS queries) of Q and dO,
//     with their lse * log2(e) and D, arrive through a two-stage ring
//     (TMA and bulk copies completing on mbarriers); the second warpgroup
//     to finish with a stage refills it (a count in shared memory says
//     which), so neither waits for the other. A step computes
//     S^T = K Q^T and dP^T = V dO^T (m64nQS, both operands K-major in
//     shared memory), P^T = exp2 on the fragment with scale * log2(e)
//     folded in and lse read per column, dS^T = P^T (dP^T - D), packs P^T
//     and dS^T to bf16 pairs in registers (the A-operand layout) and
//     accumulates dV += P^T dO and dK += dS^T Q (A from registers, dO and Q
//     MN-major from shared memory).
//   - dq: a block of two warpgroups owns 128 query rows, 64 a warpgroup;
//     Q and dO come in once, K and V tiles of KT keys through a two-stage
//     ring refilled the same way; S = Q K^T and dP = dO V^T (m64nKT) in
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
//   - two widths: every kernel is templated on NBQK and NBV, the 64-column
//     boxes of q/k and of v/dout (dqk <= 64 NBQK, dv <= 64 NBV). Up to four
//     boxes in all, QS = 64 and KT = 128. At MLA's (3, 2) dK and dV hold
//     (3 + 2) * 32 = 160 f32 registers a thread, which beside m64n64 S^T
//     and dP^T (64 more) would spill, so the step shrinks to QS = 32
//     (m64n32: 16 registers each); and the dq kernel's Q and dO (80 KiB)
//     beside two stages of 128-key K and V (160 KiB) would pass the 227
//     KiB a block may have, so its kv tiles hold KT = 64 keys (two stages,
//     80 KiB; 161 KiB in all, and S and dP at m64n64).
//
// f32 inputs (not on the model's path) keep a scalar body: 64-row tiles
// staged in shared memory as f32, f32 FMAs on a 16 x 16 thread grid (4 x 4
// products a thread), the tiles as wide as the smallest of the forward's
// (DQK, DV) pairs that holds the widths (194 KiB at (192, 128)); the
// tensor cores' TF32 would not hold f32 tolerances.
//
// Bound on this card: operations. Five products a visible (query, key)
// pair, 2 * (3 dqk + 2 dv) flops (S, dK and dQ over dqk; dP and dV over dv;
// this design recomputes S and dP in the dq pass, seven in all) against
// reading q, k, v, out, dout once and writing dq, dk, dv once.

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

// DQK >= dqk and DV >= dv: the widths of the shared-memory tiles
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
            Strides sv, Strides sdo, Strides sdk, Strides sdv, int BHkv,
            int Hq, int Hkv, int Tq, int Tk, int dqk, int dvw, int causal,
            float scale) {
  constexpr int LQ = DQK + 1, LV = DV + 1, LP = kT + 1;
  constexpr int NQ = DQK / 16, NV = DV / 16;  // output columns a thread
  extern __shared__ float smem[];
  float* sK = smem;                           // [kT][LQ]
  float* sV = sK + kT * LQ;                   // [kT][LV]
  float* sQ = sV + kT * LV;                   // [kT][LQ]
  float* sO = sQ + kT * LQ;                   // dout [kT][LV]
  float* sP = sO + kT * LV;                   // P^T [key][query]
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

  load_tile(sK, LQ, k + b * sk.b + kvi * sk.h, sk.t, k0, Tk, dqk);
  load_tile(sV, LV, v + b * sv.b + kvi * sv.h, sv.t, k0, Tk, dvw);

  float acc_k[4][NQ], acc_v[4][NV];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc_k[r][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) acc_v[r][j] = 0.f;
  }

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
      load_tile(sQ, LQ, q + b * sq.b + i * sq.h, sq.t, q0, Tq, dqk);
      load_tile(sO, LV, dout + b * sdo.b + i * sdo.h, sdo.t, q0, Tq, dvw);
      load_vec(sL, lse + row_base, q0, Tq);
      load_vec(sD, D + row_base, q0, Tq);
      __syncthreads();

      // S^T (over dqk) and dP^T (over dv) for keys ty + 16r, queries
      // tx + 16c
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
      for (int dd = 0; dd < dqk; ++dd) {
        float kv[4], qv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) kv[r] = sK[(ty + 16 * r) * LQ + dd];
#pragma unroll
        for (int c = 0; c < 4; ++c) qv[c] = sQ[(tx + 16 * c) * LQ + dd];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(kv[r], qv[c], s[r][c]);
      }
      for (int dd = 0; dd < dvw; ++dd) {
        float vv[4], ov[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) vv[r] = sV[(ty + 16 * r) * LV + dd];
#pragma unroll
        for (int c = 0; c < 4; ++c) ov[c] = sO[(tx + 16 * c) * LV + dd];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dp[r][c] = fmaf(vv[r], ov[c], dp[r][c]);
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
        float pv[4], sv_[4], ov[NV], qv[NQ];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = sP[(ty + 16 * r) * LP + qq];
          sv_[r] = sS[(ty + 16 * r) * LP + qq];
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) ov[j] = sO[qq * LV + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < NQ; ++j) qv[j] = sQ[qq * LQ + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int j = 0; j < NV; ++j)
            acc_v[r][j] = fmaf(pv[r], ov[j], acc_v[r][j]);
#pragma unroll
          for (int j = 0; j < NQ; ++j)
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
    for (int j = 0; j < NQ; ++j) {
      const int c = tx + 16 * j;
      if (c < dqk) dkh[row * sdk.t + c] = from_f32<T>(acc_k[r][j] * scale);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = tx + 16 * j;
      if (c < dvw) dvh[row * sdv.t + c] = from_f32<T>(acc_v[r][j]);
    }
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
          Strides sdo, Strides sdq, int BH, int Hq, int Hkv, int Tq, int Tk,
          int dqk, int dvw, int causal, float scale, int n_qtiles) {
  constexpr int LQ = DQK + 1, LV = DV + 1, LP = kT + 1;
  constexpr int NQ = DQK / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                           // [kT][LQ]
  float* sO = sQ + kT * LQ;                   // dout [kT][LV]
  float* sK = sO + kT * LV;                   // [kT][LQ]
  float* sV = sK + kT * LQ;                   // [kT][LV]
  float* sS = sV + kT * LV;                   // dS [query][key]
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

  load_tile(sQ, LQ, q + b * sq.b + i * sq.h, sq.t, q0, Tq, dqk);
  load_tile(sO, LV, dout + b * sdo.b + i * sdo.h, sdo.t, q0, Tq, dvw);
  load_vec(sL, lse + row_base, q0, Tq);
  load_vec(sD, D + row_base, q0, Tq);

  // keys past the last one any row sees carry no gradient to dq
  int kend = Tk;
  if (causal) kend = min(Tk, max(0, min(q0 + kT, Tq) + offset));

  float acc[4][NQ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc[r][j] = 0.f;

  const T* kh = k + b * sk.b + kvi * sk.h;
  const T* vh = v + b * sv.b + kvi * sv.h;
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();                          // the last tile's reads done
    load_tile(sK, LQ, kh, sk.t, k0, Tk, dqk);
    load_tile(sV, LV, vh, sv.t, k0, Tk, dvw);
    __syncthreads();

    // S (over dqk) and dP (over dv) for queries ty + 16r, keys tx + 16c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int dd = 0; dd < dqk; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(ty + 16 * r) * LQ + dd];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * LQ + dd];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
    for (int dd = 0; dd < dvw; ++dd) {
      float ov[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ov[r] = sO[(ty + 16 * r) * LV + dd];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = sV[(tx + 16 * c) * LV + dd];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
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
      float sv_[4], kv[NQ];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv_[r] = sS[(ty + 16 * r) * LP + kk];
#pragma unroll
      for (int j = 0; j < NQ; ++j) kv[j] = sK[kk * LQ + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < NQ; ++j)
          acc[r][j] = fmaf(sv_[r], kv[j], acc[r][j]);
    }
  }

  T* dqh = dq + b * sdq.b + i * sdq.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Tq) continue;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c = tx + 16 * j;
      if (c < dqk) dqh[row * sdq.t + c] = from_f32<T>(acc[r][j] * scale);
    }
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const float* lse,
                         float* D, void* dq, void* dk, void* dv,
                         const Strides* st, int B, int Hq, int Hkv, int Tq,
                         int Tk, int dqk, int dvw, int causal, float scale,
                         cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  cudaError_t err = launch_rowdot<T>(out, dout, D, nullptr, nullptr, st, B,
                                     Hq, Tq, Tq, dvw, stream);
  if (err != cudaSuccess) return err;

  // 194 KiB for dk/dv and 178 KiB for dq at (192, 128)
  constexpr int LQ = DQK + 1, LV = DV + 1, LP = kT + 1;
  const size_t smem_kv = sizeof(float) *
      (2 * kT * (LQ + LV) + 2 * kT * LP + 2 * kT);
  const size_t smem_q = sizeof(float) *
      (2 * kT * (LQ + LV) + kT * LP + 2 * kT);
  err = cudaFuncSetAttribute(dkdv_kernel<T, DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, DQK, DV>,
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
    dkdv_kernel<T, DQK, DV><<<static_cast<unsigned>(kv_blocks), kThreads,
                              smem_kv, stream>>>(
        qp, kp, vp, gp, lse, D, static_cast<T*>(dk), static_cast<T*>(dv),
        st[0], st[1], st[2], st[4], st[6], st[7], static_cast<int>(bhkv), Hq,
        Hkv, Tq, Tk, dqk, dvw, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dq_kernel<T, DQK, DV><<<static_cast<unsigned>(q_blocks), kThreads, smem_q,
                          stream>>>(
      qp, kp, vp, gp, lse, D, static_cast<T*>(dq), st[0], st[1], st[2],
      st[4], st[5], static_cast<int>(bh), Hq, Hkv, Tq, Tk, dqk, dvw, causal,
      scale, n_qtiles);
  return cudaGetLastError();
}

// the smallest tile widths that hold (dqk, dv), as the forward's f32 body
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* D, void* dq, void* dk, void* dv,
                       const Strides* st, int B, int Hq, int Hkv, int Tq,
                       int Tk, int dqk, int dvw, int causal, float scale,
                       cudaStream_t stream) {
#define FLASH_BWD_F32(DQK, DV)                                              \
  if (dqk <= DQK && dvw <= DV)                                              \
    return launch_typed<float, DQK, DV>(q, k, v, out, dout, lse, D, dq, dk, \
                                        dv, st, B, Hq, Hkv, Tq, Tk, dqk,    \
                                        dvw, causal, scale, stream);
  FLASH_BWD_F32(64, 64)
  FLASH_BWD_F32(128, 64)
  FLASH_BWD_F32(64, 128)
  FLASH_BWD_F32(128, 128)
  FLASH_BWD_F32(192, 64)
  FLASH_BWD_F32(192, 128)
#undef FLASH_BWD_F32
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                    // threads per warpgroup
constexpr int kStages = 2;                  // ring depth of both kernels
constexpr int kKT = 128;                    // keys a dk/dv block
constexpr int kQT = 128;                    // query rows a dq block
constexpr int kLdRows = 64;                 // the scratch's row padding
constexpr uint32_t kRowBytes = kSwizzleCols * 2;     // a box row: 128 B
constexpr uint32_t kBox128 = 128 * kRowBytes;        // [128][64] bf16
constexpr uint32_t kBox64 = 64 * kRowBytes;          // a warpgroup's 64 rows

// wgmma m64nNk16 with A and B K-major in shared memory, for the N of a
// score tile (32, 64 or 128 columns): `first` writes D, `acc` adds to it
template <int N> struct ScoreMma;
template <> struct ScoreMma<32> {
  static __device__ __forceinline__ void first(float (&d)[16], uint64_t a,
                                               uint64_t b) {
    wgmma_m64n32_ss_first(d, a, b);
  }
  static __device__ __forceinline__ void acc(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n32_ss(d, a, b);
  }
};
template <> struct ScoreMma<64> {
  static __device__ __forceinline__ void first(float (&d)[32], uint64_t a,
                                               uint64_t b) {
    wgmma_m64n64_ss_first(d, a, b);
  }
  static __device__ __forceinline__ void acc(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n64_ss(d, a, b);
  }
};
template <> struct ScoreMma<128> {
  static __device__ __forceinline__ void first(float (&d)[64], uint64_t a,
                                               uint64_t b) {
    wgmma_m64n128_ss_first(d, a, b);
  }
  static __device__ __forceinline__ void acc(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n128_ss(d, a, b, 1);
  }
};

// NBQK boxes of 64 columns for q and k (dqk <= 64 * NBQK), NBV for v and
// dout (dv <= 64 * NBV); QS queries a step (64, or 32 where the
// accumulators of dK and dV take 160 registers). ws: [2][B*Hq][ld] f32,
// lse*log2(e) then D (rowdot_kernel), ld a multiple of kLdRows.
template <int NBQK, int NBV, int QS>
__global__ void __launch_bounds__(2 * kWG, 1)
dkdv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,   // QS-row boxes
                 const __grid_constant__ CUtensorMap map_do,  // QS-row boxes
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const float* __restrict__ ws,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, Strides sdk, Strides sdv,
                 int BHkv, int Hq, int Hkv, int Tq, int Tk, int ld, int dqk,
                 int dvw, int causal, float scale_log2, float scale) {
  constexpr uint32_t kBoxQS = QS * kRowBytes;           // [QS][64] bf16
  constexpr int NS = QS / 2;                            // S^T registers
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  __shared__ int released[kStages];   // warpgroups done with each stage
  // boxes must start on 1024 bytes: the swizzle pattern repeats there
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  constexpr uint32_t kQBytes = NBQK * kBoxQS;           // a step of Q
  constexpr uint32_t kOBytes = NBV * kBoxQS;            // a step of dO
  const uint32_t sK = base;                             // [NBQK] boxes
  const uint32_t sV = sK + NBQK * kBox128;              // [NBV]
  const uint32_t sQ = sV + NBV * kBox128;               // [kStages][NBQK]
  const uint32_t sO = sQ + kStages * kQBytes;           // [kStages][NBV]
  const uint32_t sLD = sO + kStages * kOBytes;          // [kStages][2][QS]
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
  const int n_qs = (Tq + QS - 1) / QS;
  const long long d_off = static_cast<long long>(BHkv) * group * ld;

  // a q step is skipped when no row of it sees these keys and every row
  // sees some key; (gi, qs) walks the group's q heads and their live steps
  auto live = [&](int qs) {
    const int q0 = qs * QS;
    const int q_last = min(q0 + QS, Tq) - 1;
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
    const int q0 = qs * QS;
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect_tx(bar, kQBytes + kOBytes + 2 * QS * 4);
#pragma unroll
    for (int x = 0; x < NBQK; ++x)
      tma_load_4d(sQ + s * kQBytes + x * kBoxQS, &map_q, bar,
                  x * kSwizzleCols, q0, i, b);
#pragma unroll
    for (int x = 0; x < NBV; ++x)
      tma_load_4d(sO + s * kOBytes + x * kBoxQS, &map_do, bar,
                  x * kSwizzleCols, q0, i, b);
    const float* row = ws + (static_cast<long long>(b) * Hq + i) * ld + q0;
    bulk_load(sLD + s * 2 * QS * 4, row, QS * 4, bar);
    bulk_load(sLD + s * 2 * QS * 4 + QS * 4, row + d_off, QS * 4, bar);
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
    mbar_expect_tx(bar_kv, (NBQK + NBV) * kBox128);
#pragma unroll
    for (int x = 0; x < NBQK; ++x)
      tma_load_4d(sK + x * kBox128, &map_k, bar_kv, x * kSwizzleCols, k0,
                  kvi, b);
#pragma unroll
    for (int x = 0; x < NBV; ++x)
      tma_load_4d(sV + x * kBox128, &map_v, bar_kv, x * kSwizzleCols, k0,
                  kvi, b);
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
  float dka[NBQK][32], dva[NBV][32];
#pragma unroll
  for (int x = 0; x < NBQK; ++x)
#pragma unroll
    for (int r = 0; r < 32; ++r) dka[x][r] = 0.f;
#pragma unroll
  for (int x = 0; x < NBV; ++x)
#pragma unroll
    for (int r = 0; r < 32; ++r) dva[x][r] = 0.f;

  mbar_wait(bar_kv, 0);
  int gi = 0, qs = -1;
  advance(gi, qs);
  for (int j = 0; gi < group; ++j, advance(gi, qs)) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(bar_full + 8 * st, parity);
    const uint32_t q_s = sQ + st * kQBytes, o_s = sO + st * kOBytes;

    // S^T = K Q^T over the dqk columns and dP^T = V dO^T over the dv
    // columns, in steps of 16; every step of every box is issued (no
    // branch between the wgmmas): columns past a width are zeros in both
    // operands, and the first step writes s and dp afresh
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < NBQK; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t ka = smem_desc(
            sK + x * kBox128 + wg * kBox64 + kk * 32, 16, 1024);
        const uint64_t qb = smem_desc(q_s + x * kBoxQS + kk * 32, 16, 1024);
        if (x + kk == 0) ScoreMma<QS>::first(s, ka, qb);
        else ScoreMma<QS>::acc(s, ka, qb);
      }
#pragma unroll
    for (int x = 0; x < NBV; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t va = smem_desc(
            sV + x * kBox128 + wg * kBox64 + kk * 32, 16, 1024);
        const uint64_t ob = smem_desc(o_s + x * kBoxQS + kk * 32, 16, 1024);
        if (x + kk == 0) ScoreMma<QS>::first(dp, va, ob);
        else ScoreMma<QS>::acc(dp, va, ob);
      }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T; lse (log2 units) and D are per column (query)
    const int q0 = qs * QS;
    const float* l2 = lds + st * 2 * QS;
    const float* dd = l2 + QS;
    const bool edge = (causal && kw0 + 63 > q0 + offset) || kw0 + 64 > Tk ||
                      q0 + QS > Tq;
#pragma unroll
    for (int r = 0; r < NS; ++r) {
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
    uint32_t pa[QS / 16][4], sa[QS / 16][4];
#pragma unroll
    for (int kk = 0; kk < QS / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        sa[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      }
#pragma unroll
    for (int x = 0; x < NBV; ++x) fence_regs(dva[x]);
#pragma unroll
    for (int x = 0; x < NBQK; ++x) fence_regs(dka[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QS / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < NBV; ++x) {
        const uint32_t off = x * kBoxQS + kk * 16 * kRowBytes;
        wgmma_m64n64_rs(dva[x], pa[kk], smem_desc(o_s + off, kBoxQS, 1024));
      }
#pragma unroll
      for (int x = 0; x < NBQK; ++x) {
        const uint32_t off = x * kBoxQS + kk * 16 * kRowBytes;
        wgmma_m64n64_rs(dka[x], sa[kk], smem_desc(q_s + off, kBoxQS, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int x = 0; x < NBV; ++x) fence_regs(dva[x]);
#pragma unroll
    for (int x = 0; x < NBQK; ++x) fence_regs(dka[x]);

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
  for (int r = 0; r < 32; r += 2) {
    const int row = key0 + 8 * ((r >> 1) & 1);
    if (row >= Tk) continue;
#pragma unroll
    for (int x = 0; x < NBQK; ++x) {
      const int c = x * kSwizzleCols + 8 * (r >> 2) + col0;
      if (c < dqk)
        *reinterpret_cast<__nv_bfloat162*>(dkh + row * sdk.t + c) =
            __floats2bfloat162_rn(dka[x][r] * scale, dka[x][r + 1] * scale);
    }
#pragma unroll
    for (int x = 0; x < NBV; ++x) {
      const int c = x * kSwizzleCols + 8 * (r >> 2) + col0;
      if (c < dvw)
        *reinterpret_cast<__nv_bfloat162*>(dvh + row * sdv.t + c) =
            __floats2bfloat162_rn(dva[x][r], dva[x][r + 1]);
    }
  }
}

// KT keys a kv tile (128, or 64 where two stages of 128-key K and V tiles
// would not fit beside Q and dO)
template <int NBQK, int NBV, int KT>
__global__ void __launch_bounds__(2 * kWG, 1)
dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,   // 128-row boxes
               const __grid_constant__ CUtensorMap map_do,  // 128-row boxes
               const __grid_constant__ CUtensorMap map_k,   // KT-row boxes
               const __grid_constant__ CUtensorMap map_v,   // KT-row boxes
               const float* __restrict__ ws, __nv_bfloat16* __restrict__ dq,
               Strides sdq, int BH, int Hq, int Hkv, int Tq, int Tk, int ld,
               int dqk, int dvw, int causal, float scale_log2, float scale,
               int n_qtiles) {
  constexpr uint32_t kBoxKT = KT * kRowBytes;           // [KT][64] bf16
  constexpr int NS = KT / 2;                            // S registers
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  __shared__ int released[kStages];   // warpgroups done with each stage
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                              // [NBQK] boxes
  const uint32_t sO = sQ + NBQK * kBox128;               // [NBV]
  const uint32_t sK = sO + NBV * kBox128;                // [kStages][NBQK]
  const uint32_t sV = sK + kStages * NBQK * kBoxKT;      // [kStages][NBV]
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
  const int n_tiles = (kend + KT - 1) / KT;

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
    mbar_expect_tx(bar, (NBQK + NBV) * kBoxKT);
#pragma unroll
    for (int x = 0; x < NBQK; ++x)
      tma_load_4d(sK + (s * NBQK + x) * kBoxKT, &map_k, bar,
                  x * kSwizzleCols, tile * KT, kvi, b);
#pragma unroll
    for (int x = 0; x < NBV; ++x)
      tma_load_4d(sV + (s * NBV + x) * kBoxKT, &map_v, bar,
                  x * kSwizzleCols, tile * KT, kvi, b);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, (NBQK + NBV) * kBox128);
#pragma unroll
    for (int x = 0; x < NBQK; ++x)
      tma_load_4d(sQ + x * kBox128, &map_q, bar_q, x * kSwizzleCols, q0, i,
                  b);
#pragma unroll
    for (int x = 0; x < NBV; ++x)
      tma_load_4d(sO + x * kBox128, &map_do, bar_q, x * kSwizzleCols, q0, i,
                  b);
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
  float dqa[NBQK][32];
#pragma unroll
  for (int x = 0; x < NBQK; ++x)
#pragma unroll
    for (int r = 0; r < 32; ++r) dqa[x][r] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(bar_full + 8 * st, parity);

    // S = Q K^T over the dqk columns and dP = dO V^T over the dv columns
    // in steps of 16, one commit group each, every step issued as in the
    // dk/dv kernel (the first step writes s and dp afresh; columns past
    // the width are zeros in both operands)
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < NBQK; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t qa = smem_desc(
            sQ + x * kBox128 + wg * kBox64 + kk * 32, 16, 1024);
        const uint64_t kb = smem_desc(
            sK + (st * NBQK + x) * kBoxKT + kk * 32, 16, 1024);
        if (x + kk == 0) ScoreMma<KT>::first(s, qa, kb);
        else ScoreMma<KT>::acc(s, qa, kb);
      }
    wgmma_commit();
#pragma unroll
    for (int x = 0; x < NBV; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t oa = smem_desc(
            sO + x * kBox128 + wg * kBox64 + kk * 32, 16, 1024);
        const uint64_t vb = smem_desc(
            sV + (st * NBV + x) * kBoxKT + kk * 32, 16, 1024);
        if (x + kk == 0) ScoreMma<KT>::first(dp, oa, vb);
        else ScoreMma<KT>::acc(dp, oa, vb);
      }
    wgmma_commit();

    // P = exp2(S - lse) per row (log2 units) while dP runs, then
    // dS = P (dP - D), 0 where masked
    wgmma_wait1();
    fence_regs(s);
#pragma unroll
    for (int r = 0; r < NS; ++r)
      s[r] = exp2f(s[r] * scale_log2 - l2[(r >> 1) & 1]);
    wgmma_wait0();
    fence_regs(dp);
    const int k0 = j * KT;
    const bool edge = (causal && k0 + KT - 1 > qw0 + offset) ||
                      k0 + KT > Tk || qw0 + 64 > Tq;
#pragma unroll
    for (int r = 0; r < NS; ++r) {
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
    uint32_t sa[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sa[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
#pragma unroll
    for (int x = 0; x < NBQK; ++x) fence_regs(dqa[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int x = 0; x < NBQK; ++x) {
        const uint32_t off = (st * NBQK + x) * kBoxKT + kk * 16 * kRowBytes;
        wgmma_m64n64_rs(dqa[x], sa[kk], smem_desc(sK + off, kBoxKT, 1024));
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int x = 0; x < NBQK; ++x) fence_regs(dqa[x]);

    // the second warpgroup done with this stage refills it with tile j + 2
    if (wtid == 0 && atomicAdd(&released[st], 1) % 2 == 1 &&
        j + kStages < n_tiles)
      load_kv(j + kStages, st);
    __syncwarp();
  }

  __nv_bfloat16* dqh = dq + b * sdq.b + i * sdq.h;
#pragma unroll
  for (int x = 0; x < NBQK; ++x)
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int row = row0 + 8 * ((r >> 1) & 1);
      const int c = x * kSwizzleCols + 8 * (r >> 2) + col0;
      if (row < Tq && c < dqk)
        *reinterpret_cast<__nv_bfloat162*>(dqh + row * sdq.t + c) =
            __floats2bfloat162_rn(dqa[x][r] * scale, dqa[x][r + 1] * scale);
    }
}

// The dk/dv kernel's query step and the dq kernel's key tile for (NBQK,
// NBV): at five boxes (MLA's (192, 128)) dK and dV take 160 accumulator
// registers, so S^T and dP^T shrink to m64n32 (16 registers each), and two
// stages of 128-key K and V tiles beside Q and dO would take 241 KiB of
// shared memory, so the dq kernel's kv tiles hold 64 keys (161 KiB).
template <int NBQK, int NBV> struct BwdTiles {
  static constexpr int QS = NBQK + NBV > 4 ? 32 : 64;
  static constexpr int KT = NBQK + NBV > 4 ? 64 : 128;
};

// maps: q and dout in QS-row boxes, q and dout in 128-row boxes, k and v
// in 128-row boxes, k and v in KT-row boxes
template <int NBQK, int NBV>
cudaError_t launch_bf16_nb(const CUtensorMap* maps, const float* ws,
                           void* dq, void* dk, void* dv, const Strides* st,
                           int B, int Hq, int Hkv, int Tq, int Tk, int ld,
                           int dqk, int dvw, int causal, float scale,
                           cudaStream_t stream) {
  constexpr int QS = BwdTiles<NBQK, NBV>::QS, KT = BwdTiles<NBQK, NBV>::KT;
  const size_t smem_kv = 1024 + static_cast<size_t>(NBQK + NBV) *
      (kBox128 + kStages * QS * kRowBytes) + kStages * 2 * QS * 4;
  const size_t smem_q = 1024 + static_cast<size_t>(NBQK + NBV) *
      (kBox128 + kStages * KT * kRowBytes);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_bf16_kernel<NBQK, NBV, QS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_bf16_kernel<NBQK, NBV, KT>,
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
  const int qs_map = QS == 64 ? 0 : 6;      // the QS-row q and dout maps
  dkdv_bf16_kernel<NBQK, NBV, QS><<<static_cast<unsigned>(kv_blocks),
                                    2 * kWG, smem_kv, stream>>>(
      maps[qs_map], maps[qs_map + 1], maps[2], maps[3], ws,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      st[6], st[7], static_cast<int>(bhkv), Hq, Hkv, Tq, Tk, ld, dqk, dvw,
      causal, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kt_map = KT == 128 ? 2 : 8;     // the KT-row k and v maps
  dq_bf16_kernel<NBQK, NBV, KT><<<static_cast<unsigned>(q_blocks), 2 * kWG,
                                  smem_q, stream>>>(
      maps[4], maps[5], maps[kt_map], maps[kt_map + 1], ws,
      static_cast<__nv_bfloat16*>(dq), st[5], static_cast<int>(bh), Hq, Hkv,
      Tq, Tk, ld, dqk, dvw, causal, scale_log2, scale, n_qtiles);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const float* lse,
                        float* ws, void* dq, void* dk, void* dv,
                        const Strides* st, int B, int Hq, int Hkv, int Tq,
                        int Tk, int dqk, int dvw, int causal, float scale,
                        cudaStream_t stream) {
  const int ld = (Tq + kLdRows - 1) / kLdRows * kLdRows;
  // [0, 1] q and dout in 64-row boxes (the dk/dv steps), [2, 3] k and v in
  // 128-row boxes, [4, 5] q and dout in 128-row boxes (the dq tiles),
  // [6, 7] q and dout in 32-row boxes, [8, 9] k and v in 64-row boxes
  CUtensorMap maps[10];
  const void* ptr[10] = {q, dout, k, v, q, dout, q, dout, k, v};
  const int heads[10] = {Hq, Hq, Hkv, Hkv, Hq, Hq, Hq, Hq, Hkv, Hkv};
  const int rows[10] = {Tq, Tq, Tk, Tk, Tq, Tq, Tq, Tq, Tk, Tk};
  const int width[10] = {dqk, dvw, dqk, dvw, dqk, dvw, dqk, dvw, dqk, dvw};
  const int box[10] = {64, 64, kKT, kKT, kQT, kQT, 32, 32, 64, 64};
  const int which[10] = {0, 4, 1, 2, 0, 4, 0, 4, 1, 2};   // strides
  cudaError_t err = cudaSuccess;
  for (int m = 0; m < 10 && err == cudaSuccess; ++m)
    err = encode_map(&maps[m], ptr[m], B, heads[m], rows[m], width[m],
                     st[which[m]], box[m]);
  if (err != cudaSuccess) return err;
  const long long bh_ld = static_cast<long long>(B) * Hq * ld;
  err = launch_rowdot<__nv_bfloat16>(out, dout, ws + bh_ld, lse, ws, st, B,
                                     Hq, Tq, ld, dvw, stream);
  if (err != cudaSuccess) return err;
  const int nbqk = (dqk + kSwizzleCols - 1) / kSwizzleCols;
  const int nbv = (dvw + kSwizzleCols - 1) / kSwizzleCols;
#define FLASH_BWD_BF16(NBQK, NBV)                                           \
  if (nbqk == NBQK && nbv == NBV)                                           \
    return launch_bf16_nb<NBQK, NBV>(maps, ws, dq, dk, dv, st, B, Hq, Hkv,  \
                                     Tq, Tk, ld, dqk, dvw, causal, scale,   \
                                     stream);
  FLASH_BWD_BF16(1, 1)
  FLASH_BWD_BF16(2, 2)
  FLASH_BWD_BF16(1, 2)
  FLASH_BWD_BF16(2, 1)
  FLASH_BWD_BF16(3, 1)
  FLASH_BWD_BF16(3, 2)
#undef FLASH_BWD_BF16
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16. `strides` holds 24 element strides: (batch,
// head, row) of q, k, v, out, dout, dq, dk and dv in that order; the last
// dimension of each is contiguous. q, k, dq, dk are dqk wide; v, out,
// dout, dv are dv wide. lse is a contiguous [B, Hq, Tq] f32 buffer; `ws`
// a scratch of 2 * B * Hq * ceil(Tq / 64) * 64 f32. Needs B, Hq, Tq,
// Tk > 0, dqk <= 192 and dv <= 128, each a multiple of 8, Hq % Hkv == 0,
// and for bf16 16-byte aligned bases and strides and a 16-byte aligned
// `ws` (the wrapper checks; it answers empty inputs itself). Launches
// three kernels on `stream` of `device` and returns the first failing
// launch's cudaError_t (0 on success). Does not synchronise.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* ws, void* dq, void* dk, void* dv,
    int B, int Hq, int Hkv, int Tq, int Tk, int dqk, int dvw,
    const long long* strides, int causal, float scale, int dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dqk <= 0 || dqk > 192 || dqk % 8 != 0 || dvw <= 0 || dvw > 128 ||
      dvw % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || Hq <= 0 ||
      Tq <= 0 || Tk <= 0)
    return cudaErrorInvalidValue;
  Strides st[8];
  for (int t = 0; t < 8; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return launch_f32(q, k, v, out, dout, l, w, dq, dk, dv, st, B, Hq, Hkv,
                      Tq, Tk, dqk, dvw, causal, scale, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, dout, l, w, dq, dk, dv, st, B, Hq, Hkv,
                       Tq, Tk, dqk, dvw, causal, scale, s);
  return cudaErrorInvalidValue;
}
