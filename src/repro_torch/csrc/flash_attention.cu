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
//   q [B, Hq, Tq, d], k and v [B, Hkv, Tk, d], out [B, Hq, Tq, d], each a
//   strided view (element strides for the first three dimensions, the
//   last one contiguous), one dtype (f32 or bf16); f32 math;
//   out = softmax(scale * q k^T + mask) v.
//   - GQA: q head i of batch b reads kv head i / (Hq / Hkv) of batch b.
//   - causal: query row r sees keys kpos <= r + (Tk - Tq) (aligned
//     bottom-right, so a decode step's rows see the whole prefix).
//   - masked scores are the finite NEG_INF = -1e30, never -inf, as in the
//     Pallas kernel: a row that sees no key (causal with Tk < Tq) comes out
//     as the mean of V over all Tk keys, not NaN.
//   - ragged tails: any Tq and Tk; keys past Tk take no part at all.
//   - d <= 128, a multiple of 8.
//   - optional lse [B, Hq, Tq] f32 (contiguous), the row's log-sum-exp of
//     the scaled, masked scores (m + log(l) in natural units), which the
//     backward (flash_attention_bwd.cu) reads; a row that sees no key gets
//     log(l) = log(Tk), its masked scores read as 0 rather than NEG_INF
//     (NEG_INF + log(Tk) would round to NEG_INF and lose the 1/Tk
//     weights). Written where each body normalises its rows, once a row;
//     a null pointer (the serving path) skips it.
//
// Bound on this card: operations at the model's shapes (Tq = Tk = 4096,
// d = 64: 4*d flops per visible (query, key) pair against 2*d*2 bytes of
// K/V per key), far above the bytes' time.
//
// bf16 design (the model's path), for the tensor cores:
//   - one block of two warpgroups per (q head, 128-row q tile); warpgroup
//     w owns query rows [64w, 64w + 64) of the tile. Heavy (late) causal
//     q tiles of every head are launched first.
//   - TMA (cp.async.bulk.tensor, 4-D tensor maps [B, H, T, d] over the
//     caller's strides, encoded on the host per call) copies the q tile
//     once and 128-key K and V tiles into a ring of two stages, each stage
//     completing on an mbarrier. Thread 0 issues tile j + 2 into a stage as
//     soon as both warpgroups have released it, so one tile is in flight
//     while the warpgroups compute the other. Rows past T and columns past
//     d arrive zero-filled, so ragged tails and d < 64 need no special
//     loads; a d <= 64 tile is one [128 rows][64 columns] box, d <= 128
//     two. Shared memory is swizzled by 128 bytes (one bf16 row of a box).
//   - S = Q K^T: wgmma m64n128k16, Q and K K-major from shared memory,
//     f32 accumulators in registers.
//   - online softmax on the accumulator fragment (a row lives in the four
//     lanes of a quad: two shuffles for its max); exp2f with
//     scale * log2(e) folded in; the row sums stay per thread and are
//     reduced once at the end. The masks are applied only on tiles that
//     reach the causal diagonal or past Tk.
//   - O += P V: P is packed to bf16 pairs in registers, which is already
//     wgmma's A-operand layout, and V is the B operand, MN-major, from
//     shared memory: wgmma m64n64k16 per 64 output columns.
//   - causal blocks stop after the last kv tile that any of their rows
//     sees, but only when every row of the tile sees at least one key
//     (q0 + Tk - Tq >= 0): a fully masked tile adds exactly nothing to a
//     row that sees a key, while a row that sees none must average all Tk
//     keys.
//
// f32 inputs (not on the model's path) keep a scalar body: one block of
// 256 threads per (q head, 64-row q tile) stages q and each 64-key K and V
// tile in shared memory as f32 and does the products with f32 FMAs (the
// tensor cores' TF32 would not hold f32 tolerances).
//
// Every helper (PTX wrappers, descriptors) lives in this file: the build
// hashes this source alone.

#include <cuda.h>            // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// element strides of one [B, H, T, d] view (d's stride is 1)
struct Strides {
  long long b, h, t;
};

// ---------------------------------------------------------------------------
// f32: the scalar body
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per kv tile
static_assert(kBQ == kBK, "load_tile stages 64-row tiles of q, k and v");
constexpr int kThreads = 256;   // 16 x 16

// sum / max over the 16 lanes of a half warp (one query row)
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// rows [r0, r0 + 64) of a [T, d] matrix with row stride `ld_g` into
// s[64][ld] as f32; rows past T are zero
__device__ __forceinline__ void load_tile(float* s, int ld,
                                          const float* __restrict__ g,
                                          long long ld_g, int r0, int rows,
                                          int d) {
  for (int idx = threadIdx.x; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    s[r * ld + c] = r0 + r < rows ? g[(r0 + r) * ld_g + c] : 0.f;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse,
                 Strides sq, Strides sk, Strides sv, Strides so, int Hq,
                 int Hkv, int Tq, int Tk, int d, int causal, float scale,
                 int n_qtiles) {
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
  const int b = h / Hq, i = h - b * Hq;
  const int kvi = i / (Hq / Hkv);
  const float* qh = q + b * sq.b + i * sq.h;
  const float* kh = k + b * sk.b + kvi * sk.h;
  const float* vh = v + b * sv.b + kvi * sv.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int offset = Tk - Tq;

  for (int idx = threadIdx.x; idx < kBK * LV; idx += kThreads)
    sV[idx] = 0.f;                            // columns d..DMAX stay zero
  load_tile(sQ, LQ, qh, sq.t, q0, Tq, d);

  int kend = Tk;
  if (causal && q0 + offset >= 0) {
    const int q_last = min(q0 + kBQ, Tq) - 1;
    kend = min(Tk, q_last + offset + 1);
  }

  float m[4], l[4], acc[4][NO];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                          // last tile's sK/sV/sP done
    load_tile(sK, LK, kh, sk.t, k0, Tk, d);
    load_tile(sV, LV, vh, sv.t, k0, Tk, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(ty + 16 * r) * LQ + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LK + dd];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[r][j] * scale;
        if (causal && kpos > qpos + offset) x = kNegInf;
        if (kpos >= Tk) x = -INFINITY;        // past the end: no weight
        s[r][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[r], row_max16(mt));
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        sP[(ty + 16 * r) * LP + tx + 16 * j] = p;
        ps += p;
      }
      l[r] = alpha * l[r] + row_sum16(ps);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[NO];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sP[(ty + 16 * r) * LP + c];
#pragma unroll
      for (int j = 0; j < NO; ++j) vv[j] = sV[c * LV + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < NO; ++j) acc[r][j] = fmaf(pv[r], vv[j], acc[r][j]);
    }
  }

  float* oh = out + b * so.b + i * so.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Tq) continue;
    if (lse != nullptr && tx == 0)            // one lane of the row's 16
      lse[static_cast<long long>(h) * Tq + row] =
          (m[r] == kNegInf ? 0.f : m[r]) + logf(l[r]);
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = tx + 16 * j;
      if (c < d) oh[row * so.t + c] = acc[r][j] * inv;
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, const Strides* st, int B,
                       int Hq, int Hkv, int Tq, int Tk, int d, int causal,
                       float scale, cudaStream_t stream) {
  const int dmax = d <= 64 ? 64 : 128;
  const size_t smem = sizeof(float) *
      (kBQ * (dmax + 1) + kBK * (dmax + 1) + kBK * dmax + kBQ * (kBK + 1));
  auto kernel = dmax == 64 ? flash_f32_kernel<64> : flash_f32_kernel<128>;
  cudaError_t err = cudaFuncSetAttribute(      // above 48 KB: opt in
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qtiles = (Tq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(B) * Hq * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, st[0],
      st[1],
      st[2], st[3], Hq, Hkv, Tq, Tk, d, causal, scale, n_qtiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTQ = 128;                  // query rows per block
constexpr int kTK = 128;                  // keys per kv tile
constexpr int kStages = 2;                // K/V ring depth
constexpr int kWG = 128;                  // threads per warpgroup
constexpr int kBoxCols = 64;              // bf16 columns per box (128 B)
constexpr uint32_t kBoxBytes = 128 * kBoxCols * 2;   // [128][64] bf16
constexpr uint32_t kWGRowsBytes = 64 * kBoxCols * 2; // a warpgroup's 64 rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spin until the barrier's phase of parity `parity` has completed; a wait
// that has not completed after about 2^34 cycles (seconds) can only be a
// fault of this kernel, and traps rather than holding the card forever
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (bits 62-63)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of `r` across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T, A and B K-major in shared
// memory (128-byte swizzle), bf16 in, f32 accumulate; scale_d 0 zeroes D
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (bf16 pairs in
// the accumulator's layout), B MN-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// NB boxes of 64 columns: d <= 64 * NB
template <int NB>
__global__ void __launch_bounds__(2 * kWG, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, Strides so, int BH,
                  int Hq, int Hkv, int Tq, int Tk, int d, int causal,
                  float scale_log2, int n_qtiles) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // boxes must start on 1024 bytes: the swizzle pattern repeats there
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                              // [NB] boxes
  const uint32_t sK = sQ + NB * kBoxBytes;               // [kStages][NB]
  const uint32_t sV = sK + kStages * NB * kBoxBytes;     // [kStages][NB]
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);          // [kStages]
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);

  const int tid = threadIdx.x;
  const int wg = tid / kWG, wtid = tid % kWG;
  const int warp = wtid / 32, lane = tid % 32;
  // heavy (late) q tiles of every head first
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / BH;
  const int h = static_cast<int>(blockIdx.x) % BH;
  const int b = h / Hq, i = h - b * Hq;
  const int kvi = i / (Hq / Hkv);
  const int q0 = qt * kTQ;
  const int offset = Tk - Tq;

  int kend = Tk;
  if (causal && q0 + offset >= 0)
    kend = min(Tk, min(q0 + kTQ, Tq) + offset);
  const int n_tiles = (kend + kTK - 1) / kTK;
  constexpr uint32_t kStageBytes = 2 * NB * kBoxBytes;    // K and V

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);        // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int tile, int s) {
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_load_4d(sK + (s * NB + x) * kBoxBytes, &map_k, bar, x * kBoxCols,
                  tile * kTK, kvi, b);
      tma_load_4d(sV + (s * NB + x) * kBoxBytes, &map_v, bar, x * kBoxCols,
                  tile * kTK, kvi, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, NB * kBoxBytes);
#pragma unroll
    for (int x = 0; x < NB; ++x)
      tma_load_4d(sQ + x * kBoxBytes, &map_q, bar_q, x * kBoxCols, q0, i, b);
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_kv(t, t);
  }
  __syncwarp();

  // this thread's rows of the q tile (two) and its column pairs: register
  // r of an m64nN accumulator holds row (warp*16 + lane/4 + 8*((r>>1)&1)),
  // column (8*(r>>2) + 2*(lane%4) + (r&1))
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NB][32];
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[x][r] = 0.f;
  float s[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) s[r] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(bar_full + 8 * st, parity);

    // S = Q K^T over the d columns in steps of 16
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (x * kBoxCols + kk * 16 >= d) continue;
        const uint64_t da = smem_desc(
            sQ + x * kBoxBytes + wg * kWGRowsBytes + kk * 32, 16, 1024);
        const uint64_t db = smem_desc(
            sK + (st * NB + x) * kBoxBytes + kk * 32, 16, 1024);
        wgmma_m64n128_ss(s, da, db, x + kk > 0);
      }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // scores in log2 units, masks, online softmax
    const int k0 = j * kTK;
    const bool masked = (causal && k0 + kTK - 1 > q0 + offset) ||
                        k0 + kTK > Tk;
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      float x = s[r] * scale_log2;
      if (masked) {
        const int kpos = k0 + 8 * (r >> 2) + col0 + (r & 1);
        const int qpos = row0 + 8 * ((r >> 1) & 1);
        if (causal && kpos > qpos + offset) x = kNegInf;
        if (kpos >= Tk) x = -INFINITY;        // past the end: no weight
      }
      s[r] = x;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      const int h2 = (r >> 1) & 1;
      mx[h2] = fmaxf(mx[h2], s[r]);
    }
    float alpha[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
      const float m_new = fmaxf(m[h2], mx[h2]);
      alpha[h2] = exp2f(m[h2] - m_new);
      m[h2] = m_new;
      l[h2] *= alpha[h2];
    }
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      const int h2 = (r >> 1) & 1;
      const float p = exp2f(s[r] - m[h2]);
      s[r] = p;
      l[h2] += p;
    }
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int r = 0; r < 32; ++r) o[x][r] *= alpha[(r >> 1) & 1];

    // O += P V, 16 keys a step; P's bf16 pairs are the A fragment
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
#pragma unroll
    for (int x = 0; x < NB; ++x) fence_regs(o[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        if (x * kBoxCols >= d) continue;
        const uint64_t db = smem_desc(
            sV + (st * NB + x) * kBoxBytes + kk * 16 * 128, kBoxBytes, 1024);
        wgmma_m64n64_rs(o[x], pa[kk], db);
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int x = 0; x < NB; ++x) fence_regs(o[x]);

    // both warpgroups done with this stage: refill it with tile j + 2
    if (wtid == 0) mbar_arrive(bar_empty + 8 * st);
    if (tid == 0 && j + kStages < n_tiles) {
      mbar_wait(bar_empty + 8 * st, parity);
      load_kv(j + kStages, st);
    }
    __syncwarp();
  }

  // finish the row sums over the quad; write this thread's column pairs
  __nv_bfloat16* oh = out + b * so.b + i * so.h;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
    // m is in log2 units; the quad's four lanes hold the same m and l,
    // and its first lane writes the row's lse
    const int row = row0 + 8 * h2;
    if (lse != nullptr && (lane & 3) == 0 && row < Tq)
      lse[static_cast<long long>(h) * Tq + row] =
          (m[h2] == kNegInf ? 0.f : m[h2] * 0.6931471805599453f) +
          logf(l[h2]);
    l[h2] = 1.f / (l[h2] == 0.f ? 1.f : l[h2]);
  }
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int h2 = (r >> 1) & 1;
      const int row = row0 + 8 * h2;
      const int c = x * kBoxCols + 8 * (r >> 2) + col0;
      if (row < Tq && c < d) {
        *reinterpret_cast<__nv_bfloat162*>(oh + row * so.t + c) =
            __floats2bfloat162_rn(o[x][r] * l[h2], o[x][r + 1] * l[h2]);
      }
    }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                         12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a [B, H, T, d] bf16 view as a 4-D tensor map of [128 rows][64 columns]
// boxes, 128-byte swizzle; out-of-range rows and columns read as zero
cudaError_t encode_map(CUtensorMap* map, const void* ptr, int B, int H,
                       int T, int d, const Strides& st) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.t) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kBoxCols, 128, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NB>
cudaError_t launch_bf16_nb(const CUtensorMap& mq, const CUtensorMap& mk,
                           const CUtensorMap& mv, void* out, float* lse,
                           const Strides& so, int B, int Hq, int Hkv,
                           int Tq, int Tk, int d, int causal, float scale,
                           cudaStream_t stream) {
  const size_t smem = 1024 + static_cast<size_t>(NB) * kBoxBytes *
                                 (1 + 2 * kStages);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qtiles = (Tq + kTQ - 1) / kTQ;
  const long long bh = static_cast<long long>(B) * Hq;
  const long long blocks = bh * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_bf16_kernel<NB><<<static_cast<unsigned>(blocks), 2 * kWG, smem,
                          stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, so,
      static_cast<int>(bh), Hq, Hkv, Tq, Tk, d, causal,
      scale * 1.4426950408889634f, n_qtiles);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, const Strides* st, int B,
                        int Hq, int Hkv, int Tq, int Tk, int d, int causal,
                        float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = encode_map(&mq, q, B, Hq, Tq, d, st[0]);
  if (Tk == 0) {               // no kv tile is read: any valid map will do
    mk = mv = mq;
  } else {
    if (err == cudaSuccess) err = encode_map(&mk, k, B, Hkv, Tk, d, st[1]);
    if (err == cudaSuccess) err = encode_map(&mv, v, B, Hkv, Tk, d, st[2]);
  }
  if (err != cudaSuccess) return err;
  if (d <= 64)
    return launch_bf16_nb<1>(mq, mk, mv, out, lse, st[3], B, Hq, Hkv, Tq,
                             Tk, d, causal, scale, stream);
  return launch_bf16_nb<2>(mq, mk, mv, out, lse, st[3], B, Hq, Hkv, Tq, Tk, d,
                           causal, scale, stream);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16. `strides` holds 12 element strides: (batch,
// head, row) of q, k, v and out in that order; the last dimension of each
// is contiguous. `lse` is a contiguous [B, Hq, Tq] f32 buffer for the
// rows' log-sum-exp, or null. Needs d <= 128 with d % 8 == 0 and
// Hq % Hkv == 0, and for
// bf16 16-byte aligned bases and strides (the wrapper checks). Launches on
// `stream` of `device` and returns the launch's cudaError_t (0 on
// success). Does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B,
                                      int Hq, int Hkv, int Tq, int Tk, int d,
                                      const long long* strides, int causal,
                                      float scale, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (d <= 0 || d > 128 || d % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Tq == 0) return cudaSuccess;
  Strides st[4];
  for (int t = 0; t < 4; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, static_cast<float*>(lse), st, B, Hq,
                      Hkv, Tq, Tk, d, causal, scale, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, static_cast<float*>(lse), st, B, Hq,
                       Hkv, Tq, Tk, d, causal, scale, s);
  return cudaErrorInvalidValue;
}
