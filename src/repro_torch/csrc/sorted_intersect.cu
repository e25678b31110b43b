// Row-wise padded-set intersection `a ∩ b` on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sorted_intersect_pallas`
// (src/repro/kernels/sorted_intersect.py, body `_intersect_kernel`), which
// compares every `a` lane with every `b` lane in a [bm, D, bk] broadcast:
// O(D^2) compares per row, about 1.6e7 at D = 3968.
//
// Semantics (bit-equal to repro_torch/kernels/ref.py sorted_intersect):
// out[i, j] = a[i, j] if a[i, j] != sentinel and a[i, j] occurs in b[i, :],
// else sentinel. Output keeps `a`'s slots, so it is again a padded set.
//
// Precondition: `a` and `b` are valid padded sets over [0, sentinel).
// Entries equal to `sentinel` are holes and may sit anywhere in a row (INT
// results carry them in the middle); the other entries of a row ascend
// strictly. Widths Da and Db may differ (Db <= kMaxDb). Rows that break
// the precondition get undefined (not out-of-bounds) results.
//
// Bound on this card: memory. A launch must read B*(Da+Db)*4 bytes and
// write B*Da*4 bytes. A binary search per `a` entry in shared memory (12
// bank-conflicted probes at D = 3968) costs about as much SM time as those
// bytes take, so the lookups go through a bucket table instead (two table
// reads and one or two probes).
//
// Design: one block of 256 threads per row, in rounds of 256 * 4 chunks of
// 4 ints (one 16-byte load each) when Da, Db and the bases allow it, else
// of 1 int; a 3968-wide row is one round.
//   - every global load of the row's first round, of a and of b, is issued
//     before the first barrier: 32 ints in flight per thread;
//   - b's round is staged in shared memory as it is. One block vote
//     (__syncthreads_and over each thread's adjacent pairs) finds rounds
//     that do not decrease: with valid ids below the sentinel those are
//     exactly the rounds whose holes are all in their tail (every DBQ
//     adjacency row), and they are kept as staged up to their first hole;
//   - other rounds are compacted from the registers with one block-wide
//     exclusive scan of the per-thread counts (the four chunks' counts
//     packed into two 32-bit words, 16 bits each);
//   - over the staged valid entries s[0, n), ascending, a table of K + 1
//     offsets (K <= min(Db, kMaxTable)) marks where each bucket of 2^shift
//     ids starts: table[k] = first i with s[i] >= s[0] + k * 2^shift. An
//     `a` entry v then needs table[k], table[k + 1] for its bucket and a
//     search of the one or two entries between them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;         // chunks per thread per round
constexpr int kMaxTable = 4096;    // buckets at most
constexpr int kMaxDb = 48 * 1024;  // staged b + table within shared memory

// first index in [lo, hi) of the ascending s whose entry is >= v
__device__ __forceinline__ int lower_bound(const int* s, int lo, int hi,
                                           int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// chunk g (VEC ints at g * VEC) of a row of `len` ints; past the end it
// reads as holes. VEC == 4 needs len % 4 == 0 and a 16-byte aligned row.
template <int VEC>
__device__ __forceinline__ void load_chunk(const int* __restrict__ row,
                                           int len, int g, int sentinel,
                                           int (&x)[VEC]) {
  const int p = g * VEC;
  if constexpr (VEC == 4) {
    if (p < len) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(row) + g);
      x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = sentinel;
    }
  } else {
    x[0] = p < len ? __ldg(row + p) : sentinel;
  }
}

// five blocks a SM (at most 51 registers a thread): the lookups are
// latency-bound, and with the four blocks that 64 registers allow they
// leave the card well short of its memory rate
template <int VEC>
__global__ void __launch_bounds__(kThreads, 5)
sorted_intersect_kernel(const int* __restrict__ a, const int* __restrict__ b,
                        int* __restrict__ out, int Da, int Db, int cap,
                        int sentinel) {
  constexpr int kRound = kThreads * kChunks * VEC;   // ints per round
  // staged[0, Db): b's valid entries; table[0, cap]: bucket starts
  extern __shared__ __align__(16) int staged[];
  int* table = staged + ((Db + 3) & ~3);
  __shared__ uint32_t warp_total[kWarps][2];
  const size_t row = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int* brow = b + row * Db;
  const int* arow = a + row * Da;
  int* orow = out + row * Da;

  int av[kChunks][VEC], bv[kChunks][VEC];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    load_chunk<VEC>(arow, Da, c * kThreads + t, sentinel, av[c]);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    load_chunk<VEC>(brow, Db, c * kThreads + t, sentinel, bv[c]);

  int count = 0;                           // same value in every thread
  for (int r0 = 0; r0 < Db; r0 += kRound) {
    const int len = min(kRound, Db - r0);
    if (r0 > 0) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        load_chunk<VEC>(brow + r0, len, c * kThreads + t, sentinel, bv[c]);
    }
    // stage the round as it is at [count, count + len)
    int* dst = staged + count;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int p = (c * kThreads + t) * VEC;
      if (p >= len) continue;
      if (VEC == 4 && count % 4 == 0) {
        *reinterpret_cast<int4*>(dst + p) =
            make_int4(bv[c][0], bv[c][1 % VEC], bv[c][2 % VEC],
                      bv[c][3 % VEC]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[p + e] = bv[c][e];
      }
    }
    __syncthreads();
    bool ok = true;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int p = (c * kThreads + t) * VEC;
      if (p >= len) continue;
#pragma unroll
      for (int e = 0; e + 1 < VEC; ++e) ok &= bv[c][e] <= bv[c][e + 1];
      if (p + VEC < len) ok &= bv[c][VEC - 1] <= dst[p + VEC];
    }
    if (__syncthreads_and(ok)) {
      // holes only in the round's tail: keep its valid prefix as staged
      count += lower_bound(dst, 0, len, sentinel);
    } else {
      // compact: exclusive scan of the chunks' counts in position order
      // (chunk c of thread t sits before chunk c of thread t + 1 and after
      // every chunk c - 1)
      int cnt[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        cnt[c] = 0;
#pragma unroll
        for (int e = 0; e < VEC; ++e) cnt[c] += bv[c][e] != sentinel;
      }
      const uint32_t own0 = cnt[0] | (cnt[1] << 16);
      const uint32_t own1 = cnt[2] | (cnt[3] << 16);
      uint32_t inc0 = own0, inc1 = own1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y0 = __shfl_up_sync(0xffffffffu, inc0, off);
        const uint32_t y1 = __shfl_up_sync(0xffffffffu, inc1, off);
        if (lane >= off) {
          inc0 += y0;
          inc1 += y1;
        }
      }
      if (lane == 31) {
        warp_total[warp][0] = inc0;
        warp_total[warp][1] = inc1;
      }
      __syncthreads();
      uint32_t ex0 = inc0 - own0, ex1 = inc1 - own1, tot0 = 0, tot1 = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t w0 = warp_total[w][0], w1 = warp_total[w][1];
        if (w < warp) {
          ex0 += w0;
          ex1 += w1;
        }
        tot0 += w0;
        tot1 += w1;
      }
      const int total[kChunks] = {
          static_cast<int>(tot0 & 0xffffu), static_cast<int>(tot0 >> 16),
          static_cast<int>(tot1 & 0xffffu), static_cast<int>(tot1 >> 16)};
      const int excl[kChunks] = {
          static_cast<int>(ex0 & 0xffffu), static_cast<int>(ex0 >> 16),
          static_cast<int>(ex1 & 0xffffu), static_cast<int>(ex1 >> 16)};
      // the raw round is in registers: overwrite it in place
      int before = count;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        int o = before + excl[c];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (bv[c][e] != sentinel) staged[o++] = bv[c][e];
        before += total[c];
      }
      count = before;
    }
    __syncthreads();      // staged and warp_total complete for every thread
  }

  // bucket table over staged[0, n): bucket k holds ids lo + [k, k+1) << sh
  const int n = count;
  const int lo = n > 0 ? staged[0] : 0;
  const int hi = n > 0 ? staged[n - 1] : -1;
  int sh = 0;
  if (n > 0) {
    const unsigned span = static_cast<unsigned>(hi - lo);
    while ((span >> sh) >= static_cast<unsigned>(cap)) ++sh;
    for (int i = t; i < n; i += kThreads) {
      const int kb = (staged[i] - lo) >> sh;
      const int kp = i == 0 ? -1 : (staged[i - 1] - lo) >> sh;
      for (int k = kp + 1; k <= kb; ++k) table[k] = i;
    }
    if (t == 0) table[((hi - lo) >> sh) + 1] = n;
  }
  __syncthreads();

  for (int r0 = 0; r0 < Da; r0 += kRound) {
    const int len = min(kRound, Da - r0);
    if (r0 > 0) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        load_chunk<VEC>(arow + r0, len, c * kThreads + t, sentinel, av[c]);
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int p = (c * kThreads + t) * VEC;
      if (p >= len) continue;
      int res[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int v = av[c][e];
        res[e] = sentinel;
        if (v == sentinel || v < lo || v > hi) continue;
        const int k = (v - lo) >> sh;
        const int from = table[k], to = table[k + 1];
        const int j = lower_bound(staged, from, to, v);
        if (j < to && staged[j] == v) res[e] = v;
      }
      if constexpr (VEC == 4) {
        reinterpret_cast<int4*>(orow + r0)[p / 4] =
            make_int4(res[0], res[1], res[2], res[3]);
      } else {
        orow[r0 + p] = res[0];
      }
    }
  }
}

template <int VEC>
cudaError_t launch(const int* a, const int* b, int* out, int B, int Da,
                   int Db, int sentinel, cudaStream_t stream) {
  const int cap = Db < kMaxTable ? (Db > 0 ? Db : 1) : kMaxTable;
  const size_t smem =
      static_cast<size_t>(((Db + 3) & ~3) + cap + 1) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sorted_intersect_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sorted_intersect_kernel<VEC><<<B, kThreads, smem, stream>>>(
      a, b, out, Da, Db, cap, sentinel);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` of `device` and returns the launch's cudaError_t
// (0 on success). Does not synchronise. Needs Db <= kMaxDb.
extern "C" int sorted_intersect_launch(const void* a, const void* b,
                                       void* out, int B, int Da, int Db,
                                       int sentinel, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Da == 0) return cudaSuccess;
  if (Db < 0 || Db > kMaxDb) return cudaErrorInvalidValue;
  const int* ai = static_cast<const int*>(a);
  const int* bi = static_cast<const int*>(b);
  int* oi = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = Da % 4 == 0 && Db % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) return launch<4>(ai, bi, oi, B, Da, Db, sentinel, s);
  return launch<1>(ai, bi, oi, B, Da, Db, sentinel, s);
}
