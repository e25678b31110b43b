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
// Precondition: `a` and `b` are valid padded sets. Entries equal to
// `sentinel` are holes and may sit anywhere in a row (INT results carry
// them in the middle); the other entries of a row ascend strictly. Widths
// Da and Db may differ. Rows that break this precondition get undefined
// (not out-of-bounds) results.
//
// Bound on this card: memory. A launch must read B*(Da+Db)*4 bytes and
// write B*Da*4 bytes; the binary searches run in shared memory.
//
// Design: one block per row. The block copies the valid entries of b's row
// into shared memory in order, compacted by a block-wide prefix sum (warp
// ballots plus one count per warp), so the staged row ascends even when
// b has holes in the middle. Each thread then binary-searches its `a`
// lanes (strided by the block size, so global loads and stores coalesce)
// in the staged row and writes `a` or the sentinel. Db ints of dynamic
// shared memory per block: 15.9 KB at D = 3968.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// true iff v occurs in the ascending s[0, n)
__device__ __forceinline__ bool contains(const int* s, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < n && s[lo] == v;
}

__global__ void __launch_bounds__(kThreads)
sorted_intersect_kernel(const int* __restrict__ a, const int* __restrict__ b,
                        int* __restrict__ out, int Da, int Db, int sentinel) {
  extern __shared__ int staged[];          // compacted valid entries of b
  __shared__ int warp_count[kWarps];
  const size_t row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* brow = b + row * Db;

  int count = 0;                           // same value in every thread
  for (int t0 = 0; t0 < Db; t0 += kThreads) {
    const int j = t0 + threadIdx.x;
    const int v = j < Db ? brow[j] : sentinel;
    const bool keep = v != sentinel;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = count, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      offset += w < warp ? c : 0;
      total += c;
    }
    if (keep) staged[offset + __popc(ballot & ((1u << lane) - 1u))] = v;
    count += total;
    __syncthreads();                       // warp_count is reused
  }

  const int* arow = a + row * Da;
  int* orow = out + row * Da;
  for (int j = threadIdx.x; j < Da; j += kThreads) {
    const int v = arow[j];
    orow[j] = (v != sentinel && contains(staged, count, v)) ? v : sentinel;
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` of `device` and returns the launch's cudaError_t
// (0 on success). Does not synchronise.
extern "C" int sorted_intersect_launch(const void* a, const void* b,
                                       void* out, int B, int Da, int Db,
                                       int sentinel, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Da == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(Db) * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sorted_intersect_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sorted_intersect_kernel<<<B, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<int*>(out), Da, Db, sentinel);
  return cudaGetLastError();
}
