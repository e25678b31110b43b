// Fused DBQ gather + padded-set intersection on Hopper (sm_90a):
// out[i] = cand[i] ∩ adj[clip(ids[i], 0, sentinel)], without ever writing
// the gathered [B, D] row block to device memory.
//
// Replaces the Pallas TPU kernel `gather_intersect_pallas`
// (src/repro/kernels/gather_intersect.py, body `_gather_intersect_kernel`),
// which addresses the adjacency row through a scalar-prefetch index map
// (TPU only) and probes it with an O(Dc * D) broadcast compare.
//
// Semantics (bit-equal to gather-then-intersect with
// repro_torch/kernels/ref.py sorted_intersect): out[i, j] = cand[i, j] if
// cand[i, j] != sentinel and it occurs in adj[r], r = clip(ids[i], 0, N),
// else sentinel. A sentinel (or larger) id addresses row N, which is all
// holes, so its output row is all sentinel.
//
// Precondition: `cand` rows are valid padded sets (holes = sentinel
// anywhere, the other entries ascending strictly); `adj` is [N+1, D] with
// N = sentinel, each row ascending with holes only in its tail (fresh
// adjacency rows: the whole row is then non-decreasing, because every
// valid id is below the sentinel) and row N all holes. Ids may be any
// int32; they are clipped to [0, N] here, as the plain gather clips them.
//
// Bound on this card: memory. A launch must read B*Dc*4 bytes of cand and
// B*4 of ids, write B*Dc*4 bytes, and read D*4 bytes of adjacency for each
// row with a valid id. The gathered block, B*D*4 bytes written and read
// again by the unfused path, never exists.
//
// Design: one block per frontier row. It reads ids[i] first; a sentinel id
// writes the all-sentinel row and stops. Otherwise the block stages
// adj[r] in shared memory (D ints: 15.9 KB at D = 3968) with coalesced
// loads, and each thread binary-searches its cand lanes in the staged row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// true iff v occurs in the non-decreasing s[0, n)
__device__ __forceinline__ bool contains(const int* s, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < n && s[lo] == v;
}

__global__ void __launch_bounds__(kThreads)
gather_intersect_kernel(const int* __restrict__ ids,
                        const int* __restrict__ cand,
                        const int* __restrict__ adj, int* __restrict__ out,
                        int Dc, int D, int sentinel) {
  extern __shared__ int staged[];          // adj[r]
  const size_t row = blockIdx.x;
  int r = ids[row];
  r = r < 0 ? 0 : (r > sentinel ? sentinel : r);
  int* orow = out + row * Dc;
  if (r == sentinel) {                     // row N: no member survives
    for (int j = threadIdx.x; j < Dc; j += kThreads) orow[j] = sentinel;
    return;
  }
  const int* arow = adj + static_cast<size_t>(r) * D;
  for (int j = threadIdx.x; j < D; j += kThreads) staged[j] = arow[j];
  __syncthreads();
  const int* crow = cand + row * Dc;
  for (int j = threadIdx.x; j < Dc; j += kThreads) {
    const int v = crow[j];
    orow[j] = (v != sentinel && contains(staged, D, v)) ? v : sentinel;
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` of `device` and returns the launch's cudaError_t
// (0 on success). Does not synchronise.
extern "C" int gather_intersect_launch(const void* ids, const void* cand,
                                       const void* adj, void* out, int B,
                                       int Dc, int D, int sentinel,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Dc == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(D) * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gather_intersect_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gather_intersect_kernel<<<B, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const int*>(cand),
      static_cast<const int*>(adj), static_cast<int*>(out), Dc, D, sentinel);
  return cudaGetLastError();
}
