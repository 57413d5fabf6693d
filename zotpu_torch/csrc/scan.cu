// Cross-block exclusive scan of block counts, used by the dedup-compact (K2)
// and fused set-op (K3) kernels to place each block's kept elements.
// Bound: launch latency; the array holds one value per 1024-element tile.

#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

constexpr int SCAN_THREADS = 1024;

// launch_bounds: without it the compiler takes 88 registers a thread, too
// many for a 1024-thread block.
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_blocks_kernel(const long long* counts, long long* offsets,
                       long long n, long long* total) {
  typedef cub::BlockScan<long long, SCAN_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < n; base += SCAN_THREADS) {
    const long long i = base + threadIdx.x;
    const long long v = i < n ? counts[i] : 0;
    long long ex, agg;
    Scan(tmp).ExclusiveSum(v, ex, agg);
    if (i < n) offsets[i] = carry + ex;
    __syncthreads();
    if (threadIdx.x == 0) carry += agg;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

}  // namespace

namespace zt {

cudaError_t launch_scan_blocks(const long long* counts, long long* offsets,
                               long long n, long long* total,
                               cudaStream_t stream) {
  scan_blocks_kernel<<<1, SCAN_THREADS, 0, stream>>>(counts, offsets, n,
                                                     total);
  return cudaGetLastError();
}

}  // namespace zt

extern "C" const char* zt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
