// K2: dense dedup-compact of a sorted key array: sorted keys with
// duplicates and an INT64_MAX tail -> unique keys up front with their
// segment counts, INT64_MAX / 0 beyond, and n_unique. No sort.
//
// Replaces the Pallas kernel zotpu/kernels/dedup_pallas.py
// dedup_compact_pallas (def :243, pallas_call :287).
//
// Bound: memory bandwidth (the keys are read twice, 8 bytes each; keys,
// start positions and counts are written once).
//
// Design: the TPU kernel carries a running output cursor across a
// sequential grid. GPU blocks run in no order, so the cursor becomes a
// cross-block scan: (1) each block counts its segment FIRSTS (key differs
// from its predecessor and is not the sentinel), (2) one scan of the block
// counts gives every block its output offset and n_unique, (3) each block
// scatters its firsts' keys and positions in order, (4) count[j] =
// start[j+1] - start[j], with start[n_unique] = the number of non-sentinel
// keys; the same pass writes the sentinel tail.

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

using zt::ITEMS;
using zt::SENT;
using zt::THREADS;
using zt::TILE;

__device__ __forceinline__ bool seg_first(const long long* keys, long long i) {
  const long long k = keys[i];
  return k != SENT && (i == 0 || keys[i - 1] != k);
}

__global__ void dedup_count_kernel(const long long* keys, long long n,
                                   long long* block_counts,
                                   long long* n_valid) {
  typedef cub::BlockReduce<long long, THREADS> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const long long base =
      static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  long long cnt = 0;
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    const long long k = keys[i];
    cnt += seg_first(keys, i);
    // exactly one element writes the non-sentinel count: the last
    // non-sentinel key, or key 0 when every key is the sentinel
    if (k != SENT && (i + 1 == n || keys[i + 1] == SENT)) *n_valid = i + 1;
    if (i == 0 && k == SENT) *n_valid = 0;
  }
  const long long total = Reduce(tmp).Sum(cnt);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

__global__ void dedup_scatter_kernel(const long long* keys, long long n,
                                     const long long* offsets,
                                     long long* ukeys, long long* starts) {
  typedef cub::BlockScan<long long, THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const long long base =
      static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  bool first[ITEMS];
  long long cnt = 0;
  for (int j = 0; j < ITEMS; ++j) {
    first[j] = base + j < n && seg_first(keys, base + j);
    cnt += first[j];
  }
  long long ex;
  Scan(tmp).ExclusiveSum(cnt, ex);
  long long pos = offsets[blockIdx.x] + ex;
  for (int j = 0; j < ITEMS; ++j) {
    if (first[j]) {
      ukeys[pos] = keys[base + j];
      starts[pos] = base + j;
      ++pos;
    }
  }
}

__global__ void dedup_finish_kernel(long long cap, long long* ukeys,
                                    const long long* starts,
                                    long long* counts,
                                    const long long* n_unique,
                                    const long long* n_valid) {
  const long long nu = *n_unique, nv = *n_valid;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < cap; j += step) {
    if (j < nu) {
      const long long end = j + 1 < nu ? starts[j + 1] : nv;
      counts[j] = end - starts[j];
    } else {
      ukeys[j] = SENT;
      counts[j] = 0;
    }
  }
}

}  // namespace

namespace zt {

long long dedup_scratch_elems(long long n) { return 2 * n_tiles(n) + 1 + n; }

cudaError_t launch_dedup_compact(const long long* keys, long long n,
                                 long long* ukeys, long long* counts,
                                 long long* n_unique, long long* scratch,
                                 cudaStream_t stream) {
  const long long nb = n_tiles(n);
  long long* block_counts = scratch;
  long long* offsets = block_counts + nb;
  long long* n_valid = offsets + nb;
  long long* starts = n_valid + 1;

  dedup_count_kernel<<<static_cast<unsigned>(nb), THREADS, 0, stream>>>(
      keys, n, block_counts, n_valid);
  ZT_CHECK_LAUNCH();
  cudaError_t err = launch_scan_blocks(block_counts, offsets, nb, n_unique,
                                       stream);
  if (err != cudaSuccess) return err;
  dedup_scatter_kernel<<<static_cast<unsigned>(nb), THREADS, 0, stream>>>(
      keys, n, offsets, ukeys, starts);
  ZT_CHECK_LAUNCH();
  const long long fin_blocks = (n + THREADS - 1) / THREADS;
  dedup_finish_kernel<<<static_cast<unsigned>(
                            fin_blocks < 65536 ? fin_blocks : 65536),
                        THREADS, 0, stream>>>(n, ukeys, starts, counts,
                                              n_unique, n_valid);
  return cudaGetLastError();
}

}  // namespace zt

// int64 scratch elements zt_dedup_compact needs for n keys.
extern "C" long long zt_dedup_scratch_elems(long long n) {
  return zt::dedup_scratch_elems(n);
}

// keys: n >= 1 sorted int64 -> ukeys/counts (n each), *n_unique.
extern "C" int zt_dedup_compact(const void* keys_v, long long n, void* ukeys_v,
                                void* counts_v, void* n_unique_v,
                                void* scratch_v, void* stream_v) {
  return static_cast<int>(zt::launch_dedup_compact(
      static_cast<const long long*>(keys_v), n,
      static_cast<long long*>(ukeys_v), static_cast<long long*>(counts_v),
      static_cast<long long*>(n_unique_v), static_cast<long long*>(scratch_v),
      static_cast<cudaStream_t>(stream_v)));
}
