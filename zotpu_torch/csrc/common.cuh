// Definitions shared by the zotpu_torch CUDA kernels (pack.cu, dedup.cu,
// merge.cu, scan.cu, join.cu, merge_runs.cu). Keys are int64 packed
// canonical k-mers (< 2^62) with INT64_MAX as the padding sentinel, so it
// sorts last; counts are int64 holding u32 values that saturate at
// COUNT_MAX (zotpu/semantics.py).
#pragma once

#include <cuda_runtime.h>

namespace zt {

constexpr long long SENT = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long COUNT_MAX = 0xFFFFFFFFLL;

// Tiling of the compacting kernels (dedup, set-op): THREADS threads of a
// block own ITEMS consecutive elements each, TILE elements per block.
constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;

inline long long n_tiles(long long n) { return (n + TILE - 1) / TILE; }

// Exclusive scan of per-block counts (one block of 1024 threads walks the
// array in chunks): offsets[i] = counts[0] + ... + counts[i-1], *total =
// the sum of all. This is the cross-block step of every compaction: GPU
// blocks run in no order, so a block learns where its output starts only
// from the scan of every earlier block's count.
cudaError_t launch_scan_blocks(const long long* counts, long long* offsets,
                               long long n, long long* total,
                               cudaStream_t stream);

// K2's pipeline (dedup.cu) on n >= 1 sorted keys with an INT64_MAX tail:
// dense unique keys, segment counts and *n_unique; K6 (merge_runs.cu)
// runs it over its merged output. scratch holds dedup_scratch_elems(n).
long long dedup_scratch_elems(long long n);
cudaError_t launch_dedup_compact(const long long* keys, long long n,
                                 long long* ukeys, long long* counts,
                                 long long* n_unique, long long* scratch,
                                 cudaStream_t stream);

}  // namespace zt

#define ZT_CHECK_LAUNCH()                          \
  do {                                             \
    cudaError_t zt_err_ = cudaGetLastError();      \
    if (zt_err_ != cudaSuccess) return zt_err_;    \
  } while (0)
