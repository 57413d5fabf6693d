// Definitions shared by the zotpu_torch CUDA kernels (pack.cu, dedup.cu,
// merge.cu, join.cu, merge_runs.cu). Keys are int64 packed canonical k-mers
// (< 2^62) with INT64_MAX as the padding sentinel, so it sorts last; counts
// are int64 holding u32 values that saturate at COUNT_MAX
// (zotpu_torch/semantics.py).
#pragma once

#include <cuda_runtime.h>

namespace zt {

constexpr long long SENT = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long COUNT_MAX = 0xFFFFFFFFLL;

// Decoupled look-back: the cross-block step of the compacting kernels
// (dedup.cu, merge.cu). GPU blocks run in no order, so a tile learns where
// its output starts from one 64-bit status word per tile: the flag in the
// top two bits and a count below, written in one store. A tile first
// publishes its own kept count (AGGREGATE), then sums its predecessors'
// words backwards until it meets a PREFIX, then publishes its own PREFIX.
// Tile ids come from an atomic counter, so every predecessor is already
// running and the wait always ends. All words start at 0 (not ready).
typedef unsigned long long u64;
enum : u64 {
  ST_AGGREGATE = 1ull << 62,  // the tile's own kept count
  ST_PREFIX = 2ull << 62,     // kept count of tiles 0..this
  ST_VALUE = (1ull << 62) - 1
};

// Called by all 32 lanes of one warp with the tile's kept count: publishes
// it, waits for the predecessors, publishes the inclusive prefix, and
// returns the exclusive prefix (the kept count of tiles 0..tile-1).
__device__ __forceinline__ long long lookback_publish(u64* status,
                                                      long long tile,
                                                      long long total,
                                                      int lane) {
  volatile u64* st = status;
  if (lane == 0 && tile > 0) st[tile] = ST_AGGREGATE | static_cast<u64>(total);
  long long excl = 0;
  long long base = tile - 1;
  while (true) {
    const long long idx = base - lane;
    u64 s = ST_PREFIX;  // before tile 0: prefix 0
    do {
      if (idx >= 0) s = st[idx];
    } while (__any_sync(0xffffffffu, (s >> 62) == 0));
    const unsigned prefixed = __ballot_sync(0xffffffffu, (s & ST_PREFIX) != 0);
    long long v = static_cast<long long>(s & ST_VALUE);
    // sum the aggregates down to and including the nearest prefix
    if (prefixed && lane > __ffs(prefixed) - 1) v = 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (prefixed) break;
    base -= 32;
  }
  if (lane == 0) st[tile] = ST_PREFIX | static_cast<u64>(excl + total);
  return excl;
}

// Blocks a persistent kernel launches: enough to fill the card, never more
// than it has tiles.
inline cudaError_t persistent_grid(long long tiles, int blocks_per_sm,
                                   unsigned* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(sms) * blocks_per_sm;
  *grid = static_cast<unsigned>(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

// K2's pipeline (dedup.cu) on n >= 1 sorted keys with an INT64_MAX tail:
// dense unique keys and segment counts in [0, *n_unique), and *n_unique;
// K6 (merge_runs.cu) runs it over its merged output. scratch holds
// dedup_scratch_elems(n).
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
