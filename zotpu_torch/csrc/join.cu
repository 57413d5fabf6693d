// K4: membership join of read windows against a sorted k-mer panel, summed
// per read row: row_hits[r] = #{ i : probes[r*m + i] is in the panel }.
//
// Replaces the Pallas kernel zotpu/kernels/sort_pallas.py
// stream_join_pair_pallas (def :636, pallas_call :676), reached through
// zotpu/kernels/join.py _join_pallas_star (:149), together with the stable
// probe sort before it (join.py :253-259) and the per-row sums after it
// (join.py _rowsum_from_hit_tags :76, _rowsum_by_idx :91).
//
// Bound: the dependent loads of one binary search per valid window,
// ceil(log2(capacity)) 8-byte reads each. A 2M-key panel is 16 MB, inside
// the 50 MB L2, and its upper levels are shared by every search, so the
// kernel waits on L1/L2 latency rather than on device-memory bandwidth;
// many warps in flight hide it.
//
// Design: the TPU had no gather, so it merged the key*-transformed panel
// (key*2 + side) with the probes sorted by (key*, row), latched each
// segment's lead across a sequential grid, and packed hit tags into
// per-tile blocks with a dense fallback when a block overflowed. A GPU
// thread can gather. One warp takes one read row; each lane takes every
// 32nd window of it, skips the INT64_MAX sentinel, and runs a branchless
// lower-bound search over the panel's full padded capacity (the sentinel
// pad sorts last and no valid window equals it, so no valid length is
// needed). One warp reduction sums the row and lane 0 writes it. No probe
// sort, no key transform, no capacity that can truncate; every window
// counts, repeats and both strands of one canonical key included.
//
// The tagged entry (zt_join_row_hits_tagged) serves the sharded pulldown
// (zotpu/dist/shuffle.py make_pulldown_step, which ran the same Pallas
// join through _join_pallas_star (:783) on a routed probe stream and
// summed rows with _rowsum_by_key, zotpu/kernels/join.py:108). A routed
// stream holds any population of rows, so each probe carries its row id:
// one thread a probe, the same lower-bound search, then an atomic add
// into hits[tag]. Sentinel probes (bucket padding) and tags outside
// [0, n_rows) never count. Routed probes arrive key-sorted, so
// neighbouring threads search neighbouring keys and their tags scatter,
// which keeps the atomics apart.

#include "common.cuh"

namespace {

constexpr int JOIN_THREADS = 256;
constexpr int ROWS_PER_BLOCK = JOIN_THREADS / 32;

// Is key in panel[0, n)? Lower bound without branches (the loop runs
// ceil(log2(n)) times for every key), then one equality test.
__device__ __forceinline__ int in_panel(const long long* __restrict__ panel,
                                        long long n, long long key) {
  if (n == 0) return 0;
  const long long* base = panel;
  long long len = n;
  while (len > 1) {
    const long long half = len >> 1;
    base = (__ldg(base + half) < key) ? base + half : base;
    len -= half;
  }
  const long long i = (base - panel) + (__ldg(base) < key);
  return i < n && __ldg(panel + i) == key;
}

__global__ void __launch_bounds__(JOIN_THREADS)
    join_row_hits_kernel(const long long* __restrict__ panel,
                         long long n_panel,
                         const long long* __restrict__ probes,
                         long long n_rows, int m, int* __restrict__ row_hits) {
  const long long row = static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK +
                        threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long* w = probes + row * m;
  int hits = 0;
  for (int i = lane; i < m; i += 32) {
    const long long key = w[i];
    if (key != zt::SENT) hits += in_panel(panel, n_panel, key);
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  if (lane == 0) row_hits[row] = hits;
}

__global__ void __launch_bounds__(JOIN_THREADS)
    join_tagged_kernel(const long long* __restrict__ panel, long long n_panel,
                       const long long* __restrict__ probes,
                       const long long* __restrict__ tags, long long n,
                       long long n_rows, int* __restrict__ row_hits) {
  const long long step = static_cast<long long>(gridDim.x) * JOIN_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * JOIN_THREADS +
                     threadIdx.x;
       i < n; i += step) {
    const long long key = probes[i];
    if (key == zt::SENT) continue;
    const long long tag = tags[i];
    if (tag >= 0 && tag < n_rows && in_panel(panel, n_panel, key))
      atomicAdd(row_hits + tag, 1);
  }
}

}  // namespace

extern "C" int zt_join_row_hits(const void* panel, long long n_panel,
                                const void* probes, long long n_rows,
                                int m_per_row, void* row_hits, void* stream) {
  const long long blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  join_row_hits_kernel<<<static_cast<unsigned>(blocks), JOIN_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(panel), n_panel,
      static_cast<const long long*>(probes), n_rows, m_per_row,
      static_cast<int*>(row_hits));
  return static_cast<int>(cudaGetLastError());
}

// row_hits (n_rows int32) must hold zeros; it gains one per probe that is
// not INT64_MAX, has a tag in [0, n_rows) and is in panel[0, n_panel).
extern "C" int zt_join_row_hits_tagged(const void* panel, long long n_panel,
                                       const void* probes, const void* tags,
                                       long long n, long long n_rows,
                                       void* row_hits, void* stream) {
  long long blocks = (n + JOIN_THREADS - 1) / JOIN_THREADS;
  if (blocks > 1 << 20) blocks = 1 << 20;
  join_tagged_kernel<<<static_cast<unsigned>(blocks), JOIN_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(panel), n_panel,
      static_cast<const long long*>(probes),
      static_cast<const long long*>(tags), n, n_rows,
      static_cast<int*>(row_hits));
  return static_cast<int>(cudaGetLastError());
}
