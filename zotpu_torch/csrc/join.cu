// K4: membership join of read windows against a sorted k-mer panel, summed
// per read row: row_hits[r] = #{ i : probes[r*m + i] is in the panel }.
//
// Replaces the Pallas kernel zotpu/kernels/sort_pallas.py
// stream_join_pair_pallas (def :636, pallas_call :676), reached through
// zotpu/kernels/join.py _join_pallas_star (:149), together with the stable
// probe sort before it (join.py :253-259) and the per-row sums after it
// (join.py _rowsum_from_hit_tags :76, _rowsum_by_idx :91).
//
// Bound: by its contract, the bytes of the probes and the panel. In
// practice the 32-byte sectors that the searches pull through L2: a window's
// key is unrelated to its neighbours', so every step of a search past the
// few levels that L1 keeps is a sector of its own. A plain binary search
// over a 2M-key panel takes about 11 such sectors a window, and the kernel
// then runs at L2's sector rate, far from the bytes' bound.
//
// A bucket directory cuts the search short. Before the probes run, a
// one-thread kernel reads the panel's valid length and largest key and
// chooses a bucket width (a shift of the key) that leaves about 4 to 8
// keys a bucket, at most 2^20 buckets; a second kernel fills dir[b] = the
// lower bound of bucket b's first key (a binary search a bucket, a tenth of
// the probes' number). A probe then reads dir[b] and dir[b + 1] (one
// sector) and searches only that bucket (one or two sectors). Keys that
// crowd into few buckets only lengthen those buckets' searches, down to
// the plain binary search in the worst case. The directory is rebuilt on
// every call, so the wrapper's contract stays a sorted panel and nothing
// else.
//
// Design: the TPU had no gather, so it merged the key*-transformed panel
// (key*2 + side) with the probes sorted by (key*, row), latched each
// segment's lead across a sequential grid, and packed hit tags into
// per-tile blocks with a dense fallback when a block overflowed. A GPU
// thread can gather. One warp takes one read row; each lane takes every
// 32nd window of it, skips the INT64_MAX sentinel, and runs a branchless
// lower-bound search over its key's bucket. One warp reduction sums the
// row and lane 0 writes it. No probe
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

constexpr int MAX_DIR_BITS = 20;
constexpr int KEYS_PER_BUCKET = 4;

// What the directory's kernels leave in scratch for the probes: four
// words, then dir[0 .. 2^bits].
struct Meta {
  long long n_valid;  // panel keys before the INT64_MAX pad
  long long max_key;  // the largest of them
  long long shift;    // bucket of key = key >> shift, capped at 2^bits - 1
  long long bits;
};

__host__ __device__ inline int ceil_log2(long long x) {  // x >= 1
  int b = 0;
  while ((1ll << b) < x) ++b;
  return b;
}

// First index of panel[lo, hi) whose key is >= key (hi if none): lower
// bound without branches.
__device__ __forceinline__ long long lower_bound(
    const long long* __restrict__ panel, long long lo, long long hi,
    long long key) {
  if (hi <= lo) return lo;
  const long long* base = panel + lo;
  long long len = hi - lo;
  while (len > 1) {
    const long long half = len >> 1;
    base = (__ldg(base + half) < key) ? base + half : base;
    len -= half;
  }
  return (base - panel) + (__ldg(base) < key);
}

__global__ void join_meta_kernel(const long long* __restrict__ panel,
                                 long long n, int max_bits, Meta* meta) {
  const long long nv = lower_bound(panel, 0, n, zt::SENT);
  const long long max_key = nv ? panel[nv - 1] : 0;
  int bits = nv / KEYS_PER_BUCKET >= 1 ? ceil_log2(nv / KEYS_PER_BUCKET) : 0;
  if (bits > max_bits) bits = max_bits;
  const int width = max_key > 0 ? 64 - __clzll(max_key) : 0;
  meta->n_valid = nv;
  meta->max_key = max_key;
  meta->shift = width > bits ? width - bits : 0;
  meta->bits = bits;
}

__global__ void join_dir_kernel(const long long* __restrict__ panel,
                                const Meta* __restrict__ meta,
                                int* __restrict__ dir) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long buckets = 1ll << meta->bits;
  if (t > buckets) return;
  dir[t] = static_cast<int>(
      t == buckets ? meta->n_valid
                   : lower_bound(panel, 0, meta->n_valid, t << meta->shift));
}

// Is key (>= 0) among the panel's valid keys?
__device__ __forceinline__ int in_panel(const long long* __restrict__ panel,
                                        const int* __restrict__ dir,
                                        long long max_key, int shift,
                                        long long last_bucket, long long key) {
  if (key > max_key || key < 0) return 0;
  long long b = key >> shift;
  if (b > last_bucket) b = last_bucket;
  const long long lo = __ldg(dir + b), hi = __ldg(dir + b + 1);
  const long long i = lower_bound(panel, lo, hi, key);
  return i < hi && __ldg(panel + i) == key;
}

__global__ void __launch_bounds__(JOIN_THREADS)
    join_row_hits_kernel(const long long* __restrict__ panel,
                         const Meta* __restrict__ meta,
                         const int* __restrict__ dir,
                         const long long* __restrict__ probes,
                         long long n_rows, int m, int* __restrict__ row_hits) {
  const long long row = static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK +
                        threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long max_key = meta->n_valid ? meta->max_key : -1;
  const int shift = static_cast<int>(meta->shift);
  const long long last_bucket = (1ll << meta->bits) - 1;
  const long long* w = probes + row * m;
  int hits = 0;
  for (int i = lane; i < m; i += 32) {
    const long long key = w[i];
    if (key != zt::SENT)
      hits += in_panel(panel, dir, max_key, shift, last_bucket, key);
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  if (lane == 0) row_hits[row] = hits;
}

__global__ void __launch_bounds__(JOIN_THREADS)
    join_tagged_kernel(const long long* __restrict__ panel,
                       const Meta* __restrict__ meta,
                       const int* __restrict__ dir,
                       const long long* __restrict__ probes,
                       const long long* __restrict__ tags, long long n,
                       long long n_rows, int* __restrict__ row_hits) {
  const long long max_key = meta->n_valid ? meta->max_key : -1;
  const int shift = static_cast<int>(meta->shift);
  const long long last_bucket = (1ll << meta->bits) - 1;
  const long long step = static_cast<long long>(gridDim.x) * JOIN_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * JOIN_THREADS +
                     threadIdx.x;
       i < n; i += step) {
    const long long key = probes[i];
    if (key == zt::SENT) continue;
    const long long tag = tags[i];
    if (tag >= 0 && tag < n_rows &&
        in_panel(panel, dir, max_key, shift, last_bucket, key))
      atomicAdd(row_hits + tag, 1);
  }
}

// The directory's bits for a panel of n slots: the most the meta kernel
// may choose.
int max_dir_bits(long long n) {
  const int b = n / KEYS_PER_BUCKET >= 1 ? ceil_log2(n / KEYS_PER_BUCKET) : 0;
  return b > MAX_DIR_BITS ? MAX_DIR_BITS : b;
}

// Fill scratch (zt_join_scratch_elems words) with the panel's Meta and
// directory.
cudaError_t build_directory(const long long* panel, long long n,
                            long long* scratch, cudaStream_t stream) {
  Meta* meta = reinterpret_cast<Meta*>(scratch);
  int* dir = reinterpret_cast<int*>(scratch + 4);
  const int bits = max_dir_bits(n);
  join_meta_kernel<<<1, 1, 0, stream>>>(panel, n, bits, meta);
  ZT_CHECK_LAUNCH();
  const long long threads = (1ll << bits) + 1;
  join_dir_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                    stream>>>(panel, meta, dir);
  return cudaGetLastError();
}

}  // namespace

// int64 scratch elements the join entry points need for a panel of n slots.
extern "C" long long zt_join_scratch_elems(long long n) {
  return 4 + ((1ll << max_dir_bits(n)) + 2) / 2;
}

extern "C" int zt_join_row_hits(const void* panel_v, long long n_panel,
                                const void* probes, long long n_rows,
                                int m_per_row, void* row_hits,
                                void* scratch_v, void* stream_v) {
  const long long* panel = static_cast<const long long*>(panel_v);
  long long* scratch = static_cast<long long*>(scratch_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  cudaError_t err = build_directory(panel, n_panel, scratch, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  join_row_hits_kernel<<<static_cast<unsigned>(blocks), JOIN_THREADS, 0,
                         stream>>>(
      panel, reinterpret_cast<const Meta*>(scratch),
      reinterpret_cast<const int*>(scratch + 4),
      static_cast<const long long*>(probes), n_rows, m_per_row,
      static_cast<int*>(row_hits));
  return static_cast<int>(cudaGetLastError());
}

// row_hits (n_rows int32) must hold zeros; it gains one per probe that is
// not INT64_MAX, has a tag in [0, n_rows) and is in panel[0, n_panel).
extern "C" int zt_join_row_hits_tagged(const void* panel_v, long long n_panel,
                                       const void* probes, const void* tags,
                                       long long n, long long n_rows,
                                       void* row_hits, void* scratch_v,
                                       void* stream_v) {
  const long long* panel = static_cast<const long long*>(panel_v);
  long long* scratch = static_cast<long long*>(scratch_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  cudaError_t err = build_directory(panel, n_panel, scratch, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + JOIN_THREADS - 1) / JOIN_THREADS;
  if (blocks > 1 << 20) blocks = 1 << 20;
  join_tagged_kernel<<<static_cast<unsigned>(blocks), JOIN_THREADS, 0,
                       stream>>>(
      panel, reinterpret_cast<const Meta*>(scratch),
      reinterpret_cast<const int*>(scratch + 4),
      static_cast<const long long*>(probes),
      static_cast<const long long*>(tags), n, n_rows,
      static_cast<int*>(row_hits));
  return static_cast<int>(cudaGetLastError());
}
