// K5 / K7: merge pass over sorted int64 runs, with an optional int64
// payload channel; K6: the merge of two runs fused with a dense
// dedup-compact, in one pass.
//
// Replaces the Pallas kernels
//   K5 zotpu/kernels/sort_pallas.py tree_merge_pass_alt (:910) and
//      tree_merge_pair_alt (:928), via _call_alt_pass (:885, pallas_call
//      :900);
//   K7 sort_pallas.py stream_merge_pass_pallas (:278, pallas_call :330) and
//      stream_merge_pair_pallas (:400, pallas_call :438), as used by
//      zotpu/dist/shuffle.py merge_received_runs_tag (a row-id payload);
//   K6 zotpu/kernels/dedup_pallas.py merged_dedup_compact_pass (:430) and
//      merged_dedup_compact_pair (:444), via _call_merged_dedup (:357,
//      pallas_call :383).
//
// Layout: the input is a sequence of pairs of pair_len elements; in each
// pair A = [0, a_len) and B = [a_len, pair_len) are ascending runs. A pass
// over runs of length r is pair_len = 2r, a_len = r; one unequal pair is
// pair_len = n, a_len = nA. Every run is ascending: the TPU tree stored odd
// runs descending so that [asc | desc] was bitonic for its sorting network,
// which a merge path does not need. A comes first on equal keys (stable).
// Sentinel (INT64_MAX) pads merge as keys and land at the end of each
// merged run.
//
// Bound: memory bandwidth. K5 and K7 read every element once and write it
// once and move nothing else but one split per tile. K6 reads the valid
// keys once and writes one key and one count per unique key: the merged
// array never exists, and the sentinel capacity is not touched. On the
// H100 the merge kernels of K5 and K7 alone run at 0.85-0.90 of that
// bound at 3.35 TB/s and K6's fused kernel at about 0.5; the partition
// kernel before each adds 11-13 us of scattered probes, which is what
// keeps K5 and K7 at 0.65-0.72 of the bound and K6 near 0.3.
//
// Design, after the set-op kernel (merge.cu). A small partition kernel
// finds the merge-path split of every tile boundary of every pair, a
// group of 8 lanes a boundary, all in parallel. A tile is TILE = 256
// threads x 8 output diagonals of one pair (tiles never span pairs, so any
// run length works). The block stages the tile's contiguous A and B slices
// in shared memory with asynchronous copies; every thread finds the split
// of its own 8 diagonals by one search in shared memory and merges its
// items serially in registers, A first on ties.
//
// K5 / K7 (merge_runs_kernel<PAY>): a merge writes exactly where it reads,
// tile t of a pair to [base + d0, base + d1), so there is no look-back and
// no order among tiles: a plain grid, one block a tile (on the H100 2-5%
// faster than persistent blocks at 4, 6 or 8 an SM, which hold fewer
// tiles in flight than the hardware's own scheduling). The payload is
// gathered from the staged slices by the staged index of each merged
// item. The merged items go back through shared memory (one pad slot every
// 8 elements keeps the threads' 8-item rows off each other's banks) and
// out coalesced. Where the staged slices are already in order (the last of
// A's slice <= the first of B's, or a slice is empty: sentinel tails, a
// run wholly below the other) the staged tile is the merged tile and goes
// straight out: such tiles move their bytes and do nothing else. Many
// pairs much shorter than a tile leave most of a block idle; the receive
// tree's runs are thousands of elements.
//
// K6 (merge_dedup_kernel): the partition kernel also finds both runs'
// valid lengths (a warp each, 32 probes a step) and cuts tiles over the
// valid merged elements only, so tile ids at or past them end the block.
// Blocks are persistent and take tile ids from an atomic counter. A merged
// element starts a segment if it differs from the merged element before
// it, which for a thread's first item is the larger of the two elements
// before its split (staged with the slices, one halo element before each).
// Both sides hold duplicates, so a segment may be any length and span any
// number of tiles. The starts are compacted in shared memory by a block
// scan; the tile's output offset comes from the decoupled look-back
// (common.cuh); unique keys and count[j] = start[j + 1] - start[j] go out
// dense and coalesced. The tile's last segment ends in a later tile: it is
// closed afterwards by K2's closing kernel (dedup.cu) from the tiles'
// first and last starts, since waiting forward on later tiles would
// deadlock a persistent grid. Slots at or past *n_out are not written.

#include <climits>

#include <cuda_pipeline_primitives.h>

#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

using zt::merge_path;
using zt::SENT;
using zt::u64;

constexpr int MR_THREADS = 256;
constexpr int MR_ITEMS = 8;
constexpr int MR_TILE = MR_THREADS * MR_ITEMS;
constexpr int MD_BLOCKS_PER_SM = 6;  // K6's persistent blocks
constexpr int MR_SEARCH_LANES = 8;   // lanes that share a boundary's search
// Shared-memory slots of a tile: the merged tile with one pad slot after
// every MR_ITEMS elements. The staged slices need less: MR_TILE elements,
// K6's two halo elements, and the MR_ITEMS + 1 slots past B's slice that
// a thread's merge may read (and ignore) once both slices are used up.
constexpr int MR_SLOTS = MR_TILE + MR_TILE / MR_ITEMS;
static_assert(MR_SLOTS >= MR_TILE + MR_ITEMS + 3, "staging fits");

inline long long mr_tiles(long long n) { return (n + MR_TILE - 1) / MR_TILE; }

__device__ __forceinline__ int padded(int i) { return i + i / MR_ITEMS; }

// The thread's MR_ITEMS merged elements from the split (ai, bi) of the
// staged slices Ak[0, la) and Bk[0, lb), A first on ties. src[j] is the
// staged index of element j counted over A's slice then B's. Elements
// past the end of both slices are unspecified.
__device__ __forceinline__ void serial_merge(const long long* Ak, int la,
                                             const long long* Bk, int lb,
                                             int ai, int bi,
                                             long long (&key)[MR_ITEMS],
                                             int (&src)[MR_ITEMS]) {
  long long xa = Ak[ai], xb = Bk[bi];
#pragma unroll
  for (int j = 0; j < MR_ITEMS; ++j) {
    const bool take_a = ai < la && (bi >= lb || xa <= xb);
    key[j] = take_a ? xa : xb;
    src[j] = take_a ? ai : la + bi;
    if (take_a) xa = Ak[++ai];
    else xb = Bk[++bi];
  }
}

// The first i in [lo, hi) at which a monotone predicate (true, then false)
// is false, or hi: found by a group of G neighbouring lanes of a warp with
// G probes a step. On the H100 a search of the runs in device memory is
// bound by the latency of its chain of dependent loads when a thread makes
// it alone (22 steps, 17 us a partition kernel), and by the number of
// scattered probes when a whole warp makes it (5 steps, but 19 us, the two
// widest-strided steps 6 us each). Between them, with 8 lanes, it took
// 12.8 us (4 lanes 14.5, 16 lanes 11.7-14.7, 2 lanes 25).
template <int G, typename Pred>
__device__ __forceinline__ long long group_partition_point(long long lo,
                                                           long long hi,
                                                           int lane,
                                                           Pred pred) {
  const int g = lane & (G - 1);
  const unsigned group =
      (G == 32 ? 0xffffffffu : (1u << G) - 1) << (lane & ~(G - 1));
  while (lo < hi) {  // the answer lies in [lo, hi]; uniform over the group
    // lane g probes the last element of the g-th chunk of [lo, hi)
    const long long step = (hi - lo + G - 1) / G;
    const long long idx = lo + (g + 1) * step - 1;
    const bool ok = idx < hi && pred(idx);
    // ok is monotone over the lanes: chunks 0..c-1 are true throughout
    const int c = __popc(__ballot_sync(group, ok));
    const long long last = lo + (c + 1) * step - 1;  // chunk c's probe
    lo += c * step;
    if (lo > hi) lo = hi;
    if (last < hi) hi = last;  // false there: the answer is at most `last`
  }
  return lo;
}

// zt::merge_path by a group of MR_SEARCH_LANES lanes: the number of A
// elements among the first d of merge(A[:na], B[:nb]), A first on ties.
__device__ __forceinline__ long long group_merge_path(const long long* A,
                                                      long long na,
                                                      const long long* B,
                                                      long long nb,
                                                      long long d, int lane) {
  return group_partition_point<MR_SEARCH_LANES>(
      d - nb > 0 ? d - nb : 0, d < na ? d : na, lane,
      [=](long long i) { return A[i] <= B[d - 1 - i]; });
}

// splits[pair * (tiles_per_pair + 1) + t] = the merge-path split of
// diagonal min(t * MR_TILE, pair_len) of the pair; a group of lanes a
// boundary.
__global__ void merge_runs_partition_kernel(const long long* __restrict__ keys,
                                            long long pair_len,
                                            long long a_len,
                                            long long tiles_per_pair,
                                            long long boundaries,
                                            long long* __restrict__ splits) {
  const long long thread =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = thread / MR_SEARCH_LANES;
  if (i >= boundaries) return;  // uniform over the group
  const long long pair = i / (tiles_per_pair + 1);
  const long long d = (i % (tiles_per_pair + 1)) * MR_TILE;
  const long long* A = keys + pair * pair_len;
  const long long a =
      group_merge_path(A, a_len, A + a_len, pair_len - a_len,
                       d < pair_len ? d : pair_len, threadIdx.x & 31);
  if (thread % MR_SEARCH_LANES == 0) splits[i] = a;
}

template <bool PAY>
__global__ void __launch_bounds__(MR_THREADS)
merge_runs_kernel(const long long* __restrict__ keys,
                  const long long* __restrict__ pay, long long pair_len,
                  long long a_len, long long tiles_per_pair,
                  const long long* __restrict__ splits,
                  long long* __restrict__ out_k,
                  long long* __restrict__ out_p) {
  // A's slice at [0, la), B's at [la, len); then the merged tile, padded
  __shared__ long long s_k[MR_SLOTS];
  __shared__ long long s_p[PAY ? MR_SLOTS : 1];
  const int tid = threadIdx.x;

  const long long pair = blockIdx.x / tiles_per_pair;
  const long long t = blockIdx.x % tiles_per_pair;
  const long long d0 = t * MR_TILE;
  const long long d1 = d0 + MR_TILE < pair_len ? d0 + MR_TILE : pair_len;
  const long long* sp = splits + pair * (tiles_per_pair + 1) + t;
  const long long a0 = sp[0], a1 = sp[1];
  const long long b0 = d0 - a0, b1 = d1 - a1;
  const int la = static_cast<int>(a1 - a0), lb = static_cast<int>(b1 - b0);
  const int len = la + lb;
  const long long base = pair * pair_len;
  const long long ga = base + a0, gb = base + a_len + b0;

  // 1. stage the slices
  for (int i = tid; i < la; i += MR_THREADS) {
    __pipeline_memcpy_async(&s_k[i], &keys[ga + i], 8);
    if (PAY) __pipeline_memcpy_async(&s_p[i], &pay[ga + i], 8);
  }
  for (int i = tid; i < lb; i += MR_THREADS) {
    __pipeline_memcpy_async(&s_k[la + i], &keys[gb + i], 8);
    if (PAY) __pipeline_memcpy_async(&s_p[la + i], &pay[gb + i], 8);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // already in order: the staged tile is the merged tile (uniform)
  const bool ordered = la == 0 || lb == 0 || s_k[la - 1] <= s_k[la];
  if (!ordered) {
    // 2. this thread's diagonals [dl, dl + MR_ITEMS) of the tile's merge
    const int dl = tid * MR_ITEMS < len ? tid * MR_ITEMS : len;
    const int m = len - dl < MR_ITEMS ? len - dl : MR_ITEMS;
    const int ai = merge_path<int>(s_k, la, s_k + la, lb, dl);
    long long key[MR_ITEMS], pv[MR_ITEMS];
    int src[MR_ITEMS];
    serial_merge(s_k, la, s_k + la, lb, ai, dl - ai, key, src);
    if (PAY) {
#pragma unroll
      for (int j = 0; j < MR_ITEMS; ++j) pv[j] = s_p[src[j]];
    }
    __syncthreads();  // every thread is done reading the staged slices
    // 3. the merged tile back into shared memory
#pragma unroll
    for (int j = 0; j < MR_ITEMS; ++j) {
      if (j < m) {
        s_k[padded(dl + j)] = key[j];
        if (PAY) s_p[padded(dl + j)] = pv[j];
      }
    }
    __syncthreads();
  }

  // 4. out in order, coalesced
  for (int i = tid; i < len; i += MR_THREADS) {
    const int s = ordered ? i : padded(i);
    out_k[base + d0 + i] = s_k[s];
    if (PAY) out_p[base + d0 + i] = s_p[s];
  }
}

// Scratch words of K6 for `tiles` tiles.
struct DedupScratch {
  long long* splits;     // [tiles + 1] merge-path split of each boundary
  u64* status;           // [tiles] look-back words
  long long* first_pos;  // [tiles] merged position of the tile's first start
  long long* last_pos;   // [tiles] of its last start
  u64* counter;          // the next tile id
  long long* n_valid1;   // 1 + the number of valid merged elements
  __host__ __device__ DedupScratch(long long* base, long long tiles)
      : splits(base),
        status(reinterpret_cast<u64*>(base + tiles + 1)),
        first_pos(base + 2 * tiles + 1),
        last_pos(base + 3 * tiles + 1),
        counter(reinterpret_cast<u64*>(base + 4 * tiles + 1)),
        n_valid1(base + 4 * tiles + 2) {}
};

// Finds the valid lengths of A = keys[0, a_len) and B = keys[a_len, n),
// the number of keys below the sentinel (every block for itself, a warp a
// run), then the merge-path split of every tile boundary over the valid
// elements, a group of lanes a boundary, and clears the look-back state.
__global__ void __launch_bounds__(MR_THREADS)
merge_dedup_partition_kernel(const long long* __restrict__ keys, long long n,
                             long long a_len, long long tiles,
                             long long* scratch, long long* n_out) {
  __shared__ long long s_valid[2];
  const DedupScratch sc(scratch, tiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const long long* p = warp ? keys + a_len : keys;
    const long long v = group_partition_point<32>(
        0, warp ? n - a_len : a_len, lane,
        [=](long long i) { return p[i] != SENT; });
    if (lane == 0) s_valid[warp] = v;
  }
  __syncthreads();
  const long long va = s_valid[0], vb = s_valid[1];
  const long long N = va + vb;
  const long long thread =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (thread == 0) {
    *sc.counter = 0;
    *sc.n_valid1 = N + 1;
    if (N == 0) *n_out = 0;
  }
  const long long t = thread / MR_SEARCH_LANES;
  const bool writer = thread % MR_SEARCH_LANES == 0;
  if (t > tiles) return;  // uniform over the group, as the next return
  if (writer && t < tiles) {
    sc.status[t] = 0;
    sc.first_pos[t] = zt::NO_FIRST;
  }
  const long long d = t * MR_TILE;
  if (d >= N + MR_TILE) return;  // past the last boundary that is read
  const long long a =
      group_merge_path(keys, va, keys + a_len, vb, d < N ? d : N, lane);
  if (writer) sc.splits[t] = a;
}

__global__ void __launch_bounds__(MR_THREADS)
merge_dedup_kernel(const long long* __restrict__ keys, long long a_len,
                   long long tiles, long long* scratch,
                   long long* __restrict__ ukeys,
                   long long* __restrict__ counts,
                   long long* __restrict__ n_out) {
  typedef cub::BlockScan<int, MR_THREADS> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;
  // [0] the element before A's slice, [1, la] the slice; [la + 1] the
  // element before B's slice, then the slice. The same array then stages
  // the tile's unique keys.
  __shared__ long long s_k[MR_SLOTS];
  __shared__ int s_start[MR_TILE];
  __shared__ long long s_tile, s_excl;
  const DedupScratch sc(scratch, tiles);
  const int tid = threadIdx.x;
  const long long N = *sc.n_valid1 - 1;  // the valid merged elements
  const long long* A = keys;
  const long long* B = keys + a_len;

  while (true) {
    if (tid == 0) s_tile = static_cast<long long>(atomicAdd(sc.counter, 1ull));
    __syncthreads();
    const long long tile = s_tile;
    const long long d0 = tile * MR_TILE;
    if (d0 >= N) return;  // uniform: past the valid merged elements
    const long long d1 = d0 + MR_TILE < N ? d0 + MR_TILE : N;
    const long long a0 = sc.splits[tile], a1 = sc.splits[tile + 1];
    const long long b0 = d0 - a0, b1 = d1 - a1;
    const int la = static_cast<int>(a1 - a0), lb = static_cast<int>(b1 - b0);
    const int len = la + lb;

    // 1. stage the slices and the element before each
    for (int i = tid; i < la + 1; i += MR_THREADS) {
      const long long g = a0 - 1 + i;
      if (g >= 0) __pipeline_memcpy_async(&s_k[i], &A[g], 8);
    }
    for (int i = tid; i < lb + 1; i += MR_THREADS) {
      const long long g = b0 - 1 + i;
      if (g >= 0) __pipeline_memcpy_async(&s_k[la + 1 + i], &B[g], 8);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    const long long* Ak = s_k + 1;  // Ak[-1] is the element before the slice
    const long long* Bk = s_k + la + 2;

    // 2. this thread's diagonals [dl, dl + m) of the tile's merge
    const int dl = tid * MR_ITEMS < len ? tid * MR_ITEMS : len;
    const int m = len - dl < MR_ITEMS ? len - dl : MR_ITEMS;
    const int ai = merge_path<int>(Ak, la, Bk, lb, dl);
    const int bi = dl - ai;
    // the merged element before this thread's first
    const bool pa_ok = ai > 0 || a0 > 0, pb_ok = bi > 0 || b0 > 0;
    bool has_prev = pa_ok || pb_ok;
    long long prev = LLONG_MIN;
    if (pa_ok) prev = Ak[ai - 1];
    if (pb_ok && Bk[bi - 1] > prev) prev = Bk[bi - 1];
    long long key[MR_ITEMS];
    int src[MR_ITEMS];
    serial_merge(Ak, la, Bk, lb, ai, bi, key, src);

    // 3. segment starts (valid elements only, so none is the sentinel)
    bool first[MR_ITEMS];
    int kept = 0;
#pragma unroll
    for (int j = 0; j < MR_ITEMS; ++j) {
      first[j] = j < m && !(has_prev && prev == key[j]);
      kept += first[j];
      has_prev = true;
      prev = key[j];
    }
    __syncthreads();  // every thread is done reading the staged slices

    // 4. compaction in shared memory; the global offset by look-back
    int rank, total;
    Scan(scan_tmp).ExclusiveSum(kept, rank, total);
    if (tid < 32) {
      const long long excl = zt::lookback_publish(sc.status, tile, total, tid);
      if (tid == 0) {
        s_excl = excl;
        if (d1 == N) *n_out = excl + total;
      }
    }
#pragma unroll
    for (int j = 0; j < MR_ITEMS; ++j) {
      if (first[j]) {
        s_k[rank] = key[j];
        s_start[rank] = dl + j;
        ++rank;
      }
    }
    __syncthreads();

    // 5. the dense slice, coalesced; the last segment is closed later
    const long long excl = s_excl;
    for (int i = tid; i < total; i += MR_THREADS) {
      ukeys[excl + i] = s_k[i];
      if (i + 1 < total) counts[excl + i] = s_start[i + 1] - s_start[i];
    }
    if (tid == 0 && total > 0) {
      sc.first_pos[tile] = d0 + s_start[0];
      sc.last_pos[tile] = d0 + s_start[total - 1];
    }
    __syncthreads();  // before the next tile reuses shared memory
  }
}

}  // namespace

// int64 scratch elements zt_merge_runs needs for n keys in pairs of
// pair_len: a split per tile boundary of every pair.
extern "C" long long zt_merge_runs_scratch_elems(long long n,
                                                 long long pair_len) {
  return (n / pair_len) * (mr_tiles(pair_len) + 1);
}

// keys (and pay, or null): n > 0 int64, pairs of pair_len (n a multiple of
// it), each A = [0, a_len) then B ascending -> out_k (and out_p), each pair
// merged ascending, A first on ties.
extern "C" int zt_merge_runs(const void* keys_v, const void* pay_v,
                             long long n, long long pair_len, long long a_len,
                             void* out_k_v, void* out_p_v, void* scratch_v,
                             void* stream_v) {
  const long long* keys = static_cast<const long long*>(keys_v);
  const long long* pay = static_cast<const long long*>(pay_v);
  long long* out_k = static_cast<long long*>(out_k_v);
  long long* out_p = static_cast<long long*>(out_p_v);
  long long* splits = static_cast<long long*>(scratch_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const long long tiles_per_pair = mr_tiles(pair_len);
  const long long tiles = (n / pair_len) * tiles_per_pair;
  const long long boundaries = zt_merge_runs_scratch_elems(n, pair_len);
  if (tiles > 0x7FFFFFFFLL)  // the partition kernel's blocks are fewer
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned grid = static_cast<unsigned>(tiles);

  const long long lanes = boundaries * MR_SEARCH_LANES;
  merge_runs_partition_kernel<<<static_cast<unsigned>((lanes + 255) / 256),
                                256, 0, stream>>>(
      keys, pair_len, a_len, tiles_per_pair, boundaries, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pay != nullptr)
    merge_runs_kernel<true><<<grid, MR_THREADS, 0, stream>>>(
        keys, pay, pair_len, a_len, tiles_per_pair, splits, out_k, out_p);
  else
    merge_runs_kernel<false><<<grid, MR_THREADS, 0, stream>>>(
        keys, nullptr, pair_len, a_len, tiles_per_pair, splits, out_k,
        nullptr);
  return static_cast<int>(cudaGetLastError());
}

// int64 scratch elements zt_merge_dedup needs for n keys: per tile a split,
// a status word and the first and last start; the tile counter and the
// valid length.
extern "C" long long zt_merge_dedup_scratch_elems(long long n) {
  return 4 * mr_tiles(n) + 3;
}

// keys: n > 0 int64, A = [0, a_len) and B = [a_len, n) ascending runs with
// INT64_MAX pads (B may be empty) -> ukeys/counts (n each; written in
// [0, *n_out) only): the dense unique keys of their merge with occurrence
// counts, and *n_out.
extern "C" int zt_merge_dedup(const void* keys_v, long long n, long long a_len,
                              void* ukeys, void* counts_v, void* n_out,
                              void* scratch_v, void* stream_v) {
  const long long* keys = static_cast<const long long*>(keys_v);
  long long* counts = static_cast<long long*>(counts_v);
  long long* scratch = static_cast<long long*>(scratch_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const long long tiles = mr_tiles(n);
  unsigned grid = 0;
  cudaError_t err = zt::persistent_grid(tiles, MD_BLOCKS_PER_SM, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long lanes = (tiles + 1) * MR_SEARCH_LANES;
  merge_dedup_partition_kernel<<<
      static_cast<unsigned>((lanes + MR_THREADS - 1) / MR_THREADS), MR_THREADS,
      0, stream>>>(keys, n, a_len, tiles, scratch,
                   static_cast<long long*>(n_out));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_dedup_kernel<<<grid, MR_THREADS, 0, stream>>>(
      keys, a_len, tiles, scratch, static_cast<long long*>(ukeys), counts,
      static_cast<long long*>(n_out));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const DedupScratch sc(scratch, tiles);
  return static_cast<int>(zt::launch_dedup_close(
      n, tiles, MR_TILE, sc.status, sc.first_pos, sc.last_pos, sc.n_valid1,
      counts, stream));
}
