// K5 / K7: merge pass over sorted int64 runs, with an optional int64
// payload channel; K6: the same merge followed by a dense dedup-compact.
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
//
// Bound: memory bandwidth. Each element is read once and written once (K6:
// written to scratch, then K2's pipeline reads it twice and writes the
// dense result), plus two merge-path binary searches per 1024-element tile.
//
// Design: the TPU kernel streamed each output tile through a bitonic
// network on windows found by a merge-path partition computed in XLA. On
// the GPU each block owns the output diagonals [d0, d0 + TILE) of one
// pair, finds both ends' merge-path splits by binary search (K3's
// merge_path, A first on ties), stages its A and B slices (and payload) in
// shared memory, places every element at its merged rank (its index plus
// a binary-search count in the other slice: keys strictly less for A,
// keys less or equal for B, so ties keep A first) and writes the tile back
// coalesced. Blocks never span pairs, so any run length works (no
// TILE_E-aligned capacities). Sentinel (INT64_MAX) pads merge as keys and
// land at the end of each merged run.
//
// K6 first version: merge into scratch, then K2's device pipeline (count
// segment firsts, scan of block totals, scatter, count = next start -
// start) over it in the same C entry point. Equal-key segments may be any
// length and span any number of blocks. With an empty B (nB = 0) the merge
// is the identity and is skipped. A one-pass fused K6 is later work.

#include "common.cuh"

namespace {

using zt::SENT;

constexpr int MR_THREADS = 256;
constexpr int MR_TILE = 1024;

// Number of A elements among the first d of merge(A[:na], B[:nb]), A first
// on ties: the largest a with A[a-1] <= B[d-a].
__device__ long long merge_path(const long long* A, long long na,
                                const long long* B, long long nb,
                                long long d) {
  long long lo = d - nb > 0 ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (A[mid] <= B[d - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_less(const long long* s, int n,
                                          long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_leq(const long long* s, int n,
                                         long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <bool PAY>
__global__ void __launch_bounds__(MR_THREADS)
    merge_runs_kernel(const long long* __restrict__ keys,
                      const long long* __restrict__ pay, long long pair_len,
                      long long a_len, long long tiles_per_pair,
                      long long* __restrict__ out_k,
                      long long* __restrict__ out_p) {
  __shared__ long long s_in_k[MR_TILE], s_k[MR_TILE];
  __shared__ long long s_in_p[PAY ? MR_TILE : 1], s_p[PAY ? MR_TILE : 1];
  __shared__ long long s_split[2];

  const long long pair = blockIdx.x / tiles_per_pair;
  const long long d0 = (blockIdx.x % tiles_per_pair) * MR_TILE;
  const long long d1 = d0 + MR_TILE < pair_len ? d0 + MR_TILE : pair_len;
  const long long base = pair * pair_len;
  const long long* A = keys + base;
  const long long* B = A + a_len;
  const long long b_len = pair_len - a_len;
  if (threadIdx.x < 2)
    s_split[threadIdx.x] =
        merge_path(A, a_len, B, b_len, threadIdx.x ? d1 : d0);
  __syncthreads();
  const long long a0 = s_split[0], a1 = s_split[1];
  const long long b0 = d0 - a0;
  const int la = static_cast<int>(a1 - a0);
  const int len = static_cast<int>(d1 - d0);

  for (int i = threadIdx.x; i < len; i += MR_THREADS) {
    const long long src = i < la ? base + a0 + i : base + a_len + b0 + i - la;
    s_in_k[i] = keys[src];
    if (PAY) s_in_p[i] = pay[src];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += MR_THREADS) {
    const long long key = s_in_k[i];
    const int r = i < la ? i + count_less(s_in_k + la, len - la, key)
                         : (i - la) + count_leq(s_in_k, la, key);
    s_k[r] = key;
    if (PAY) s_p[r] = s_in_p[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += MR_THREADS) {
    out_k[base + d0 + i] = s_k[i];
    if (PAY) out_p[base + d0 + i] = s_p[i];
  }
}

cudaError_t launch_merge(const long long* keys, const long long* pay,
                         long long n, long long pair_len, long long a_len,
                         long long* out_k, long long* out_p,
                         cudaStream_t stream) {
  const long long tiles_per_pair = (pair_len + MR_TILE - 1) / MR_TILE;
  const long long blocks = (n / pair_len) * tiles_per_pair;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (pay != nullptr)
    merge_runs_kernel<true><<<grid, MR_THREADS, 0, stream>>>(
        keys, pay, pair_len, a_len, tiles_per_pair, out_k, out_p);
  else
    merge_runs_kernel<false><<<grid, MR_THREADS, 0, stream>>>(
        keys, nullptr, pair_len, a_len, tiles_per_pair, out_k, nullptr);
  return cudaGetLastError();
}

}  // namespace

// keys (and pay, or null): n > 0 int64, pairs of pair_len (n a multiple of
// it), each A = [0, a_len) then B ascending -> out_k (and out_p), each pair
// merged ascending, A first on ties.
extern "C" int zt_merge_runs(const void* keys, const void* pay, long long n,
                             long long pair_len, long long a_len, void* out_k,
                             void* out_p, void* stream) {
  return static_cast<int>(launch_merge(
      static_cast<const long long*>(keys), static_cast<const long long*>(pay),
      n, pair_len, a_len, static_cast<long long*>(out_k),
      static_cast<long long*>(out_p), static_cast<cudaStream_t>(stream)));
}

// int64 scratch elements zt_merge_dedup needs for n keys.
extern "C" long long zt_merge_dedup_scratch_elems(long long n) {
  return n + zt::dedup_scratch_elems(n);
}

// keys: n > 0 int64, A = [0, a_len) and B = [a_len, n) ascending runs with
// INT64_MAX pads -> ukeys/counts (n each): the dense unique keys of their
// merge with occurrence counts, INT64_MAX / 0 beyond, and *n_out.
extern "C" int zt_merge_dedup(const void* keys_v, long long n, long long a_len,
                              void* ukeys, void* counts, void* n_out,
                              void* scratch_v, void* stream_v) {
  const long long* keys = static_cast<const long long*>(keys_v);
  long long* scratch = static_cast<long long*>(scratch_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const long long* merged = keys;
  if (a_len < n) {
    cudaError_t err =
        launch_merge(keys, nullptr, n, n, a_len, scratch, nullptr, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    merged = scratch;
  }
  return static_cast<int>(zt::launch_dedup_compact(
      merged, n, static_cast<long long*>(ukeys),
      static_cast<long long*>(counts), static_cast<long long*>(n_out),
      scratch + n, stream));
}
