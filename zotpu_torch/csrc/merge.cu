// K3: fused sorted set operation: two dense sorted unique (key, count)
// sets -> merge -> combine (merge/union, intersect, diff) -> dense output
// and n_out, in one pass with the op as a template parameter.
//
// Replaces the Pallas kernel zotpu/kernels/merge_fused.py set_op_fused
// (def :510, pallas_call :609); combine rules from _combine_policy (:160).
//
// Bound: memory bandwidth. The contract moves 16 bytes per valid input
// element in and 16 bytes per output element out, and this kernel moves
// no more: each input element is read from device memory once, each output
// element is written once, and there is no intermediate array.
//
// Design. A small partition kernel finds the merge-path split of every
// tile boundary (a binary search in device memory per boundary, all in
// parallel) and clears the look-back state. The set-op kernel is
// persistent: a block takes tile ids from an atomic counter until the ids
// run past the n_a + n_b merged elements, so capacity beyond the valid
// prefixes costs nothing. For a tile of TILE output diagonals the block
//   1. stages its contiguous A and B slices (keys and counts, plus the one
//      element before and after each slice) in shared memory with
//      asynchronous copies;
//   2. gives every thread ITEMS diagonals: the thread finds its own split
//      by a binary search in shared memory and merges its items serially
//      in registers (A first on equal keys), one step further than it owns,
//      so that it also sees the element after its last;
//   3. applies the combine rule. Inputs are unique per side, so a key
//      segment has at most two members; the element before a thread's
//      first item and the one after its last come from the staged slices
//      and their halo elements, which replaces the TPU kernel's deferred
//      element carried between grid steps;
//   4. compacts the kept items in shared memory by a block scan, and gets
//      the tile's global output offset by a decoupled look-back over one
//      64-bit status word per tile (flag and running count in one store).
//      Tile ids come from the atomic counter, so a tile only ever waits on
//      tiles that are already running;
//   5. writes its dense output slice coalesced; the tile that ends at
//      n_a + n_b writes n_out.
// Slots at or past n_out are written only on request (the wrapper asks
// when a valid count is absent): each tile then fills as many slots as it
// dropped, counted down from n_a + n_b, so the tiles' ranges tile
// [n_out, n_a + n_b) exactly, and the tile ids past n_a + n_b fill the
// rest of the capacity. n_a and n_b are read on the device, so there is no
// host sync.

#include <climits>

#include <cuda_pipeline_primitives.h>

#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

using zt::COUNT_MAX;
using zt::SENT;

enum { OP_MERGE = 0, OP_INTERSECT = 1, OP_DIFF = 2 };

constexpr int K3_THREADS = 256;
constexpr int K3_ITEMS = 8;
constexpr int K3_TILE = K3_THREADS * K3_ITEMS;
constexpr int K3_BLOCKS_PER_SM = 4;  // registers allow 3; a spare costs nothing

using zt::u64;

inline long long k3_tiles(long long n) { return (n + K3_TILE - 1) / K3_TILE; }

__device__ __forceinline__ long long valid_len(const long long* p,
                                               long long cap) {
  if (p == nullptr) return cap;
  const long long v = *p;
  return v < 0 ? 0 : (v > cap ? cap : v);
}

// Number of A elements among the first d of merge(A[:na], B[:nb]), A first
// on ties: the largest a with A[a-1] <= B[d-a].
template <typename Int>
__device__ __forceinline__ Int merge_path(const long long* A, Int na,
                                          const long long* B, Int nb, Int d) {
  Int lo = d - nb > 0 ? d - nb : 0;
  Int hi = d < na ? d : na;
  while (lo < hi) {
    const Int mid = (lo + hi) >> 1;
    if (A[mid] <= B[d - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long sat_add(long long a, long long b) {
  const long long s = a + b;
  return s > COUNT_MAX ? COUNT_MAX : s;
}

// Combine rule for a segment's FIRST element (merge_fused._combine_policy).
// For diff the B counts arrive zeroed, so presence in A is c > 0.
template <int OP>
__device__ __forceinline__ void combine(bool first, bool same_next, bool valid,
                                        long long c, long long nc, bool* keep,
                                        long long* cnt) {
  if (OP == OP_MERGE) {
    *keep = first && valid;
    *cnt = sat_add(c, same_next ? nc : 0);
  } else if (OP == OP_INTERSECT) {
    *keep = first && valid && same_next;
    *cnt = sat_add(c, same_next ? nc : 0);
  } else {
    *keep = first && valid && !same_next && c > 0;
    *cnt = c;
  }
}

// splits[t] = merge-path split of diagonal min(t * TILE, N) for every tile
// boundary the set-op kernel reads; clears the tiles' status words and the
// tile counter; writes n_out = 0 when there is nothing to merge.
__global__ void setop_partition_kernel(const long long* ka, long long MA,
                                       const long long* na_p,
                                       const long long* kb, long long MB,
                                       const long long* nb_p,
                                       long long tiles_cap, long long* splits,
                                       u64* status, u64* counter,
                                       long long* n_out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long na = valid_len(na_p, MA), nb = valid_len(nb_p, MB);
  const long long N = na + nb;
  if (t == 0) {
    *counter = 0;
    if (N == 0) *n_out = 0;
  }
  if (t > tiles_cap) return;
  const long long d = t * K3_TILE;
  if (d >= N + K3_TILE) return;  // past the last boundary that is read
  if (t < tiles_cap && d < N) status[t] = 0;
  splits[t] = merge_path<long long>(ka, na, kb, nb, d < N ? d : N);
}

__device__ __forceinline__ void fill_tail(long long* out_k, long long* out_c,
                                          long long lo, long long hi) {
  for (long long p = lo + threadIdx.x; p < hi; p += K3_THREADS) {
    out_k[p] = SENT;
    out_c[p] = 0;
  }
}

template <int OP>
__global__ void __launch_bounds__(K3_THREADS)
setop_kernel(const long long* ka, const long long* ca, long long MA,
             const long long* na_p, const long long* kb, const long long* cb,
             long long MB, const long long* nb_p, const long long* splits,
             u64* status, u64* counter, int write_tail, long long* out_k,
             long long* out_c, long long* n_out) {
  typedef cub::BlockScan<int, K3_THREADS> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;
  // A region: [0] the element before the slice, [1, la] the slice, [la + 1]
  // the element after it; the B region follows in the same form. The same
  // arrays then stage the compacted output.
  __shared__ long long s_k[K3_TILE + 4], s_c[K3_TILE + 4];
  __shared__ long long s_tile, s_excl;

  const int tid = threadIdx.x;
  const long long na = valid_len(na_p, MA), nb = valid_len(nb_p, MB);
  const long long N = na + nb;

  while (true) {
    if (tid == 0) s_tile = static_cast<long long>(atomicAdd(counter, 1ull));
    __syncthreads();
    const long long tile = s_tile;
    const long long d0 = tile * K3_TILE;
    if (d0 >= N) {  // uniform across the block
      // past the merged elements: nothing to do, or (with a valid count
      // absent on one side only) the rest of the capacity to fill
      if (!write_tail || d0 >= MA + MB) return;
      fill_tail(out_k, out_c, d0, d0 + K3_TILE < MA + MB ? d0 + K3_TILE
                                                         : MA + MB);
      __syncthreads();
      continue;
    }
    const long long d1 = d0 + K3_TILE < N ? d0 + K3_TILE : N;
    const long long a0 = splits[tile], a1 = splits[tile + 1];
    const long long b0 = d0 - a0, b1 = d1 - a1;
    const int la = static_cast<int>(a1 - a0), lb = static_cast<int>(b1 - b0);
    const int len = la + lb;
    const bool a_prev_ok = a0 > 0, a_next_ok = a1 < na;
    const bool b_prev_ok = b0 > 0, b_next_ok = b1 < nb;

    // 1. stage the slices and their halo elements
    for (int i = tid; i < la + 2; i += K3_THREADS) {
      const long long g = a0 - 1 + i;
      if (g >= 0 && g < na) {
        __pipeline_memcpy_async(&s_k[i], &ka[g], 8);
        __pipeline_memcpy_async(&s_c[i], &ca[g], 8);
      }
    }
    for (int i = tid; i < lb + 2; i += K3_THREADS) {
      const long long g = b0 - 1 + i;
      if (g >= 0 && g < nb) {
        __pipeline_memcpy_async(&s_k[la + 2 + i], &kb[g], 8);
        if (OP != OP_DIFF) __pipeline_memcpy_async(&s_c[la + 2 + i], &cb[g], 8);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    const long long* Ak = s_k + 1;  // Ak[-1] and Ak[la] are the halo
    const long long* Ac = s_c + 1;
    const long long* Bk = s_k + la + 3;
    const long long* Bc = s_c + la + 3;

    // 2. this thread's diagonals [dl, dl + m) of the tile's merge
    const int dl = tid * K3_ITEMS < len ? tid * K3_ITEMS : len;
    const int m = len - dl < K3_ITEMS ? len - dl : K3_ITEMS;
    int ai = merge_path<int>(Ak, la, Bk, lb, dl);
    int bi = dl - ai;
    const bool pa_ok = ai > 0 || a_prev_ok, pb_ok = bi > 0 || b_prev_ok;
    bool has_prev = pa_ok || pb_ok;
    long long prev = LLONG_MIN;
    if (pa_ok) prev = Ak[ai - 1];
    if (pb_ok && Bk[bi - 1] > prev) prev = Bk[bi - 1];

    long long key[K3_ITEMS + 1], cnt[K3_ITEMS + 1];
    bool present[K3_ITEMS + 1];
#pragma unroll
    for (int j = 0; j <= K3_ITEMS; ++j) {
      const bool ha = ai < la || (ai == la && a_next_ok);
      const bool hb = bi < lb || (bi == lb && b_next_ok);
      const long long xa = ha ? Ak[ai] : 0, xb = hb ? Bk[bi] : 0;
      const bool take_a = ha && (!hb || xa <= xb);
      present[j] = ha || hb;
      key[j] = take_a ? xa : xb;
      if (take_a) {
        cnt[j] = Ac[ai];
        ++ai;
      } else {
        cnt[j] = (hb && OP != OP_DIFF) ? Bc[bi] : 0;
        bi += hb;
      }
    }

    // 3. combine; kept items stay in key[] / cnt[] with a flag
    bool keep[K3_ITEMS];
    int kept = 0;
#pragma unroll
    for (int j = 0; j < K3_ITEMS; ++j) {
      const bool first = !(has_prev && prev == key[j]);
      const bool same_next = present[j + 1] && key[j + 1] == key[j];
      bool kp;
      long long c;
      combine<OP>(first, same_next, key[j] != SENT, cnt[j], cnt[j + 1], &kp,
                  &c);
      keep[j] = kp && j < m;
      cnt[j] = c;
      kept += keep[j];
      has_prev = true;
      prev = key[j];
    }
    __syncthreads();  // every thread is done reading the staged slices

    // 4. compaction in shared memory; the global offset by look-back
    int rank, total;
    Scan(scan_tmp).ExclusiveSum(kept, rank, total);
    if (tid < 32) {
      const long long excl = zt::lookback_publish(status, tile, total, tid);
      if (tid == 0) {
        s_excl = excl;
        if (d1 == N) *n_out = excl + total;
      }
    }
#pragma unroll
    for (int j = 0; j < K3_ITEMS; ++j) {
      if (keep[j]) {
        s_k[rank] = key[j];
        s_c[rank] = cnt[j];
        ++rank;
      }
    }
    __syncthreads();

    // 5. the dense slice, coalesced
    const long long excl = s_excl;
    for (int i = tid; i < total; i += K3_THREADS) {
      out_k[excl + i] = s_k[i];
      out_c[excl + i] = s_c[i];
    }
    if (write_tail) {
      // tiles 0..this dropped d1 - (excl + total) elements; this tile fills
      // its own len - total slots, counted down from N
      const long long lo = N - (d1 - (excl + total));
      fill_tail(out_k, out_c, lo, lo + (len - total));
      if (d1 == N)  // the capacity between N and the next tile boundary
        fill_tail(out_k, out_c, N, d0 + K3_TILE < MA + MB ? d0 + K3_TILE
                                                          : MA + MB);
    }
    __syncthreads();  // before the next tile reuses shared memory
  }
}

}  // namespace

// int64 scratch elements zt_set_op needs for inputs of MA and MB elements:
// a split per tile boundary, a status word per tile, the tile counter.
extern "C" long long zt_set_op_scratch_elems(long long MA, long long MB) {
  return 2 * k3_tiles(MA + MB) + 2;
}

// op: 0 merge/union, 1 intersect, 2 diff. na/nb: device pointers to the
// valid-prefix lengths, or null for the full MA/MB. out_k/out_c hold
// MA + MB elements: the dense result in [0, *n_out). With both lengths
// given nothing is written at or past *n_out; with either absent the slots
// [*n_out, MA + MB) are filled with INT64_MAX / 0.
extern "C" int zt_set_op(int op, const void* ka_v, const void* ca_v,
                         long long MA, const void* na_v, const void* kb_v,
                         const void* cb_v, long long MB, const void* nb_v,
                         void* out_k_v, void* out_c_v, void* n_out_v,
                         void* scratch_v, void* stream_v) {
  const long long* ka = static_cast<const long long*>(ka_v);
  const long long* ca = static_cast<const long long*>(ca_v);
  const long long* kb = static_cast<const long long*>(kb_v);
  const long long* cb = static_cast<const long long*>(cb_v);
  const long long* na = static_cast<const long long*>(na_v);
  const long long* nb = static_cast<const long long*>(nb_v);
  long long* out_k = static_cast<long long*>(out_k_v);
  long long* out_c = static_cast<long long*>(out_c_v);
  long long* n_out = static_cast<long long*>(n_out_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const long long tiles = k3_tiles(MA + MB);
  long long* splits = static_cast<long long*>(scratch_v);
  u64* status = reinterpret_cast<u64*>(splits + tiles + 1);
  u64* counter = status + tiles;
  const int write_tail = (na == nullptr || nb == nullptr) ? 1 : 0;

  unsigned grid = 0;
  cudaError_t err = zt::persistent_grid(tiles, K3_BLOCKS_PER_SM, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);

  setop_partition_kernel<<<static_cast<unsigned>((tiles + 1 + 255) / 256), 256,
                           0, stream>>>(ka, MA, na, kb, MB, nb, tiles, splits,
                                        status, counter, n_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (op) {
    case OP_MERGE:
      setop_kernel<OP_MERGE><<<grid, K3_THREADS, 0, stream>>>(
          ka, ca, MA, na, kb, cb, MB, nb, splits, status, counter, write_tail,
          out_k, out_c, n_out);
      break;
    case OP_INTERSECT:
      setop_kernel<OP_INTERSECT><<<grid, K3_THREADS, 0, stream>>>(
          ka, ca, MA, na, kb, cb, MB, nb, splits, status, counter, write_tail,
          out_k, out_c, n_out);
      break;
    case OP_DIFF:
      setop_kernel<OP_DIFF><<<grid, K3_THREADS, 0, stream>>>(
          ka, ca, MA, na, kb, cb, MB, nb, splits, status, counter, write_tail,
          out_k, out_c, n_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
