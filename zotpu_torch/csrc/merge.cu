// K3: fused sorted set operation: two dense sorted unique (key, count)
// sets -> merge -> combine (merge/union, intersect, diff) -> dense output
// and n_out, in one kernel family with the op as a template parameter.
//
// Replaces the Pallas kernel zotpu/kernels/merge_fused.py set_op_fused
// (def :510, pallas_call :609); combine rules from _combine_policy (:160).
//
// Bound: memory bandwidth (each input element is read once, each output
// element is written twice: once uncompacted, once compacted).
//
// Design: block b owns the output diagonals [b*TILE, (b+1)*TILE) of the
// merge of A[:n_a] and B[:n_b] (A first on equal keys). It finds both ends'
// merge-path splits by binary search, stages its A and B slices in shared
// memory and places every element at its merged rank (its index plus a
// binary-search count in the other slice). Inputs are unique per side, so
// a key segment has at most two members, one per side; a segment crossing
// the block boundary is resolved by reading the merged element just before
// the block (the larger of A[a0-1], B[b0-1]) and just after it (the smaller
// of A[a1], B[b1]) instead of the TPU's carried deferred element. The
// combined, uncompacted tile goes to scratch with the sentinel in dropped
// slots; a scan of the per-block kept counts and a compaction pass write the
// dense result; the same pass writes the INT64_MAX / 0 tail past n_out, as
// K2's finish pass does. n_a and n_b are read on the device, so no host
// sync; blocks past n_a + n_b skip the merge and only write that tail.

#include <climits>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

using zt::COUNT_MAX;
using zt::ITEMS;
using zt::SENT;
using zt::THREADS;
using zt::TILE;

enum { OP_MERGE = 0, OP_INTERSECT = 1, OP_DIFF = 2 };

__device__ __forceinline__ long long valid_len(const long long* p,
                                               long long cap) {
  if (p == nullptr) return cap;
  const long long v = *p;
  return v < 0 ? 0 : (v > cap ? cap : v);
}

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

template <int OP>
__global__ void setop_merge_kernel(const long long* ka, const long long* ca,
                                   long long MA, const long long* na_p,
                                   const long long* kb, const long long* cb,
                                   long long MB, const long long* nb_p,
                                   long long* tmp_k, long long* tmp_c,
                                   long long* block_counts) {
  typedef cub::BlockReduce<long long, THREADS> Reduce;
  __shared__ typename Reduce::TempStorage red;
  __shared__ long long s_in_k[TILE], s_in_c[TILE], s_k[TILE], s_c[TILE];
  __shared__ long long s_split[2];

  const long long na = valid_len(na_p, MA), nb = valid_len(nb_p, MB);
  const long long N = na + nb;
  const long long d0 = static_cast<long long>(blockIdx.x) * TILE;
  if (d0 >= N) {  // dead tile: only sentinel padding would merge here
    if (threadIdx.x == 0) block_counts[blockIdx.x] = 0;
    return;
  }
  const long long d1 = d0 + TILE < N ? d0 + TILE : N;
  if (threadIdx.x < 2)
    s_split[threadIdx.x] = merge_path(ka, na, kb, nb, threadIdx.x ? d1 : d0);
  __syncthreads();
  const long long a0 = s_split[0], a1 = s_split[1];
  const long long b0 = d0 - a0, b1 = d1 - a1;
  const int la = static_cast<int>(a1 - a0);
  const int len = static_cast<int>(d1 - d0);

  for (int i = threadIdx.x; i < len; i += THREADS) {
    if (i < la) {
      s_in_k[i] = ka[a0 + i];
      s_in_c[i] = ca[a0 + i];
    } else {
      s_in_k[i] = kb[b0 + i - la];
      s_in_c[i] = OP == OP_DIFF ? 0 : cb[b0 + i - la];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += THREADS) {
    const long long key = s_in_k[i];
    const int r = i < la ? i + count_less(s_in_k + la, len - la, key)
                         : (i - la) + count_leq(s_in_k, la, key);
    s_k[r] = key;
    s_c[r] = s_in_c[i];
  }
  __syncthreads();

  // the merged elements just before and just after this block's range
  const bool has_prev = a0 > 0 || b0 > 0;
  long long prev = LLONG_MIN;
  if (a0 > 0) prev = ka[a0 - 1];
  if (b0 > 0 && kb[b0 - 1] > prev) prev = kb[b0 - 1];
  bool has_next = false;
  long long next_k = 0, next_c = 0;
  if (a1 < na && (b1 >= nb || ka[a1] <= kb[b1])) {
    has_next = true;
    next_k = ka[a1];
    next_c = ca[a1];
  } else if (b1 < nb) {
    has_next = true;
    next_k = kb[b1];
    next_c = OP == OP_DIFF ? 0 : cb[b1];
  }

  long long kept = 0;
  for (int p = threadIdx.x; p < len; p += THREADS) {
    const long long key = s_k[p], c = s_c[p];
    const bool first = p == 0 ? (!has_prev || prev != key) : s_k[p - 1] != key;
    const bool inside = p + 1 < len;
    const bool same_next = inside ? s_k[p + 1] == key
                                  : (has_next && next_k == key);
    const long long nc = inside ? s_c[p + 1] : next_c;
    bool keep;
    long long cnt;
    combine<OP>(first, same_next, key != SENT, c, nc, &keep, &cnt);
    tmp_k[d0 + p] = keep ? key : SENT;
    tmp_c[d0 + p] = keep ? cnt : 0;
    kept += keep;
  }
  const long long total = Reduce(red).Sum(kept);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

// Stable compaction of the combined tiles: non-sentinel slots move to
// offsets[b] + (their rank within the block). Then every block writes the
// sentinel tail over the slots of its tile at or past *n_out; compaction
// writes only slots below *n_out, so the two never meet.
__global__ void setop_compact_kernel(const long long* tmp_k,
                                     const long long* tmp_c, long long MA,
                                     const long long* na_p, long long MB,
                                     const long long* nb_p,
                                     const long long* offsets,
                                     const long long* n_out,
                                     long long* out_k, long long* out_c) {
  typedef cub::BlockScan<long long, THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const long long N = valid_len(na_p, MA) + valid_len(nb_p, MB);
  const long long d0 = static_cast<long long>(blockIdx.x) * TILE;
  if (d0 < N) {  // uniform across the block
    const long long base = d0 + threadIdx.x * ITEMS;
    bool kept[ITEMS];
    long long cnt = 0;
    for (int j = 0; j < ITEMS; ++j) {
      kept[j] = base + j < N && tmp_k[base + j] != SENT;
      cnt += kept[j];
    }
    long long ex;
    Scan(tmp).ExclusiveSum(cnt, ex);
    long long pos = offsets[blockIdx.x] + ex;
    for (int j = 0; j < ITEMS; ++j) {
      if (kept[j]) {
        out_k[pos] = tmp_k[base + j];
        out_c[pos] = tmp_c[base + j];
        ++pos;
      }
    }
  }
  const long long nu = *n_out, cap = MA + MB;
  const long long end = d0 + TILE < cap ? d0 + TILE : cap;
  const long long start = d0 > nu ? d0 : nu;
  for (long long p = start + threadIdx.x; p < end; p += THREADS) {
    out_k[p] = SENT;
    out_c[p] = 0;
  }
}

}  // namespace

// int64 scratch elements zt_set_op needs for inputs of MA and MB elements.
extern "C" long long zt_set_op_scratch_elems(long long MA, long long MB) {
  return 2 * (MA + MB) + 2 * zt::n_tiles(MA + MB);
}

// op: 0 merge/union, 1 intersect, 2 diff. na/nb: device pointers to the
// valid-prefix lengths, or null for the full MA/MB. out_k/out_c hold
// MA + MB elements: the dense result, then INT64_MAX / 0.
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
  const long long total = MA + MB;
  const long long tiles = zt::n_tiles(total);
  long long* tmp_k = static_cast<long long*>(scratch_v);
  long long* tmp_c = tmp_k + total;
  long long* block_counts = tmp_c + total;
  long long* offsets = block_counts + tiles;
  const unsigned grid = static_cast<unsigned>(tiles);

  switch (op) {
    case OP_MERGE:
      setop_merge_kernel<OP_MERGE><<<grid, THREADS, 0, stream>>>(
          ka, ca, MA, na, kb, cb, MB, nb, tmp_k, tmp_c, block_counts);
      break;
    case OP_INTERSECT:
      setop_merge_kernel<OP_INTERSECT><<<grid, THREADS, 0, stream>>>(
          ka, ca, MA, na, kb, cb, MB, nb, tmp_k, tmp_c, block_counts);
      break;
    case OP_DIFF:
      setop_merge_kernel<OP_DIFF><<<grid, THREADS, 0, stream>>>(
          ka, ca, MA, na, kb, cb, MB, nb, tmp_k, tmp_c, block_counts);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  ZT_CHECK_LAUNCH();
  cudaError_t err =
      zt::launch_scan_blocks(block_counts, offsets, tiles, n_out, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  setop_compact_kernel<<<grid, THREADS, 0, stream>>>(
      tmp_k, tmp_c, MA, na, MB, nb, offsets, n_out, out_k, out_c);
  return static_cast<int>(cudaGetLastError());
}
