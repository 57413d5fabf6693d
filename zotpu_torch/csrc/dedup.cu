// K2: dense dedup-compact of a sorted key array: sorted keys with
// duplicates and an INT64_MAX tail -> unique keys up front with their
// segment counts, and n_unique. No sort.
//
// Replaces the Pallas kernel zotpu/kernels/dedup_pallas.py
// dedup_compact_pallas (def :243, pallas_call :287).
//
// Bound: memory bandwidth. The keys are read once, 8 bytes each; a key and
// a count are written once per unique key; nothing else touches device
// memory but a few words per tile.
//
// Design: the TPU kernel carries a running output cursor across a
// sequential grid. GPU blocks run in no order, so the cursor becomes a
// decoupled look-back (common.cuh). The kernel is persistent: a block takes
// tile ids from an atomic counter. For a tile of ROWS rows of THREADS keys
//   1. every thread loads one key per row, coalesced, all rows in flight
//      together, and takes its predecessor from the lane below (lane 0
//      from the previous warp's last key, handed over in shared memory): a
//      key is a segment FIRST if it differs from its predecessor and is
//      not the sentinel;
//   2. a ballot per warp and row and one small scan give every first its
//      rank in the tile, and the look-back the tile's global offset;
//   3. firsts write their keys straight to ukeys[offset + rank] (ranks of
//      neighbouring lanes are neighbours) and their positions to shared
//      memory; count[j] = start[j + 1] - start[j] is then written coalesced
//      for every first of the tile but the last, whose segment ends in a
//      later tile.
// A second, tiny kernel (a thread per tile) closes those last segments: it
// finds the next tile that holds a first, or the number of non-sentinel
// keys. Slots at or past n_unique are not written.

#include "common.cuh"

namespace {

using zt::SENT;
using zt::u64;

constexpr int K2_THREADS = 256;
constexpr int K2_WARPS = K2_THREADS / 32;
// A tile of 32 KB of keys: the look-back gets deeper the more tiles are in
// flight at once, so tiles are large and the blocks per SM few.
constexpr int K2_ROWS = 16;
constexpr int K2_TILE = K2_THREADS * K2_ROWS;
constexpr int K2_BLOCKS_PER_SM = 4;
constexpr long long NO_FIRST = -1;

inline long long k2_tiles(long long n) { return (n + K2_TILE - 1) / K2_TILE; }

// Scratch words after the tiles' status words.
struct Scratch {
  u64* status;           // [tiles] look-back words; PREFIX when done
  long long* first_pos;  // [tiles] position of the tile's first FIRST
  long long* last_pos;   // [tiles] position of its last FIRST
  u64* counter;          // the next tile id
  long long* n_valid1;   // 1 + the number of non-sentinel keys; 0 = all n
  __host__ __device__ Scratch(long long* base, long long tiles)
      : status(reinterpret_cast<u64*>(base)),
        first_pos(base + tiles),
        last_pos(base + 2 * tiles),
        counter(reinterpret_cast<u64*>(base + 3 * tiles)),
        n_valid1(base + 3 * tiles + 1) {}
};

__global__ void __launch_bounds__(K2_THREADS)
dedup_kernel(const long long* __restrict__ keys, long long n, long long tiles,
             long long* __restrict__ scratch, long long* __restrict__ ukeys,
             long long* __restrict__ counts, long long* __restrict__ n_unique) {
  __shared__ int s_row_warp[K2_ROWS * K2_WARPS + 1];  // counts, then offsets
  __shared__ int s_start[K2_TILE + 1];
  __shared__ long long s_last[K2_ROWS * K2_WARPS];  // each warp's last key
  __shared__ long long s_tile, s_excl;
  const Scratch sc(scratch, tiles);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  while (true) {
    if (tid == 0) s_tile = static_cast<long long>(atomicAdd(sc.counter, 1ull));
    __syncthreads();
    const long long tile = s_tile;
    if (tile >= tiles) return;  // uniform across the block
    const long long d0 = tile * K2_TILE;

    long long key[K2_ROWS];
    unsigned firsts[K2_ROWS];
    // the key before the tile (thread 0 only; none before key 0)
    long long halo = SENT;
    if (tid == 0 && d0 > 0) halo = keys[d0 - 1];
#pragma unroll
    for (int j = 0; j < K2_ROWS; ++j) {
      const long long idx = d0 + j * K2_THREADS + tid;
      key[j] = SENT;
      if (idx < n) key[j] = keys[idx];
    }
#pragma unroll
    for (int j = 0; j < K2_ROWS; ++j)
      if (lane == 31) s_last[j * K2_WARPS + warp] = key[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K2_ROWS; ++j) {
      const long long idx = d0 + j * K2_THREADS + tid;
      const long long k = key[j];
      long long prev = __shfl_up_sync(0xffffffffu, k, 1);
      if (lane == 0)  // element order: row-major, so the slot before
        prev = tid + j == 0 ? halo : s_last[j * K2_WARPS + warp - 1];
      const bool differs = idx == 0 || prev != k;
      // the first sentinel's position is the number of valid keys
      if (idx < n && k == SENT && differs) *sc.n_valid1 = idx + 1;
      firsts[j] = __ballot_sync(0xffffffffu,
                                idx < n && k != SENT && differs);
      if (lane == 0) s_row_warp[j * K2_WARPS + warp] = __popc(firsts[j]);
    }
    __syncthreads();
    // exclusive scan of the ROWS x WARPS counts, in element order
    if (warp == 0) {
      constexpr int PER = K2_ROWS * K2_WARPS / 32;
      int v[PER], sum = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        v[i] = s_row_warp[lane * PER + i];
        sum += v[i];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      int run = incl - sum;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        s_row_warp[lane * PER + i] = run;
        run += v[i];
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      if (lane == 0) s_row_warp[K2_ROWS * K2_WARPS] = total;
      const long long excl = zt::lookback_publish(sc.status, tile, total, lane);
      if (lane == 0) {
        s_excl = excl;
        if (tile == tiles - 1) *n_unique = excl + total;
      }
    }
    __syncthreads();
    const int total = s_row_warp[K2_ROWS * K2_WARPS];
    const long long excl = s_excl;
    if (total > 0) {  // uniform
#pragma unroll
      for (int j = 0; j < K2_ROWS; ++j) {
        if (firsts[j] >> lane & 1u) {
          const int r = s_row_warp[j * K2_WARPS + warp] +
                        __popc(firsts[j] & ((1u << lane) - 1));
          ukeys[excl + r] = key[j];
          s_start[r] = j * K2_THREADS + tid;
        }
      }
      __syncthreads();
      for (int r = tid; r + 1 < total; r += K2_THREADS)
        counts[excl + r] = s_start[r + 1] - s_start[r];
      if (tid == 0) {
        sc.first_pos[tile] = d0 + s_start[0];
        sc.last_pos[tile] = d0 + s_start[total - 1];
      }
    } else if (tid == 0) {
      sc.first_pos[tile] = NO_FIRST;
    }
    __syncthreads();  // before the next tile reuses shared memory
  }
}

// A thread per tile: the count of the tile's last segment, which ends at
// the first FIRST of a later tile that still holds valid keys, or at the
// last valid key. (A run of equal keys over many tiles makes this search
// long; k-mer runs are short.)
__global__ void dedup_close_kernel(long long n, long long tiles,
                                   long long* scratch, long long* counts) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= tiles) return;
  const Scratch sc(scratch, tiles);
  if (sc.first_pos[t] == NO_FIRST) return;
  long long end = *sc.n_valid1 ? *sc.n_valid1 - 1 : n;
  for (long long u = t + 1; u * K2_TILE < end; ++u) {
    if (sc.first_pos[u] != NO_FIRST) {
      end = sc.first_pos[u];
      break;
    }
  }
  const long long j = static_cast<long long>(sc.status[t] & zt::ST_VALUE) - 1;
  counts[j] = end - sc.last_pos[t];
}

}  // namespace

namespace zt {

long long dedup_scratch_elems(long long n) { return 3 * k2_tiles(n) + 2; }

cudaError_t launch_dedup_compact(const long long* keys, long long n,
                                 long long* ukeys, long long* counts,
                                 long long* n_unique, long long* scratch,
                                 cudaStream_t stream) {
  const long long tiles = k2_tiles(n);
  // status words, the tile counter and n_valid1 start at 0
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(long long) * dedup_scratch_elems(n), stream);
  if (err != cudaSuccess) return err;
  unsigned grid = 0;
  err = persistent_grid(tiles, K2_BLOCKS_PER_SM, &grid);
  if (err != cudaSuccess) return err;
  dedup_kernel<<<grid, K2_THREADS, 0, stream>>>(keys, n, tiles, scratch, ukeys,
                                                counts, n_unique);
  ZT_CHECK_LAUNCH();
  dedup_close_kernel<<<static_cast<unsigned>((tiles + 255) / 256), 256, 0,
                       stream>>>(n, tiles, scratch, counts);
  return cudaGetLastError();
}

}  // namespace zt

// int64 scratch elements zt_dedup_compact needs for n keys.
extern "C" long long zt_dedup_scratch_elems(long long n) {
  return zt::dedup_scratch_elems(n);
}

// keys: n >= 1 sorted int64 -> ukeys/counts (n each; written in
// [0, *n_unique) only), *n_unique.
extern "C" int zt_dedup_compact(const void* keys_v, long long n, void* ukeys_v,
                                void* counts_v, void* n_unique_v,
                                void* scratch_v, void* stream_v) {
  return static_cast<int>(zt::launch_dedup_compact(
      static_cast<const long long*>(keys_v), n,
      static_cast<long long*>(ukeys_v), static_cast<long long*>(counts_v),
      static_cast<long long*>(n_unique_v), static_cast<long long*>(scratch_v),
      static_cast<cudaStream_t>(stream_v)));
}

// The text of a CUDA error code that an entry point returned.
extern "C" const char* zt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
