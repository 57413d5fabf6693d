// K1: fused tokenize -> 2-bit pack -> canonicalize, one key per k-window.
//
// Replaces the Pallas kernels zotpu/kernels/pack_pallas.py
// pack_canonical_wire_pallas (def :203, pallas_call :222) and
// pack_canonical_pallas (def :160, pallas_call :173).
//
// Bound: memory bandwidth. Each window writes one 8-byte key; each base is
// read once as 0.375 bytes (wire form) or 1 byte (u8 codes).
//
// Design: constant work per window, and few integer operations per base
// (the kernel is bound by the integer pipe before it is bound by bytes). A
// block takes several rows (about WINDOWS_PER_BLOCK windows).
//   1. It turns them into a LINEAR 2-bit stream in shared memory: 64-bit
//      words, base i of a row in word i / 32 at bits 63 - 2 * (i % 32) and
//      the bit below (first base most significant), and one invalid bit per
//      base in 32-bit words. A thread builds one word: it walks its 32
//      bases through the striped wire words staged in shared memory (one
//      division per word, then increments), or through the u8 codes.
//   2. A thread takes GROUP consecutive windows of one row. The first
//      window's forward key is a funnel shift of two adjacent words cut to
//      2k bits; its reverse complement is the complement of the bit
//      reversal of the same bits with the bits of each pair swapped back.
//      Every further window rolls both by one base taken from the stream.
//      A window is valid iff the k invalid bits of [i, i + k), taken by the
//      same funnel shift, are zero and i + k <= len.
//   3. The keys go through a padded staging array in shared memory, so
//      that the stores to the one contiguous [rows, L - k + 1] output are
//      fully coalesced and no lane idles at a row's end.

#include "common.cuh"

namespace {

constexpr int PACK_THREADS = 256;
constexpr int MAX_L = 4096;  // row length limit
constexpr int GROUP = 8;     // consecutive windows a thread rolls through
constexpr int WINDOWS_PER_BLOCK = PACK_THREADS * GROUP;
constexpr int MAX_ROWS_PER_BLOCK = 32;
// staged keys of one batch of PACK_THREADS groups, one pad word per 8
constexpr int STAGE_WORDS = WINDOWS_PER_BLOCK + WINDOWS_PER_BLOCK / 8 + 8;

typedef unsigned long long u64;

// Shared memory of a block that takes `rows` rows of L bases; C = the
// 32-base chunks of a row. Two spare words per row: a group reads up to
// two words past its first window's.
struct Layout {
  int C;
  __host__ __device__ Layout(int L) : C((L + 31) / 32) {}
  __host__ __device__ int row_words() const { return C + 2; }
  // bytes: staged keys (u64), linear 2-bit words (u64), invalid bits
  // (u32), lengths (int), then, for the wire form, the striped words (u32)
  __host__ __device__ size_t bytes(int rows, int L, bool wire) const {
    return static_cast<size_t>(STAGE_WORDS) * 8 +
           static_cast<size_t>(rows) * row_words() * 12 +
           static_cast<size_t>(rows) * 4 +
           (wire ? static_cast<size_t>(rows) * (L / 16 + L / 32) * 4 : 0);
  }
};

inline int rows_per_block(int L, int k) {
  const int r = WINDOWS_PER_BLOCK / (L - k + 1);
  return r < 1 ? 1 : (r > MAX_ROWS_PER_BLOCK ? MAX_ROWS_PER_BLOCK : r);
}

// The 64 stream bits that start at base `pos` of a row (32 bases).
__device__ __forceinline__ u64 stream64(const u64* row, int pos) {
  const int q = pos >> 5, s = 2 * (pos & 31);
  const u64 w0 = row[q];
  return s ? (w0 << s) | (row[q + 1] >> (64 - s)) : w0;
}

// Windows of the block's nr staged rows -> out[0, nr * m), m = L - k + 1.
__device__ void pack_windows(u64* stage, const u64* lin, const unsigned* inv,
                             const int* len, int nr, int row_words, int m,
                             int k, long long* out) {
  const u64 low = (1ull << (2 * k)) - 1;  // k <= 31
  const unsigned kbits = (1u << k) - 1;
  const int gpr = (m + GROUP - 1) / GROUP;  // groups per row
  const int groups = nr * gpr;
  for (int u_lo = 0; u_lo < groups; u_lo += PACK_THREADS) {
    // the batch's groups cover the flat windows [f_lo, f_hi) of the block
    const int r_lo = u_lo / gpr;
    const int f_lo = r_lo * m + (u_lo - r_lo * gpr) * GROUP;
    const int u_hi = u_lo + PACK_THREADS < groups ? u_lo + PACK_THREADS
                                                  : groups;
    const int r_hi = u_hi / gpr;
    const int f_hi = r_hi * m + (u_hi - r_hi * gpr) * GROUP;
    const int u = u_lo + threadIdx.x;
    if (u < groups) {
      const int r = u / gpr;
      const int i0 = (u - r * gpr) * GROUP;
      const int cnt = m - i0 < GROUP ? m - i0 : GROUP;
      const int f0 = r * m + i0 - f_lo;
      const u64* row = lin + r * row_words;
      const unsigned* irow = inv + r * row_words + (i0 >> 5);
      u64 fwd = stream64(row, i0) >> (64 - 2 * k);
      // reversed bits of fwd's 2k bits, then each pair's bits swapped back
      const u64 rev = __brevll(fwd) >> (64 - 2 * k);
      u64 rc = ((((rev & 0x5555555555555555ull) << 1) |
                 ((rev >> 1) & 0x5555555555555555ull))) ^ low;
      u64 next = stream64(row, i0 + k);  // the bases after the first window
      const unsigned bad_lo = __funnelshift_r(irow[0], irow[1], i0 & 31);
      const unsigned bad_hi = __funnelshift_r(irow[1], irow[2], i0 & 31);
      const int last_ok = len[r] - k - i0;  // window j is inside iff j <= it
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (j > 0) {
          const u64 b = next >> 62;
          next <<= 2;
          fwd = ((fwd << 2) | b) & low;
          rc = (rc >> 2) | ((b ^ 3ull) << (2 * k - 2));
        }
        const unsigned bad = __funnelshift_r(bad_lo, bad_hi, j) & kbits;
        const u64 canon = fwd < rc ? fwd : rc;
        if (j < cnt) {
          const int f = f0 + j;
          stage[f + (f >> 3)] = (bad == 0 && j <= last_ok)
                                    ? canon
                                    : static_cast<u64>(zt::SENT);
        }
      }
    }
    __syncthreads();
    for (int f = threadIdx.x; f < f_hi - f_lo; f += PACK_THREADS)
      out[f_lo + f] = static_cast<long long>(stage[f + (f >> 3)]);
    __syncthreads();
  }
}

// Carve the block's shared memory (Layout::bytes).
struct Smem {
  u64* stage;
  u64* lin;
  unsigned* inv;
  int* len;
  unsigned* wire;
  __device__ Smem(u64* base, int rows, int row_words) {
    stage = base;
    lin = stage + STAGE_WORDS;
    inv = reinterpret_cast<unsigned*>(lin + rows * row_words);
    len = reinterpret_cast<int*>(inv + rows * row_words);
    wire = reinterpret_cast<unsigned*>(len + rows);
  }
};

__device__ __forceinline__ void store_word(u64* lin, unsigned* inv, int q,
                                           int C, u64 codes, unsigned bad) {
  lin[q] = codes;
  inv[q] = bad;
  if (q == C - 1) {  // the row's spare words: read, never part of a key
    lin[C] = lin[C + 1] = 0;
    inv[C] = inv[C + 1] = 0;
  }
}

// Striped wire layout (zotpu_torch/io/wire.py): with W = L/16 and
// M = L/32, base i sits in packed word i % W at bits 2*(i / W), and its
// invalid flag in mask word i % M at bit i / M.
__global__ void __launch_bounds__(PACK_THREADS)
pack_wire_kernel(const unsigned* packed, const unsigned* mask,
                 const int* lengths, long long rows, int L, int k,
                 int rows_blk, long long* out) {
  extern __shared__ u64 smem[];
  const Layout lay(L);
  const int C = lay.C, W = L / 16, M = L / 32;
  const Smem sm(smem, rows_blk, lay.row_words());
  unsigned* sp = sm.wire;
  unsigned* smk = sp + rows_blk * W;

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_blk;
  const int nr = static_cast<int>(rows - row0 < rows_blk ? rows - row0
                                                          : rows_blk);
  for (int i = threadIdx.x; i < nr * W; i += PACK_THREADS)
    sp[i] = packed[row0 * W + i];
  for (int i = threadIdx.x; i < nr * M; i += PACK_THREADS)
    smk[i] = mask[row0 * M + i];
  for (int i = threadIdx.x; i < nr; i += PACK_THREADS)
    sm.len[i] = lengths[row0 + i];
  __syncthreads();

  for (int x = threadIdx.x; x < nr * C; x += PACK_THREADS) {
    const int r = x / C, q = x - r * C;
    const unsigned* pr = sp + r * W;
    const unsigned* mr = smk + r * M;
    int j = 32 * q / W, w = 32 * q - j * W;     // base 32q: word w, field j
    int jm = 32 * q / M, wm = 32 * q - jm * M;
    u64 codes = 0;
    unsigned bad = 0;
    for (int t = 0; t < 32; ++t) {  // 32 divides L: every base exists
      codes = (codes << 2) | ((pr[w] >> (2 * j)) & 3u);
      bad |= ((mr[wm] >> jm) & 1u) << t;
      if (++w == W) { w = 0; ++j; }
      if (++wm == M) { wm = 0; ++jm; }
    }
    store_word(sm.lin + r * lay.row_words(), sm.inv + r * lay.row_words(), q,
               C, codes, bad);
  }
  __syncthreads();
  const int m = L - k + 1;
  pack_windows(sm.stage, sm.lin, sm.inv, sm.len, nr, lay.row_words(), m, k,
               out + row0 * m);
}

__global__ void __launch_bounds__(PACK_THREADS)
pack_codes_kernel(const unsigned char* codes, const int* lengths,
                  long long rows, int L, int k, int rows_blk, long long* out) {
  extern __shared__ u64 smem[];
  const Layout lay(L);
  const int C = lay.C;
  const Smem sm(smem, rows_blk, lay.row_words());

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_blk;
  const int nr = static_cast<int>(rows - row0 < rows_blk ? rows - row0
                                                          : rows_blk);
  for (int i = threadIdx.x; i < nr; i += PACK_THREADS)
    sm.len[i] = lengths[row0 + i];
  for (int x = threadIdx.x; x < nr * C; x += PACK_THREADS) {
    const int r = x / C, q = x - r * C;
    const unsigned char* src = codes + (row0 + r) * L + 32 * q;
    const int nb = L - 32 * q < 32 ? L - 32 * q : 32;
    u64 word = 0;
    unsigned bad = 0;
    for (int t = 0; t < 32; ++t) {
      // past the row's end (32 need not divide L): an invalid base
      const unsigned c = t < nb ? src[t] : 4u;
      word = (word << 2) | (c & 3u);
      bad |= (c >= 4u ? 1u : 0u) << t;
    }
    store_word(sm.lin + r * lay.row_words(), sm.inv + r * lay.row_words(), q,
               C, word, bad);
  }
  __syncthreads();
  const int m = L - k + 1;
  pack_windows(sm.stage, sm.lin, sm.inv, sm.len, nr, lay.row_words(), m, k,
               out + row0 * m);
}

}  // namespace

extern "C" int zt_pack_max_len() { return MAX_L; }

extern "C" int zt_pack_wire(const void* packed, const void* mask,
                            const void* lengths, long long rows, int L, int k,
                            void* out, void* stream) {
  const int rb = rows_per_block(L, k);
  const unsigned grid = static_cast<unsigned>((rows + rb - 1) / rb);
  pack_wire_kernel<<<grid, PACK_THREADS, Layout(L).bytes(rb, L, true),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(packed), static_cast<const unsigned*>(mask),
      static_cast<const int*>(lengths), rows, L, k, rb,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zt_pack_codes(const void* codes, const void* lengths,
                             long long rows, int L, int k, void* out,
                             void* stream) {
  const int rb = rows_per_block(L, k);
  const unsigned grid = static_cast<unsigned>((rows + rb - 1) / rb);
  pack_codes_kernel<<<grid, PACK_THREADS, Layout(L).bytes(rb, L, false),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(codes),
      static_cast<const int*>(lengths), rows, L, k, rb,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
