// K1: fused tokenize -> 2-bit pack -> canonicalize, one key per k-window.
//
// Replaces the Pallas kernels zotpu/kernels/pack_pallas.py
// pack_canonical_wire_pallas (def :203, pallas_call :222) and
// pack_canonical_pallas (def :160, pallas_call :173).
//
// Bound: memory bandwidth. Each window writes one 8-byte key; each base is
// read once as 0.375 bytes (wire form) or 1 byte (u8 codes). The k-step
// window build runs from shared memory at a few integer ops per base.
//
// Design: one block per read row. The block unpacks the row once into
// shared memory as u8 codes (4 = invalid), then one thread per window
// builds the forward 2k-bit key and its reverse complement in unsigned
// 64-bit registers (k <= 31, so 62 bits at most) and writes min(fwd, rc),
// or INT64_MAX when the window crosses the read length or holds a
// non-ACGT base. No row padding is needed (the TPU tiled rows by 64).

#include "common.cuh"

namespace {

constexpr int PACK_THREADS = 256;
constexpr int MAX_L = 4096;  // row length limit (shared-memory staging)

// Windows [0, L-k+1) of one staged row -> out[0, L-k+1).
__device__ void pack_row(const unsigned char* sc, int L, int len, int k,
                         long long* out) {
  const int m = L - k + 1;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    unsigned long long fwd = 0, rc = 0;
    bool ok = i + k <= len;
    for (int j = 0; j < k; ++j) {
      const unsigned c = sc[i + j];
      ok = ok && c < 4u;
      const unsigned long long b = c & 3u;
      fwd = (fwd << 2) | b;                // first base most significant
      rc |= (b ^ 3ull) << (2 * j);         // complement, reversed order
    }
    const unsigned long long canon = fwd < rc ? fwd : rc;
    out[i] = ok ? static_cast<long long>(canon) : zt::SENT;
  }
}

// Striped wire layout (zotpu/io/wire.py): with W = L/16 and M = L/32,
// base i sits in packed word i % W at bits 2*(i / W), and its invalid flag
// in mask word i % M at bit i / M.
__global__ void pack_wire_kernel(const unsigned* packed, const unsigned* mask,
                                 const int* lengths, int L, int k,
                                 long long* out) {
  __shared__ unsigned char sc[MAX_L];
  __shared__ unsigned sw[MAX_L / 16 + MAX_L / 32];
  const long long r = blockIdx.x;
  const int W = L / 16, M = L / 32;
  for (int i = threadIdx.x; i < W; i += blockDim.x) sw[i] = packed[r * W + i];
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    sw[W + i] = mask[r * M + i];
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const unsigned c = (sw[i % W] >> (2 * (i / W))) & 3u;
    const unsigned bad = (sw[W + i % M] >> (i / M)) & 1u;
    sc[i] = bad ? 4 : static_cast<unsigned char>(c);
  }
  __syncthreads();
  pack_row(sc, L, lengths[r], k, out + r * (L - k + 1));
}

__global__ void pack_codes_kernel(const unsigned char* codes,
                                  const int* lengths, int L, int k,
                                  long long* out) {
  __shared__ unsigned char sc[MAX_L];
  const long long r = blockIdx.x;
  for (int i = threadIdx.x; i < L; i += blockDim.x) sc[i] = codes[r * L + i];
  __syncthreads();
  pack_row(sc, L, lengths[r], k, out + r * (L - k + 1));
}

}  // namespace

extern "C" int zt_pack_max_len() { return MAX_L; }

extern "C" int zt_pack_wire(const void* packed, const void* mask,
                            const void* lengths, long long rows, int L, int k,
                            void* out, void* stream) {
  pack_wire_kernel<<<static_cast<unsigned>(rows), PACK_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(packed), static_cast<const unsigned*>(mask),
      static_cast<const int*>(lengths), L, k, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zt_pack_codes(const void* codes, const void* lengths,
                             long long rows, int L, int k, void* out,
                             void* stream) {
  pack_codes_kernel<<<static_cast<unsigned>(rows), PACK_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(codes),
      static_cast<const int*>(lengths), L, k, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
