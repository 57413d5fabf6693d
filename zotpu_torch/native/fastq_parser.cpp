// A copy of zotpu/native/fastq_parser.cpp.
// Native host-side FASTQ parser: raw byte buffer -> fixed-shape 2-bit code
// batches ready for device upload.
//
// Reference analog: zotmer/library/file.py readFastq (pure-Python generator;
// SURVEY.md section 2a). At the >=1 Gbase/s/host target the host input
// pipeline is the bottleneck (SURVEY.md section 7 "hard parts"), so the
// parse+encode inner loop is C++ (memchr newline scans + 256-entry LUT
// encode), exposed through a C ABI for ctypes (no pybind11 in this image).
//
// Semantics must match zotpu_torch/semantics.py: A/C/G/T (either case) -> 0..3,
// anything else -> 4 (INVALID_CODE); codes rows padded with 4.

#include <cstdint>
#include <cstring>

namespace {
uint8_t LUT[256];
struct LutInit {
    LutInit() {
        memset(LUT, 4, sizeof(LUT));
        LUT['A'] = LUT['a'] = 0;
        LUT['C'] = LUT['c'] = 1;
        LUT['G'] = LUT['g'] = 2;
        LUT['T'] = LUT['t'] = 3;
    }
} lut_init;
}  // namespace

extern "C" {

// Parse up to max_reads FASTQ records from buf[0..len).
// codes: caller-allocated (max_reads * max_len) u8, filled row-major.
// lengths: caller-allocated (max_reads) i32 (clamped to max_len).
// consumed: bytes of buf consumed (complete records only).
// max_seen: longest sequence line seen (pre-clamp) -- lets the caller detect
//           truncation and fall back to the halo-chunking slow path.
// Returns number of records parsed.
int64_t zotpu_parse_fastq(const uint8_t* buf, int64_t len,
                          int64_t max_reads, int64_t max_len,
                          uint8_t* codes, int32_t* lengths,
                          int64_t* consumed, int64_t* max_seen) {
    int64_t nreads = 0;
    int64_t pos = 0;
    int64_t seen = 0;
    while (nreads < max_reads) {
        int64_t line_start[4];
        int64_t line_end[4];
        int64_t p = pos;
        bool complete = true;
        for (int l = 0; l < 4; ++l) {
            line_start[l] = p;
            if (p >= len) { complete = false; break; }
            const void* nl = memchr(buf + p, '\n', static_cast<size_t>(len - p));
            if (nl == nullptr) { complete = false; break; }
            line_end[l] = static_cast<const uint8_t*>(nl) - buf;
            p = line_end[l] + 1;
        }
        if (!complete) break;
        int64_t s = line_start[1];
        int64_t e = line_end[1];
        // tolerate \r\n
        if (e > s && buf[e - 1] == '\r') --e;
        int64_t L = e - s;
        if (L > seen) seen = L;
        if (L > max_len) L = max_len;
        uint8_t* row = codes + nreads * max_len;
        for (int64_t i = 0; i < L; ++i) row[i] = LUT[buf[s + i]];
        if (L < max_len) memset(row + L, 4, static_cast<size_t>(max_len - L));
        lengths[nreads] = static_cast<int32_t>(L);
        ++nreads;
        pos = p;
    }
    *consumed = pos;
    *max_seen = seen;
    return nreads;
}

// Encode arbitrary bytes -> codes (for FASTA bodies handled host-side).
void zotpu_encode(const uint8_t* buf, int64_t len, uint8_t* out) {
    for (int64_t i = 0; i < len; ++i) out[i] = LUT[buf[i]];
}

// Pack code rows into the STRIPED H2D wire form (zotpu_torch/io/wire.py v2):
// per row of L codes, W = L/16 code words and M = L/32 mask words;
// packed[w] bit 2j..2j+1 = code of base j*W + w (0 if invalid);
// mask[w] bit j = invalid flag of base j*M + w (code >= 4).
// L % 32 == 0. Inner loops run contiguously over w; a row's words live in
// L1, so the 16/32 passes per row are cheap.
void zotpu_pack_wire(const uint8_t* codes, int64_t rows, int64_t L,
                     uint32_t* packed, uint32_t* mask) {
    const int64_t W = L / 16, M = L / 32;
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* c = codes + r * L;
        uint32_t* p = packed + r * W;
        uint32_t* m = mask + r * M;
        for (int64_t w = 0; w < W; ++w) p[w] = 0;
        for (int64_t w = 0; w < M; ++w) m[w] = 0;
        for (int j = 0; j < 16; ++j) {
            const uint8_t* cj = c + j * W;
            for (int64_t w = 0; w < W; ++w) {
                const uint32_t v = cj[w];
                p[w] |= (v < 4 ? v : 0u) << (2 * j);
            }
        }
        for (int j = 0; j < 32; ++j) {
            const uint8_t* cj = c + j * M;
            for (int64_t w = 0; w < M; ++w)
                m[w] |= static_cast<uint32_t>(cj[w] >= 4) << j;
        }
    }
}

}  // extern "C"
