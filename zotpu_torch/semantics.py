"""Byte-level policy for zotpu k-mer sets.

A copy of zotpu/semantics.py; tests hold the two equal.

Every choice that affects output bytes lives HERE and nowhere else, so that a
future cross-check against the real reference (drtconway/zotmer, whose mount was
empty at build time -- see SURVEY.md section 0) changes exactly one module.

Policy (see SURVEY.md section 7 "Design tenets"):

- Base codes: A=0, C=1, G=2, T=3 (2-bit). Lower/upper case both accepted.
  Any other byte is INVALID and *resets* the k-mer window (reference analog:
  pykmer ``basics.kmers`` skips windows containing non-ACGT bases).
- A k-mer is packed big-endian in read order: the FIRST base of the k-mer
  occupies the MOST significant 2 bits. k=25 -> 50 bits; K_MAX=31 -> 62 bits,
  so every valid key < 2**62 and fits u64 with room for a sentinel.
- Reverse complement: complement each base (code XOR 3) and reverse base order.
- Canonical form: ``min(fwd, rc)`` as unsigned integers.
- Stored sort order: the packed canonical integer itself (identity hash).
  The *routing* hash used for sampling is a separate mixer (murmur64 finalizer)
  and never touches stored order, so output is shard-count invariant.
- Counts: uint32, saturating at 2**32 - 1.
- Sentinel key (padding in fixed-capacity device arrays): 2**64 - 1, which is
  unreachable for any valid k-mer because K_MAX == 31 keeps keys < 2**62.
- Shard ownership (multi-chip): the top ``p`` bits of the 2k-bit key space,
  i.e. ``owner = key >> (2k - p)``. Key-prefix sharding means concatenating the
  per-shard sorted runs yields a globally sorted array with no final merge.
- Set-op count policy: union/intersect keep ``countA + countB`` (saturating);
  difference A\\B keeps ``countA``. (The reference's merge sums counts; its
  intersect/diff count policy could not be verified -- reference mount empty.)
"""

from __future__ import annotations

import numpy as np

# --- base codes -------------------------------------------------------------

BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3
INVALID_CODE = 4  # any non-ACGT byte
K_MAX = 31        # 2*K_MAX = 62 bits < 64
COUNT_DTYPE = np.uint32
COUNT_MAX = np.uint32(0xFFFFFFFF)
KEY_DTYPE = np.uint64
SENTINEL_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)
SENTINEL_HI = np.uint32(0xFFFFFFFF)
SENTINEL_LO = np.uint32(0xFFFFFFFF)

# ASCII -> 2-bit code lookup table; 4 marks invalid.
ENCODE_LUT = np.full(256, INVALID_CODE, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3),
                   ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    ENCODE_LUT[ord(_ch)] = _code
DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def check_k(k: int) -> None:
    if not (1 <= k <= K_MAX):
        raise ValueError(f"k must be in [1, {K_MAX}], got {k}")


def key_bits(k: int) -> int:
    return 2 * k


def key_mask(k: int) -> np.uint64:
    """Mask of the low 2k bits (all valid key bits)."""
    return np.uint64((1 << (2 * k)) - 1)


# --- scalar/vector reference semantics (numpy u64) --------------------------

def rc_u64(k: int, x: np.ndarray) -> np.ndarray:
    """Reverse complement of packed k-mers (u64 array), per the policy above."""
    x = np.asarray(x, dtype=np.uint64)
    y = np.zeros_like(x)
    for _ in range(k):
        y = (y << np.uint64(2)) | ((x & np.uint64(3)) ^ np.uint64(3))
        x = x >> np.uint64(2)
    return y


def canonical_u64(k: int, x: np.ndarray) -> np.ndarray:
    r = rc_u64(k, x)
    return np.minimum(np.asarray(x, dtype=np.uint64), r)


def shard_of_u64(k: int, p_bits: int, key: np.ndarray) -> np.ndarray:
    """Owner shard = top p_bits of the 2k-bit key space."""
    shift = np.uint64(2 * k - p_bits)
    return (np.asarray(key, dtype=np.uint64) >> shift).astype(np.int64)


def split_hi_lo(key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    key = np.asarray(key, dtype=np.uint64)
    return (key >> np.uint64(32)).astype(np.uint32), (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def join_hi_lo(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


# --- routing/sampling hash (murmur64 finalizer) -----------------------------
# Used ONLY for `sample` (hash-threshold downsampling) and optional mixed-hash
# sharding; never for stored order. Reference analog: pykmer basics.murmer.

def routing_mix32(hi, lo):
    """32-bit avalanche over a two-word key for MIXED shard routing.

    Used ONLY to pick an owner shard when GC-content skew makes key-prefix
    sharding unbalanced (SURVEY.md section 7 "hard parts"); never stored,
    never affects output bytes (a key maps to exactly one shard either way,
    and mixed-mode gathers re-sort by key). Works on numpy and jnp u32
    arrays alike (multiplies wrap mod 2^32): a product combine followed by
    the murmur3 fmix32 finalizer."""
    c1, c2 = np.uint32(0x9E3779B1), np.uint32(0x85EBCA77)
    x = (hi * c1) ^ (lo * c2) ^ (lo >> np.uint32(16))
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def murmur_mix_u64(x: np.ndarray, seed: int = 0) -> np.ndarray:
    h = np.asarray(x, dtype=np.uint64) ^ np.uint64(seed)
    h ^= h >> np.uint64(33)
    h = h * np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    h = h * np.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> np.uint64(33)
    return h


# --- bit-trick utilities ----------------------------------------------------
# Reference analog: pykmer basics.ham/lcp and bits.popcnt (SURVEY.md section
# 2a "bit tricks"; unverified -- empty reference mount). Vectorized SWAR over
# u64 numpy arrays; host-side helpers (probe diagnostics, tests) -- the hot
# kernels never need them.

_M1 = np.uint64(0x5555555555555555)
_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)


def popcnt_u64(x: np.ndarray) -> np.ndarray:
    """Per-element set-bit count (SWAR)."""
    x = np.asarray(x, np.uint64)
    x = x - ((x >> np.uint64(1)) & _M1)
    x = (x & _M2) + ((x >> np.uint64(2)) & _M2)
    x = (x + (x >> np.uint64(4))) & _M4
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(
        np.int64)


def ham_u64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamming distance in BASES between equal-k packed k-mers: a 2-bit
    field differs iff either of its bits differs (fold XOR onto the low
    bit of each field, popcount)."""
    d = np.asarray(a, np.uint64) ^ np.asarray(b, np.uint64)
    return popcnt_u64((d | (d >> np.uint64(1))) & _M1)


def lcp_u64(k: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Longest common BASE prefix of two packed k-mers (big-endian packing:
    the first base is the top 2-bit field)."""
    check_k(k)
    d = np.asarray(a, np.uint64) ^ np.asarray(b, np.uint64)
    d = (d | (d >> np.uint64(1))) & _M1        # one marker bit per base
    nz = d != 0
    # highest set marker bit -> index of the first differing base
    top = np.zeros_like(d, dtype=np.int64)
    dd = d.copy()
    for s in (32, 16, 8, 4, 2, 1):
        m = dd >= (np.uint64(1) << np.uint64(s))
        top[m] += s
        dd[m] >>= np.uint64(s)
    first_diff = np.where(nz, k - 1 - (top >> 1), k)
    return first_diff.astype(np.int64)


def saturating_add_counts(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """u32 + u32 with saturation at COUNT_MAX (the count overflow policy)."""
    s = a.astype(np.uint64) + b.astype(np.uint64)
    return np.minimum(s, np.uint64(COUNT_MAX)).astype(COUNT_DTYPE)
