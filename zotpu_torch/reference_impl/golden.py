"""Golden CPU reference implementation (pure numpy).

A copy of zotpu/reference_impl/golden.py. This module is the stand-in for
the reference (drtconway/zotmer), whose sources were not at hand (SURVEY.md
section 0): small, slow, obviously correct. Every device kernel asserts byte
equality against these functions.

Reference analogs (expected locations in the real repo, unverified):
- ``encode``/``kmerize_seq``  ~ zotmer/library/basics.py ``kmers(k, seq)``
- ``rc``/``canonical``        ~ basics.rc / basics.can
- ``kmerize``                 ~ zotmer/commands/kmerize.py (sort+dedup+count)
- ``merge``                   ~ zotmer/commands/merge.py (k-way count-summing)
- ``union/intersect/diff``    ~ zotmer set-algebra commands (two-pointer sweep)
- ``spectrum``                ~ zotmer/commands/hist.py
- ``scan_panel``              ~ zotmer/commands/scan.py (binary-search pulldown)
"""

from __future__ import annotations

import numpy as np

from zotpu_torch import semantics as S


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> u8 codes (0..3, 4=invalid)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return S.ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_kmer(k: int, key: int) -> str:
    """Packed k-mer -> ACGT string (first base = most significant 2 bits)."""
    out = bytearray()
    for i in range(k - 1, -1, -1):
        out.append(S.DECODE_LUT[(int(key) >> (2 * i)) & 3])
    return out.decode("ascii")


def kmerize_seq(k: int, seq: str | bytes | np.ndarray) -> np.ndarray:
    """All canonical k-mers of one sequence (u64, in read order, duplicates kept).

    Windows containing a non-ACGT base are skipped, matching the reference's
    window-reset semantics.
    """
    S.check_k(k)
    codes = seq if isinstance(seq, np.ndarray) else encode(seq)
    n = len(codes)
    if n < k:
        return np.empty(0, dtype=np.uint64)
    m = n - k + 1
    fwd = np.zeros(m, dtype=np.uint64)
    valid = np.ones(m, dtype=bool)
    for j in range(k):
        c = codes[j:j + m].astype(np.uint64)
        fwd = (fwd << np.uint64(2)) | (c & np.uint64(3))
        valid &= c < 4
    return S.canonical_u64(k, fwd[valid])


def sort_dedup(keys: np.ndarray, weights: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Sorted unique keys + summed (saturating) u32 counts."""
    keys = np.asarray(keys, dtype=np.uint64)
    if weights is None:
        weights = np.ones(len(keys), dtype=np.uint64)
    else:
        weights = np.asarray(weights, dtype=np.uint64)
    order = np.argsort(keys, kind="stable")
    ks, ws = keys[order], weights[order]
    if len(ks) == 0:
        return ks, np.empty(0, dtype=S.COUNT_DTYPE)
    first = np.ones(len(ks), dtype=bool)
    first[1:] = ks[1:] != ks[:-1]
    uniq = ks[first]
    seg = np.cumsum(first) - 1
    counts = np.zeros(len(uniq), dtype=np.uint64)
    np.add.at(counts, seg, ws)
    counts = np.minimum(counts, np.uint64(S.COUNT_MAX)).astype(S.COUNT_DTYPE)
    return uniq, counts


def kmerize(k: int, seqs: list) -> tuple[np.ndarray, np.ndarray]:
    """FASTQ-batch kmerize: sorted unique canonical k-mers + counts."""
    parts = [kmerize_seq(k, s) for s in seqs]
    allk = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)
    return sort_dedup(allk)


def merge(sets: list[tuple[np.ndarray, np.ndarray]]) -> tuple[np.ndarray, np.ndarray]:
    """N-way merge of sorted (keys, counts) sets, summing counts on ties."""
    keys = np.concatenate([s[0] for s in sets]) if sets else np.empty(0, np.uint64)
    cnts = np.concatenate([s[1] for s in sets]) if sets else np.empty(0, np.uint32)
    return sort_dedup(keys, cnts)


def _setop(a, b, keep):
    ka, ca = np.asarray(a[0], np.uint64), np.asarray(a[1], np.uint64)
    kb, cb = np.asarray(b[0], np.uint64), np.asarray(b[1], np.uint64)
    allk = np.union1d(ka, kb)
    in_a = np.isin(allk, ka)
    in_b = np.isin(allk, kb)
    cnt_a = np.zeros(len(allk), dtype=np.uint64)
    cnt_a[np.searchsorted(allk, ka)] = ca
    cnt_b = np.zeros(len(allk), dtype=np.uint64)
    cnt_b[np.searchsorted(allk, kb)] = cb
    mask = keep(in_a, in_b)
    counts = np.minimum(cnt_a[mask] + cnt_b[mask], np.uint64(S.COUNT_MAX))
    return allk[mask], counts.astype(S.COUNT_DTYPE)


def union(a, b):
    return _setop(a, b, lambda ia, ib: ia | ib)


def intersect(a, b):
    return _setop(a, b, lambda ia, ib: ia & ib)


def difference(a, b):
    """A \\ B; counts from A only."""
    ka, ca = np.asarray(a[0], np.uint64), a[1]
    mask = ~np.isin(ka, np.asarray(b[0], np.uint64))
    return ka[mask], np.asarray(ca, S.COUNT_DTYPE)[mask]


def spectrum(counts: np.ndarray, max_count: int = 1024) -> np.ndarray:
    """Count-of-counts table; bin ``max_count`` accumulates the tail."""
    c = np.minimum(np.asarray(counts, np.int64), max_count)
    return np.bincount(c, minlength=max_count + 1).astype(np.int64)


def error_peak_cutoff(hist: np.ndarray) -> int:
    """First local minimum of the spectrum after the low-frequency error peak.

    Returns the frequency at the valley between the sequencing-error peak
    (freq ~1..3) and the genomic coverage peak; 1 if no valley is found.
    """
    h = np.asarray(hist, dtype=np.int64)
    for f in range(2, len(h) - 1):
        if h[f] <= h[f - 1] and h[f] < h[f + 1]:
            return f
    return 1


def scan_panel(k: int, panel_keys: np.ndarray, seqs: list) -> np.ndarray:
    """Per-sequence hit counts against a sorted canonical k-mer panel."""
    panel = np.asarray(panel_keys, dtype=np.uint64)
    out = np.zeros(len(seqs), dtype=np.int64)
    for i, s in enumerate(seqs):
        kmers = kmerize_seq(k, s)
        if len(kmers) == 0:
            continue
        if len(panel) == 0:
            continue
        idx = np.minimum(np.searchsorted(panel, kmers), len(panel) - 1)
        out[i] = int(np.sum(panel[idx] == kmers))
    return out


def sample(keys: np.ndarray, counts: np.ndarray, rate: float, seed: int = 0):
    """Deterministic hash-threshold downsampling (minhash-like).

    Keeps k-mers whose murmur-mixed hash falls below ``rate`` of the u64 space.
    Reference analog: zot sample (hash-based sampling).
    """
    rate = min(max(float(rate), 0.0), 1.0)
    thresh = np.uint64(min(int(rate * float(2**64 - 1)), 2**64 - 1))
    h = S.murmur_mix_u64(np.asarray(keys, np.uint64), seed)
    mask = h <= thresh
    return np.asarray(keys, np.uint64)[mask], np.asarray(counts, S.COUNT_DTYPE)[mask]
