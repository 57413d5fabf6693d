"""Edge shapes that the set-op kernel (K3) and the pack kernel (K1) can get
wrong, as seeded numpy inputs.

One list serves three checks: the CPU tests hold the plain versions against
the JAX package on these inputs, and the card's tests and ``chip_smoke.py``
hold the CUDA kernels against the plain versions on the same inputs.
"""

from __future__ import annotations

import numpy as np

from zotpu_torch import semantics as S
from zotpu_torch.keys import COUNT_MAX, SENTINEL

# the tile of K3 (csrc/merge.cu: K3_THREADS * K3_ITEMS)
K3_TILE = 2048


def _side(keys, counts, cap):
    """A dense sorted unique side: int64 keys with a SENTINEL tail, int64
    counts with a zero tail, and the valid length."""
    keys = np.asarray(keys, np.int64)
    k = np.full(cap, SENTINEL, np.int64)
    c = np.zeros(cap, np.int64)
    k[:len(keys)] = keys
    c[:len(keys)] = counts
    return k, c, len(keys)


def set_op_cases(seed: int = 0, tile: int = K3_TILE):
    """[(name, (ka, ca, n_a), (kb, cb, n_b))]: two dense sides each, for
    every op. ``tile`` scales the sizes, so that every case with a boundary
    spans several tiles."""
    rng = np.random.default_rng([seed, 3])

    def rand(n, lo=0, hi=1 << 50):
        keys = np.unique(rng.integers(lo, hi, n))
        return keys, rng.integers(1, 1000, len(keys))

    def dense(keys_counts, cap=None):
        keys, counts = keys_counts
        return _side(keys, counts, len(keys) if cap is None else cap)

    n = 3 * tile + 5
    cases = []
    a, b = rand(n), rand(2 * tile - 3)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    cases.append(("a_empty", dense(empty, 8), dense(b, 2 * tile)))
    cases.append(("b_empty", dense(a, n + 9), dense(empty, 8)))
    cases.append(("both_empty", dense(empty, tile), dense(empty, 3)))
    cases.append(("ragged_sizes", dense(a), dense(b)))
    # overlapping random sets: about a third of B's keys are A's
    mixed = np.unique(np.concatenate([b[0][::2], a[0][::3]]))
    cases.append(("overlap", dense(a, n + 100),
                  dense((mixed, rng.integers(1, 1000, len(mixed))),
                        len(mixed) + 1)))
    same = rand(n)
    cases.append(("all_keys_equal_across_sides", dense(same, n + 1),
                  dense((same[0], rng.integers(1, 1000, len(same[0]))), n)))
    low, high = rand(n, 0, 1 << 40), rand(n - 7, 1 << 41, 1 << 42)
    cases.append(("a_wholly_before_b", dense(low), dense(high)))
    cases.append(("a_wholly_after_b", dense(high), dense(low)))
    # merged order 0, (1, 1), (2, 2), ...: the members of an equal pair sit
    # at positions 2i - 1 and 2i, so a pair straddles every even boundary:
    # every tile's and every thread's
    pair = np.arange(1, n + 1, dtype=np.int64)
    cases.append(("pair_straddles_every_boundary",
                  _side(np.concatenate([[0], pair]),
                        rng.integers(1, 1000, n + 1), n + 1),
                  _side(pair, rng.integers(1, 1000, n), n + 3)))
    sat_keys = np.arange(0, 2 * tile + 2, dtype=np.int64) * 3
    cases.append(("saturating_counts",
                  _side(sat_keys, rng.integers(COUNT_MAX - 5, COUNT_MAX + 1,
                                               len(sat_keys)),
                        len(sat_keys)),
                  _side(sat_keys[::2], rng.integers(1, 9, len(sat_keys[::2])),
                        len(sat_keys))))
    cases.append(("capacity_far_above_valid", dense(rand(100), 16 * tile),
                  dense(rand(tile + 1), 32 * tile)))
    return cases


def pack_cases(seed: int = 0):
    """[(name, codes (R, L) u8, lengths (R,) int32, k)] for k in 1, 25, 31
    and L in 32, 160, 4096: lengths 0, below k, k and L; an N at the first
    and last base and at both sides of every 32-base word boundary; all-T
    and all-A rows; random rows with scattered N."""
    rng = np.random.default_rng([seed, 1])
    cases = []
    for L in (32, 160, 4096):
        for k in (1, 25, 31):
            codes = rng.integers(0, 4, size=(12, L)).astype(np.uint8)
            lengths = np.full(12, L, np.int32)
            lengths[0], lengths[1], lengths[2] = 0, k - 1, k
            codes[3, 0] = S.INVALID_CODE
            codes[4, L - 1] = S.INVALID_CODE
            codes[5, 31::32] = S.INVALID_CODE       # last base of each word
            codes[6, 32::32] = S.INVALID_CODE       # first base of each word
            codes[7] = 3                            # all T
            codes[8] = 0                            # all A
            codes[9, rng.random(L) < 0.02] = S.INVALID_CODE
            lengths[10] = int(rng.integers(k, L + 1))
            for r in range(12):
                codes[r, lengths[r]:] = S.INVALID_CODE   # padding, as parsed
            cases.append((f"L{L}_k{k}", codes, lengths, k))
    return cases
