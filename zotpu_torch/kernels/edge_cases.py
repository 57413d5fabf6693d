"""Edge shapes that the set-op kernel (K3), the pack kernel (K1) and the
receive-tree kernels (K5, K6, K7) can get wrong, as seeded numpy inputs.

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
# the tile of K5-K7 (csrc/merge_runs.cu: MR_THREADS * MR_ITEMS) and the
# items a thread merges
MR_TILE = 2048
MR_ITEMS = 8


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


def _run(keys, cap=None):
    """An ascending int64 run: the sorted keys, then a SENTINEL tail up to
    ``cap``."""
    keys = np.sort(np.asarray(keys, np.int64))
    out = np.full(len(keys) if cap is None else cap, SENTINEL, np.int64)
    out[:len(keys)] = keys
    return out


def _pair_cases(rng, tile):
    """[(name, A, B)]: two ascending int64 runs with SENTINEL tails, as one
    pair of the receive tree holds them. Both sides hold duplicates."""
    def rand(n, space=1 << 50, cap=None):
        return _run(rng.integers(0, space, n), cap)

    n = 2 * tile + 37                # no multiple of the tile or of 8
    cases = [
        ("shorter_than_a_tile", rand(5, 7), rand(9, 7)),
        ("ragged_lengths", rand(n, n // 2), rand(tile - 11, n // 2)),
        ("a_empty", rand(0), rand(n, n)),
        ("b_empty", rand(n, n, n + 5), rand(0)),
        ("b_all_sentinels", rand(n - 9, n, n), rand(0, cap=tile + 5)),
        ("a_wholly_below_b", rand(n, 1 << 20),
         rand(n - 7, 1 << 20) + (1 << 30)),
        ("a_wholly_above_b", rand(n, 1 << 20) + (1 << 30),
         rand(n - 7, 1 << 20)),
    ]
    # merged order 0, (1, 1), (2, 2), ...: the members of an equal pair sit
    # at positions 2i - 1 and 2i, so A's and B's copies of a key straddle
    # every even boundary: every tile's and every thread's
    ramp = np.arange(1, n + 1, dtype=np.int64)
    cases.append(("ties_straddle_every_boundary",
                  np.concatenate([[0], ramp]), ramp))
    # segments of 3 + 3 equal keys, offset by one element, so that they cut
    # the threads' and the tiles' boundaries at every phase
    six = np.arange(n, dtype=np.int64) // 3
    cases.append(("ties_of_six", _run(np.concatenate([[0], six + 1]), n + 8),
                  _run(six + 1, n + 3)))
    # one key over more than three tiles, smaller keys before it on one
    # side and larger ones after it on the other
    cases.append(("one_key_over_many_tiles",
                  _run(np.concatenate([rng.integers(0, 50, tile // 2),
                                       np.full(2 * tile + 5, 77)]), 3 * tile),
                  _run(np.concatenate([np.full(2 * tile - 3, 77),
                                       rng.integers(78, 99, tile // 3)]))))
    # the valid prefix of the merge ends exactly on a tile boundary
    cases.append(("valid_prefix_ends_on_a_tile_boundary",
                  rand(tile + MR_ITEMS, tile, 2 * tile),
                  rand(tile - MR_ITEMS, tile, tile + 3)))
    cases.append(("all_sentinels", rand(0, cap=tile + 1), rand(0, cap=tile)))
    return cases


def merge_runs_cases(seed: int = 0, tile: int = MR_TILE):
    """[(name, keys, payload, kind, arg)] for K5 (drop the payload) and K7:
    ``kind`` "pass" is ``merge_runs_pass(keys, payload, run=arg)`` and
    "pair" is ``merge_runs_pair(keys, payload, nA=arg)``. The payloads are
    distinct, so a wrong order within an equal-key segment shows."""
    rng = np.random.default_rng([seed, 5])
    cases = [(name, np.concatenate([a, b]), "pair", len(a))
             for name, a, b in _pair_cases(rng, tile)]

    def runs(n_runs, run, space, frac=1.0):
        return np.concatenate([
            _run(rng.integers(0, space, int(rng.integers(0, run + 1) * frac)
                              if frac < 1 else run), run)
            for _ in range(n_runs)])

    cases += [
        ("many_pairs_of_run_1", runs(2 * (tile // 8 + 3), 1, 3), "pass", 1),
        ("many_pairs_of_run_5", runs(2 * (tile // 8 + 3), 5, 4, 0.8),
         "pass", 5),
        ("pass_run_no_multiple_of_8", runs(4, tile + 37, tile, 0.9), "pass",
         tile + 37),
        ("pass_second_pair_all_sentinels",
         np.concatenate([runs(2, tile + 4, 9), runs(2, tile + 4, 9, 0.0)]),
         "pass", tile + 4),
    ]
    return [(name, keys, np.arange(len(keys), dtype=np.int64) * 7 + 3, kind,
             arg) for name, keys, kind, arg in cases]


def merge_dedup_cases(seed: int = 0, tile: int = MR_TILE):
    """[(name, keys, nA)] for K6: one pair, A = keys[:nA] and B = keys[nA:],
    duplicates on both sides."""
    rng = np.random.default_rng([seed, 6])
    return [(name, np.concatenate([a, b]), len(a))
            for name, a, b in _pair_cases(rng, tile)]
