"""zotpu_torch sort + dedup-compact (K2) on the CPU vs the JAX package: the
Pallas dedup-compact kernel in interpret mode and the XLA dedup. Exact
equality over the dense prefix [:n] and n."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zotpu.kernels import dedup_pallas as DP
from zotpu.kernels import sortdedup as SD
from zotpu.kernels.sort_pallas import TILE_E
from zotpu_torch import keys as K
from zotpu_torch.kernels import sortdedup as TD

torch.set_num_threads(1)


def _sorted_with_dups(rng, n, n_valid, key_space):
    key = rng.integers(0, key_space, size=n).astype(np.uint64)
    key.sort()
    key[n_valid:] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return ((key >> np.uint64(32)).astype(np.uint32), key.astype(np.uint32))


def _dense_jax(hi, lo, cnt, n):
    n = int(np.asarray(n))
    keys, counts = K.from_hi_lo(np.asarray(hi)[:n], np.asarray(lo)[:n],
                                np.asarray(cnt)[:n])
    return keys, counts, n


def _check(got, want):
    n = int(got[2])
    assert n == want[2]
    assert torch.equal(got[0][:n], want[0])
    assert torch.equal(got[1][:n], want[1])
    assert torch.all(got[0][n:] == K.SENTINEL)
    assert torch.all(got[1][n:] == 0)


# the cases of tests/test_dedup_pallas.py
@pytest.mark.parametrize("ntiles,valid_frac,key_space", [
    (1, 1.0, 300),         # heavy duplication, full tile
    (2, 0.6, 1 << 20),     # sparse dup, sentinel tail inside tile 2
    (3, 0.0, 300),         # all-sentinel input -> n == 0
    (4, 1.0, 1 << 45),     # mostly unique, segments crossing tiles rarely
])
def test_dedup_compact_matches_jax(rng, ntiles, valid_frac, key_space):
    n = ntiles * TILE_E
    hi, lo = _sorted_with_dups(rng, n, int(n * valid_frac), key_space)
    got = TD.dedup_compact(K.from_hi_lo(hi, lo))
    _check(got, _dense_jax(*DP.dedup_compact_pallas(
        jnp.asarray(hi), jnp.asarray(lo), interpret=True)))
    _check(got, _dense_jax(*SD.dedup_count_sorted(jnp.asarray(hi),
                                                  jnp.asarray(lo))))


def test_dedup_compact_single_segment_spanning_tiles():
    n = 2 * TILE_E
    n_valid = n - 100
    keys = torch.full((n,), 7, dtype=torch.int64)
    keys[n_valid:] = K.SENTINEL
    uk, c, nu = TD.dedup_compact(keys)
    assert int(nu) == 1 and int(uk[0]) == 7 and int(c[0]) == n_valid


@pytest.mark.parametrize("n", [1, 2, 17])
def test_dedup_compact_small_and_empty(n):
    keys = torch.arange(n, dtype=torch.int64) // 2
    uk, c, nu = TD.dedup_compact(keys)
    assert int(nu) == (n + 1) // 2
    assert int(c[:int(nu)].sum()) == n
    uk, c, nu = TD.dedup_compact(torch.empty(0, dtype=torch.int64))
    assert int(nu) == 0 and uk.shape == (0,)


def test_kmer_sort_dedup_matches_jax(rng):
    """Unsorted pack output with sentinel windows -> the XLA sort+dedup."""
    n = 5000
    key = rng.integers(0, 700, size=n).astype(np.uint64)
    key[rng.random(n) < 0.2] = np.uint64(0xFFFFFFFFFFFFFFFF)
    hi = (key >> np.uint64(32)).astype(np.uint32)
    lo = key.astype(np.uint32)
    got = TD.kmer_sort_dedup(K.from_hi_lo(hi, lo))
    want = SD.kmer_sort_dedup(jnp.asarray(hi), jnp.asarray(lo),
                              jnp.ones(n, jnp.uint32), compact=True)
    _check(got, _dense_jax(*want))


def test_dedup_rejects_bad_inputs():
    with pytest.raises(ValueError):
        TD.dedup_compact(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        TD.dedup_compact(torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        TD.dedup_compact(torch.zeros(8, dtype=torch.int64)[::2])
