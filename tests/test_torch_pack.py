"""zotpu_torch pack (K1) on the CPU vs the JAX package: the Pallas kernels
in interpret mode and the XLA pack. Keys are integers: equality is exact."""

import numpy as np
import pytest
import torch

from zotpu.io import wire
from zotpu.kernels import pack as PX
from zotpu.kernels import pack_pallas as PP
from zotpu_torch import keys as K
from zotpu_torch.kernels import edge_cases as EC
from zotpu_torch.kernels import pack as TP

torch.set_num_threads(1)


def _batch(rng, R, L, k):
    """R rows (not a multiple of 64) with ragged lengths, including 0 and
    shorter than k, and N bases at row start, middle and end."""
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, size=R).astype(np.int32)
    lengths[0], lengths[1], lengths[2] = 0, max(k - 1, 0), L
    codes[3, 0] = 4
    codes[4, L // 2] = 4
    codes[5, L - 1] = 4
    codes[6, :: max(k // 2, 2)] = 4
    codes[rng.random((R, L)) < 0.002] = 4
    for r in range(R):
        codes[r, lengths[r]:] = 4          # padding past the read, as parsed
    return codes, lengths


def _jax_keys(hi, lo):
    return K.from_hi_lo(np.asarray(hi), np.asarray(lo))


@pytest.mark.parametrize("L", [32, 160, 256])
@pytest.mark.parametrize("k", [1, 15, 16, 17, 25, 31])
def test_pack_u8_matches_jax(k, L):
    rng = np.random.default_rng(k * 1000 + L)
    codes, lengths = _batch(rng, 71, L, k)
    got = TP.pack_canonical(torch.from_numpy(codes), torch.from_numpy(lengths),
                            k)
    assert got.shape == (71 * (L - k + 1),)
    hi, lo, _ = PP.pack_canonical_pallas(codes, lengths, k, interpret=True)
    assert torch.equal(got, _jax_keys(hi, lo))
    hi, lo, _ = PX.pack_canonical(codes, lengths, k)
    assert torch.equal(got, _jax_keys(hi, lo))


@pytest.mark.parametrize("L", [32, 160, 256])
@pytest.mark.parametrize("k", [1, 15, 16, 17, 25, 31])
def test_pack_wire_matches_jax(k, L):
    rng = np.random.default_rng(k * 1000 + L + 1)
    codes, lengths = _batch(rng, 71, L, k)
    packed, mask = wire.pack_codes(codes)
    got = TP.pack_canonical_wire(torch.from_numpy(packed),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(lengths), k)
    hi, lo, _ = PP.pack_canonical_wire_pallas(packed, mask, lengths, k,
                                              interpret=True)
    assert torch.equal(got, _jax_keys(hi, lo))
    # the wire form and the u8 form give the same keys
    assert torch.equal(got, TP.pack_canonical(torch.from_numpy(codes),
                                              torch.from_numpy(lengths), k))


def test_unpack_wire_plain_inverts_pack_codes(rng):
    codes = rng.integers(0, 5, size=(9, 96)).astype(np.uint8)
    packed, mask = wire.pack_codes(codes)
    got = TP.unpack_wire_plain(torch.from_numpy(packed),
                               torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), codes)


@pytest.mark.parametrize("bad", [
    dict(codes_dtype=torch.int32),
    dict(lengths_dtype=torch.int64),
    dict(k=40),
    dict(L=16),            # k = 25 > L
    dict(transpose=True),
])
def test_pack_rejects_bad_inputs(bad):
    L = bad.get("L", 32)
    codes = torch.zeros((4, L), dtype=bad.get("codes_dtype", torch.uint8))
    lengths = torch.full((4,), L, dtype=bad.get("lengths_dtype", torch.int32))
    if bad.get("transpose"):
        codes = torch.zeros((32, 4), dtype=torch.uint8).t()
    with pytest.raises(ValueError):
        TP.pack_canonical(codes, lengths, bad.get("k", 25))


def test_pack_wire_rejects_mismatched_mask():
    packed = torch.zeros((4, 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        TP.pack_canonical_wire(packed, torch.zeros((4, 4), dtype=torch.int32),
                               torch.zeros(4, dtype=torch.int32), 25)


def test_cpu_calls_do_not_count_launches(rng):
    before = TP.pack_canonical.launches
    codes, lengths = _batch(rng, 8, 32, 5)
    TP.pack_canonical(torch.from_numpy(codes), torch.from_numpy(lengths), 5)
    assert TP.pack_canonical.launches == before


# the shapes the CUDA kernel can get wrong (zotpu_torch/kernels/edge_cases.py;
# the card's tests and chip_smoke.py run the same list against the kernel):
# plain versions vs the JAX package, exact
_EDGE = EC.pack_cases(seed=0)


@pytest.mark.parametrize("case", range(len(_EDGE)),
                         ids=[c[0] for c in _EDGE])
def test_pack_edge_cases_match_jax(case):
    _, codes, lengths, k = _EDGE[case]
    R, L = codes.shape
    want = _jax_keys(*PX.pack_canonical(codes, lengths, k)[:2])
    got = TP.pack_canonical(torch.from_numpy(codes),
                            torch.from_numpy(lengths), k)
    assert got.shape == (R * (L - k + 1),)
    assert torch.equal(got, want)
    packed, mask = wire.pack_codes(codes)
    assert torch.equal(TP.pack_canonical_wire(
        torch.from_numpy(packed), torch.from_numpy(mask),
        torch.from_numpy(lengths), k), want)
    if L <= 160:        # interpret-mode Pallas costs seconds at L = 4096
        hi, lo, _ = PP.pack_canonical_wire_pallas(packed, mask, lengths, k,
                                                  interpret=True)
        assert torch.equal(got, _jax_keys(hi, lo))
    # all-T and all-A rows: T...T canonicalizes to A...A = 0
    m = L - k + 1
    assert torch.all(got[7 * m:9 * m] == 0)
