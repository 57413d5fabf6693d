"""zotpu_torch fused set-op (K3) on the CPU vs the JAX package: the Pallas
set_op_fused in interpret mode, the sort-based setops.set_op and golden.
Exact equality over the dense prefix [:n] and n."""

import numpy as np
import pytest
import torch

from zotpu import semantics as S
from zotpu.kernels import setops as XS
from zotpu.kernels.merge_fused import set_op_fused as jax_set_op_fused
from zotpu.reference_impl import golden as G
from zotpu_torch import keys as K
from zotpu_torch.kernels import merge_fused as TM

torch.set_num_threads(1)


def _dense(keys, counts, cap):
    hi = np.full(cap, 0xFFFFFFFF, np.uint32)
    lo = np.full(cap, 0xFFFFFFFF, np.uint32)
    c = np.zeros(cap, np.uint32)
    hi[:len(keys)], lo[:len(keys)] = S.split_hi_lo(np.asarray(keys, np.uint64))
    c[:len(keys)] = counts
    return hi, lo, c


def _rand_set(rng, n, key_space=1 << 50):
    keys = np.unique(rng.integers(0, key_space, n).astype(np.uint64))
    counts = rng.integers(1, 1000, len(keys)).astype(np.uint32)
    return keys, counts


def _empty():
    return np.empty(0, np.uint64), np.empty(0, np.uint32)


def _torch_side(d):
    return K.from_hi_lo(d[0], d[1], d[2])


def _check(got, want):
    """got: port (keys, counts, n); want: JAX (hi, lo, c, n)."""
    n = int(np.asarray(want[3]))
    assert int(got[2]) == n
    wk, wc = K.from_hi_lo(np.asarray(want[0])[:n], np.asarray(want[1])[:n],
                          np.asarray(want[2])[:n])
    assert torch.equal(got[0][:n], wk)
    assert torch.equal(got[1][:n], wc)
    assert torch.all(got[0][n:] == K.SENTINEL)
    assert torch.all(got[1][n:] == 0)


def _port(A, B, op, n_a=None, n_b=None):
    ka, ca = _torch_side(A)
    kb, cb = _torch_side(B)
    kw = {}
    if n_a is not None:
        kw = dict(n_a=torch.tensor(n_a), n_b=torch.tensor(n_b))
    return TM.set_op_fused(ka, ca, kb, cb, op=op, **kw)


# the size grid of tests/test_merge_fused.py
@pytest.mark.parametrize("op", ["merge", "union", "intersect", "diff"])
@pytest.mark.parametrize("na,nb,cap_a,cap_b", [
    (500, 300, 1024, 512),          # sub-tile sizes and capacities
    (0, 700, 8, 1024),              # one side empty
    (1, 1, 8, 8),                   # tiny
    (40000, 50000, 65536, 65536),   # multi-tile with tile-straddling keys
])
def test_set_op_matches_jax(op, na, nb, cap_a, cap_b):
    rng = np.random.default_rng(na * 7 + nb + len(op))
    ka, ca = _rand_set(rng, na) if na else _empty()
    kb, cb = _rand_set(rng, nb) if nb else _empty()
    if na and nb:       # overlap, so intersect/diff and straddles happen
        kb = np.unique(np.concatenate([kb[: nb // 2], ka[: na // 3]]))
        cb = rng.integers(1, 1000, len(kb)).astype(np.uint32)
    A = _dense(ka, ca, cap_a)
    B = _dense(kb, cb, cap_b)
    got = _port(A, B, op)
    _check(got, XS.set_op(*A, *B, op=op))
    if na == 500:       # interpret-mode Pallas costs seconds a call
        _check(got, jax_set_op_fused(*A, *B, op=op, interpret=True))
    # valid counts given: identical output, capacities included
    gated = _port(A, B, op, len(ka), len(kb))
    for g, h in zip(got, gated):
        assert torch.equal(g, h)


def test_set_op_multi_tile_matches_pallas():
    """The multi-tile merge case against the Pallas kernel itself."""
    rng = np.random.default_rng(40000 * 7 + 50000 + 5)
    ka, ca = _rand_set(rng, 40000)
    kb, cb = _rand_set(rng, 50000)
    kb = np.unique(np.concatenate([kb[:25000], ka[:13333]]))
    cb = rng.integers(1, 1000, len(kb)).astype(np.uint32)
    A = _dense(ka, ca, 65536)
    B = _dense(kb, cb, 65536)
    _check(_port(A, B, "merge"),
           jax_set_op_fused(*A, *B, op="merge", interpret=True))


def test_set_op_matches_golden_merge():
    rng = np.random.default_rng(0)
    ka, ca = _rand_set(rng, 3000)
    kb, cb = _rand_set(rng, 1500)
    keys, counts, n = _port(_dense(ka, ca, 4096), _dense(kb, cb, 2048),
                            "merge")
    got_k, got_c = K.to_numpy_set(keys, counts, n)
    want_k, want_c = G.merge([(ka, ca), (kb, cb)])
    assert np.array_equal(got_k, want_k)
    assert np.array_equal(got_c, want_c)


def test_set_op_count_saturation():
    k = np.array([5], np.uint64)
    A = _dense(k, np.array([0xFFFFFFF0], np.uint32), 8)
    B = _dense(k, np.array([0x20], np.uint32), 8)
    for op in ("merge", "intersect"):
        _, c, n = _port(A, B, op)
        assert int(n) == 1 and int(c[0]) == 0xFFFFFFFF
        _check(_port(A, B, op), XS.set_op(*A, *B, op=op))


@pytest.mark.parametrize("op", ["merge", "intersect", "diff"])
def test_set_op_identical_sides(op):
    """A == B: every key is a 2-member segment."""
    rng = np.random.default_rng(7)
    ka, ca = _rand_set(rng, 5000)
    A = _dense(ka, ca, 8192)
    _check(_port(A, A, op), XS.set_op(*A, *A, op=op))


@pytest.mark.parametrize("na,nb,cap_a,cap_b", [
    (100, 200, 1024, 4096),     # both sides mostly padding
    (0, 50, 64, 64),            # one side empty
    (0, 0, 64, 64),             # both empty: n_out == 0
    (0, 0, 0, 0),               # zero-length inputs
])
def test_set_op_valid_counts_gate(na, nb, cap_a, cap_b):
    rng = np.random.default_rng(11)
    ka, ca = _rand_set(rng, na) if na else _empty()
    kb, cb = _rand_set(rng, nb) if nb else _empty()
    A = _dense(ka, ca, cap_a)
    B = _dense(kb, cb, cap_b)
    for op in ("merge", "intersect", "diff"):
        r0 = _port(A, B, op)
        r1 = _port(A, B, op, len(ka), len(kb))
        for g, h in zip(r0, r1):
            assert torch.equal(g, h)
        assert r0[0].shape == (cap_a + cap_b,)
        _check(r0, XS.set_op(*A, *B, op=op))


def test_set_op_rejects_bad_inputs():
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        TM.set_op_fused(z, z, z, z, op="xor")
    with pytest.raises(ValueError):
        TM.set_op_fused(z, z[:3], z, z)
    with pytest.raises(ValueError):
        TM.set_op_fused(z.to(torch.int32), z, z, z)
    with pytest.raises(ValueError):
        TM.set_op_fused(z, z, z, z, n_a=3, n_b=3)


def test_intersect_zero_count_follows_set_op_fused():
    """A key present on both sides with count 0 on one side: set_op_fused
    keeps it for intersect (membership by segment size), setops.set_op
    drops it (membership by count > 0). The port follows set_op_fused."""
    A = _dense(np.array([5, 7], np.uint64), np.array([0, 2], np.uint32), 8)
    B = _dense(np.array([5], np.uint64), np.array([3], np.uint32), 8)
    got = _port(A, B, "intersect")
    _check(got, jax_set_op_fused(*A, *B, op="intersect", interpret=True))
    assert int(got[2]) == 1 and int(XS.set_op(*A, *B, op="intersect")[3]) == 0
