"""zotpu_torch DeviceAccumulator on the CPU vs the JAX package's
DeviceAccumulator on JAX-CPU and vs golden.merge, including CapacityError
parity just below and at the final unique count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zotpu import semantics as S
from zotpu.reference_impl import golden as G
from zotpu.workloads import accumulator as JA
from zotpu_torch import keys as K
from zotpu_torch.kernels.merge_fused import set_op_fused
from zotpu_torch.workloads import accumulator as TA

torch.set_num_threads(1)

CAP = 512


def _runs(seed, n_runs):
    """n_runs dense sorted unique runs of capacity CAP over a shared key
    space, so keys recur across runs and counts add."""
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(n_runs):
        keys = np.unique(rng.integers(0, 3000, int(rng.integers(1, CAP + 1)))
                         .astype(np.uint64))
        counts = rng.integers(1, 50, len(keys)).astype(np.uint32)
        runs.append((keys, counts))
    return runs


def _dense_hi_lo(keys, counts):
    hi = np.full(CAP, 0xFFFFFFFF, np.uint32)
    lo = np.full(CAP, 0xFFFFFFFF, np.uint32)
    c = np.zeros(CAP, np.uint32)
    hi[:len(keys)], lo[:len(keys)] = S.split_hi_lo(keys)
    c[:len(keys)] = counts
    return hi, lo, c


def _port(runs, max_cap=1 << 26):
    acc = TA.DeviceAccumulator(CAP, max_cap=max_cap, device="cpu")
    for keys, counts in runs:
        k, c = K.from_hi_lo(*_dense_hi_lo(keys, counts))
        acc.add(k, c, torch.tensor(len(keys)))
    return acc.result()


def _jax(runs, max_cap=1 << 26):
    acc = JA.DeviceAccumulator(CAP, max_cap=max_cap)
    for keys, counts in runs:
        hi, lo, c = _dense_hi_lo(keys, counts)
        acc.add(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(c),
                jnp.int32(len(keys)), dense=True)
    return acc.result()


@pytest.mark.parametrize("n_runs", [1, 5, 6, 9])
def test_accumulator_matches_jax_and_golden(n_runs):
    runs = _runs(n_runs, n_runs)
    got_k, got_c = _port(runs)
    want_k, want_c = G.merge(runs)
    assert np.array_equal(got_k, want_k)
    assert np.array_equal(got_c, want_c)
    jk, jc = _jax(runs)
    assert np.array_equal(got_k, jk)
    assert np.array_equal(got_c, jc)


def test_capacity_error_parity():
    runs = _runs(3, 7)
    n_unique = len(G.merge(runs)[0])
    assert n_unique > CAP
    for cap, raises in ((n_unique - 1, True), (n_unique, False)):
        for fn, err in ((_port, TA.CapacityError), (_jax, JA.CapacityError)):
            if raises:
                with pytest.raises(err):
                    fn(runs, max_cap=cap)
            else:
                assert len(fn(runs, max_cap=cap)[0]) == n_unique


def test_accumulator_pads_short_runs_and_rejects_long_ones():
    acc = TA.DeviceAccumulator(8, device="cpu")
    acc.add(torch.tensor([3, 5]), torch.tensor([1, 2]), torch.tensor(2))
    acc.add(torch.tensor([5, 9, K.SENTINEL]), torch.tensor([4, 1, 0]),
            torch.tensor(2))
    keys, counts = acc.result()
    assert keys.tolist() == [3, 5, 9] and counts.tolist() == [1, 6, 1]
    with pytest.raises(ValueError):
        acc.add(torch.zeros(9, dtype=torch.int64),
                torch.zeros(9, dtype=torch.int64), torch.tensor(9))


def test_accumulator_empty_result():
    keys, counts = TA.DeviceAccumulator(8, device="cpu").result()
    assert keys.dtype == np.uint64 and counts.dtype == np.uint32
    assert len(keys) == 0 and len(counts) == 0


def test_merge_truncates_only_at_the_clamp():
    """Below max_cap a merge keeps len(A) + len(B); at the clamp it is cut
    to max_cap (a view) and overflow counts what was lost."""
    acc = TA.DeviceAccumulator(4, max_cap=6, device="cpu")
    a = (torch.tensor([1, 2, 3, 4]), torch.ones(4, dtype=torch.int64),
         torch.tensor(4))
    b = (torch.tensor([5, 6, 7, 8]), torch.ones(4, dtype=torch.int64),
         torch.tensor(4))
    keys, counts, n = acc._merge(a, b, 6)
    assert keys.shape == (6,) and int(n) == 8 and int(acc.overflow) == 2
    full = set_op_fused(*a[:2], *b[:2], n_a=a[2], n_b=b[2])
    assert torch.equal(keys, full[0][:6])
