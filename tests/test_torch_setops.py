"""zotpu_torch/workloads/setops.py against zotpu/workloads/setops.py and
golden on the CPU: ``set_op``, ``merge_tree_device``, ``jaccard`` and the
sharded forms (the JAX package on the 8-fake-device mesh, the port on D CPU
slots). On the CPU the port runs K3's plain version and the JAX package its
sort-based ``set_op``. Tolerance: exact equality of keys, counts (values and
dtypes) and of every cardinality."""

import numpy as np
import pytest
import torch

from zotpu import semantics as S
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu.workloads import setops as JW
from zotpu_torch.workloads import setops as TW

torch.set_num_threads(1)

OPS = ["merge", "union", "intersect", "diff"]
GOLD = {"merge": lambda a, b: G.merge([a, b]), "union": G.union,
        "intersect": G.intersect, "diff": G.difference}


def _set(rng, n, k=25, cmax=300):
    keys = np.unique(rng.integers(0, 1 << (2 * k), n, dtype=np.uint64))
    return keys, rng.integers(1, cmax, len(keys)).astype(np.uint32)


def _pair(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    empty = (np.empty(0, np.uint64), np.empty(0, np.uint32))
    a = _set(rng, 3000)
    if name == "empty_both":
        return empty, empty
    if name == "empty_a":
        return empty, a
    if name == "empty_b":
        return a, empty
    if name == "one_key_same":
        one = np.array([77], np.uint64)
        return (one, np.array([3], np.uint32)), (one, np.array([9], np.uint32))
    if name == "one_key_differs":
        return ((np.array([77], np.uint64), np.array([3], np.uint32)),
                (np.array([78], np.uint64), np.array([9], np.uint32)))
    if name == "disjoint":
        b = _set(rng, 3000)
        return a, (b[0][~np.isin(b[0], a[0])] | np.uint64(1),
                   b[1][~np.isin(b[0], a[0])])
    if name == "identical":
        return a, (a[0].copy(), a[1][::-1].copy())
    if name == "interleaved":
        keys = np.arange(0, 4000, dtype=np.uint64) * np.uint64(3)
        c = rng.integers(1, 300, 4000).astype(np.uint32)
        return (keys[0::2], c[0::2]), (keys[1::2], c[1::2])
    if name == "overlapping":
        b = _set(rng, 2000)
        keys = np.unique(np.concatenate([b[0], a[0][::3]]))
        return a, (keys, rng.integers(1, 300, len(keys)).astype(np.uint32))
    if name == "one_side_far_longer":
        return _set(rng, 20000), (a[0][5:12].copy(), a[1][5:12].copy())
    if name == "k31_extremes":
        top = np.uint64((1 << 62) - 1)
        ka = np.array([0, 5, (1 << 61), top - np.uint64(1), top], np.uint64)
        kb = np.array([0, 6, (1 << 61) + 1, top], np.uint64)
        return ((ka, np.arange(1, 6, dtype=np.uint32)),
                (kb, np.arange(10, 14, dtype=np.uint32)))
    if name == "saturating_counts":
        keys = np.arange(10, 20, dtype=np.uint64)
        big = np.full(10, 0xFFFFFFFF, np.uint32)
        big[::2] = 0xFFFFFFF0
        return (keys, big), (keys[2:].copy(),
                             np.full(8, 0x20, np.uint32))
    raise KeyError(name)


CASES = ["empty_both", "empty_a", "empty_b", "one_key_same",
         "one_key_differs", "disjoint", "identical", "interleaved",
         "overlapping", "one_side_far_longer", "k31_extremes",
         "saturating_counts"]


def _same_set(got, want):
    assert got[0].dtype == np.uint64 and got[1].dtype == np.uint32
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], np.asarray(want[1], np.uint32))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", CASES)
def test_set_op_matches_jax_and_golden(case, op):
    a, b = _pair(case)
    got = TW.set_op(a, b, op, device="cpu")
    _same_set(got, JW.set_op(a, b, op))
    _same_set(got, GOLD[op](a, b))
    if case == "saturating_counts" and op != "diff":
        assert int(got[1].max()) == 0xFFFFFFFF      # 0xFFFFFFF0 + 0x20


def test_intersect_with_a_zero_count_follows_the_fused_kernel():
    """The one stated difference, and it is the JAX package's own: its
    sort-based ``set_op`` (what ``set_op_auto`` takes on the CPU) keeps a
    key iff both counts are > 0, its fused Pallas kernel iff the key is
    present on both sides. The port follows the fused kernel. Real sets
    have counts >= 1, where the two agree (the test above)."""
    a = (np.array([5, 7], np.uint64), np.array([0, 2], np.uint32))
    b = (np.array([5], np.uint64), np.array([3], np.uint32))
    keys, counts = TW.set_op(a, b, "intersect", device="cpu")
    assert keys.tolist() == [5] and counts.tolist() == [3]
    jk, _ = JW.set_op(a, b, "intersect")
    assert len(jk) == 0


@pytest.mark.parametrize("n_runs", [0, 1, 2, 5, 8])
def test_merge_tree_device_matches_jax_and_golden(n_runs):
    rng = np.random.default_rng(n_runs)
    base = _set(rng, 4000, k=15)[0]
    runs = []
    for _ in range(n_runs):
        keys = np.sort(rng.choice(base, int(rng.integers(1, 1500)),
                                  replace=False))
        runs.append((keys, rng.integers(1, 50, len(keys)).astype(np.uint32)))
    got = TW.merge_tree_device(runs, device="cpu")
    _same_set(got, JW.merge_tree_device(runs))
    _same_set(got, G.merge(runs))


def test_merge_tree_device_saturates():
    keys = np.arange(4, dtype=np.uint64)
    runs = [(keys, np.full(4, 0xC0000000, np.uint32)) for _ in range(3)]
    got = TW.merge_tree_device(runs, device="cpu")
    _same_set(got, (keys, np.full(4, 0xFFFFFFFF, np.uint32)))
    _same_set(got, JW.merge_tree_device(runs))


@pytest.mark.parametrize("case", ["overlapping", "disjoint", "identical",
                                  "empty_a", "empty_both", "k31_extremes"])
def test_jaccard_matches_jax(case):
    a, b = _pair(case)
    got = TW.jaccard(a[0], b[0], device="cpu")
    assert got == JW.jaccard(a[0], b[0])
    assert got["intersect"] == len(np.intersect1d(a[0], b[0]))
    assert got["union"] == len(np.union1d(a[0], b[0]))


# --------------------------------------------------------------- sharded

K_SH = 15


def _sharded_pair(name):
    rng = np.random.default_rng(len(name))
    top = 1 << (2 * K_SH)
    if name == "spread":
        a, b = _set(rng, 4000, k=K_SH), _set(rng, 3000, k=K_SH)
        keys = np.unique(np.concatenate([b[0], a[0][::2]]))
        return a, (keys, rng.integers(1, 300, len(keys)).astype(np.uint32))
    if name == "all_in_one_slot":       # every key below the first edge of 8
        lim = top // 8
        return tuple(
            (lambda k: (k, rng.integers(1, 9, len(k)).astype(np.uint32)))(
                np.unique(rng.integers(0, lim, 900, dtype=np.uint64)))
            for _ in range(2))
    if name == "empty_slots":           # keys in the first and last eighth
        def side(n):
            lo = rng.integers(0, top // 8, n, dtype=np.uint64)
            hi = rng.integers(top - top // 8, top, n, dtype=np.uint64)
            k = np.unique(np.concatenate([lo, hi]))
            return k, rng.integers(1, 9, len(k)).astype(np.uint32)
        a = side(700)
        return a, (a[0][::2].copy(), a[1][::2].copy())
    if name == "one_side_empty":
        return _set(rng, 500, k=K_SH), (np.empty(0, np.uint64),
                                        np.empty(0, np.uint32))
    raise KeyError(name)


SHARDED = ["spread", "all_in_one_slot", "empty_slots", "one_side_empty"]


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", SHARDED)
def test_set_op_sharded_matches_jax_and_single_device(case, op, D):
    a, b = _sharded_pair(case)
    keys, counts, cards = TW.set_op_sharded(a, b, op, K_SH, D, device="cpu")
    jk, jc, jcards = JW.set_op_sharded(a, b, op, K_SH, D)
    _same_set((keys, counts), (jk, jc))
    assert cards == jcards
    _same_set((keys, counts), TW.set_op(a, b, op, device="cpu"))
    none_k, none_c, cards2 = TW.set_op_sharded(a, b, op, K_SH, D,
                                               gather=False, device="cpu")
    assert none_k is None and none_c is None and cards2 == cards


def test_partition_gives_every_slot_its_slice():
    a, _ = _sharded_pair("empty_slots")
    parts = TW._partition_sorted_prefix(a[0], a[1], K_SH, 8)
    assert [len(k) for k, _ in parts][1:7] == [0] * 6
    assert np.array_equal(np.concatenate([k for k, _ in parts]), a[0])
    owner = S.shard_of_u64(K_SH, 3, a[0])
    for d, (k, c) in enumerate(parts):
        assert np.array_equal(k, a[0][owner == d])
        assert np.array_equal(c, a[1][owner == d])
    assert np.array_equal(TW._prefix_edges(K_SH, 8),
                          JW._prefix_edges(K_SH, 8))
    assert len(TW._prefix_edges(K_SH, 1)) == 0


@pytest.mark.parametrize("D", [2, 4, 8])
def test_jaccard_sharded_matches_jax(D):
    for case in SHARDED:
        a, b = _sharded_pair(case)
        got = TW.jaccard_sharded(a[0], b[0], K_SH, D, device="cpu")
        assert got == JW.jaccard_sharded(a[0], b[0], K_SH, D)
        assert got == TW.jaccard(a[0], b[0], device="cpu")


def test_partition_cache_partitions_each_set_once(monkeypatch):
    """An N-way matrix with one cache partitions (and uploads) each set
    once; the entry holds the arrays, so their ids cannot be recycled."""
    rng = np.random.default_rng(3)
    sets = [_set(rng, 800, k=K_SH)[0] for _ in range(4)]
    calls = []
    real = TW._partition_sorted_prefix
    monkeypatch.setattr(TW, "_partition_sorted_prefix",
                        lambda keys, *a: calls.append(id(keys)) or real(
                            keys, *a))
    cache = {}
    for i in range(4):
        for j in range(i + 1, 4):
            got = TW.jaccard_sharded(sets[i], sets[j], K_SH, 4, cache=cache,
                                     device="cpu")
            assert got["intersect"] == len(np.intersect1d(sets[i], sets[j]))
    assert sorted(calls) == sorted(id(s) for s in sets)
    assert all(entry[0] is s for entry, s in zip(
        sorted(cache.values(), key=lambda e: id(e[0])),
        sorted(sets, key=id)))
    calls.clear()
    TW.jaccard_sharded(sets[0], sets[1], K_SH, 4, device="cpu")   # no cache
    assert len(calls) == 2


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("op", ["union", "intersect", "diff"])
def test_set_op_sharded_stream_matches_jax(tmp_path, op, D):
    """Streamed from container files in chunks far smaller than a slot's
    row; one input has no counts."""
    a, b = _sharded_pair("spread")
    pa, pb = str(tmp_path / "a.zkf"), str(tmp_path / "b.zkf")
    container.write(pa, container.KmerSet(k=K_SH, keys=a[0], counts=a[1]),
                    codec="delta")
    container.write(pb, container.KmerSet(k=K_SH, keys=b[0], counts=None))
    k, keys, counts, cards = TW.set_op_sharded_stream(pa, pb, op, D,
                                                      chunk=257, device="cpu")
    jk_, jkeys, jcounts, jcards = JW.set_op_sharded_stream(pa, pb, op, D,
                                                           chunk=257)
    assert k == jk_ == K_SH and cards == jcards
    _same_set((keys, counts), (jkeys, jcounts))
    ones = np.ones(len(b[0]), np.uint32)
    _same_set((keys, counts), TW.set_op(a, (b[0], ones), op, device="cpu"))


def test_set_op_sharded_stream_skew_and_k_mismatch(tmp_path):
    a, b = _sharded_pair("empty_slots")
    pa, pb, pc = (str(tmp_path / f) for f in ("a.zkf", "b.zkf", "c.zkf"))
    container.write(pa, container.KmerSet(k=K_SH, keys=a[0], counts=a[1]))
    container.write(pb, container.KmerSet(k=K_SH, keys=b[0], counts=b[1]))
    container.write(pc, container.KmerSet(k=K_SH + 2, keys=b[0],
                                          counts=b[1]))
    k, keys, counts, cards = TW.set_op_sharded_stream(pa, pb, "diff", 8,
                                                      chunk=100, device="cpu")
    _same_set((keys, counts), G.difference(a, b))
    assert cards == TW.set_op_sharded(a, b, "diff", K_SH, 8,
                                      device="cpu")[2]
    errs = []
    for fn, kw in ((TW.set_op_sharded_stream, {"device": "cpu"}),
                   (JW.set_op_sharded_stream, {})):
        with pytest.raises(ValueError, match="K mismatch") as e:
            fn(pa, pc, "union", 4, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_sharded_slots_on_distinct_devices():
    """Slots that name distinct devices ("cpu" and "cpu:0" differ): each
    slot's rows and K3 call stay on its device and the counts are summed
    across devices."""
    a, b = _sharded_pair("spread")
    slots = ["cpu", "cpu:0"] * 2
    keys, counts, cards = TW.set_op_sharded(a, b, "union", K_SH, 4,
                                            devices=slots)
    _same_set((keys, counts), G.union(a, b))
    assert cards["union"] == len(keys)


def test_sharded_needs_a_power_of_two_and_enough_cards(monkeypatch):
    a, b = _sharded_pair("spread")
    with pytest.raises(ValueError, match="power of two"):
        TW.set_op_sharded(a, b, "union", K_SH, 3, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"--shards 4 exceeds the 1 "):
        TW.set_op_sharded(a, b, "union", K_SH, 4)
