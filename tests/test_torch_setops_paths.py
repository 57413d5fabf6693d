"""``workloads/setops.set_op_paths`` and ``jaccard_paths``, the one-device
bodies of ``python -m zotpu_torch union|intersect|diff`` and of two-set
``jaccard``, on the CPU: against the JAX package's golden set ops and
against ``python -m zotpu`` (its CLI in process) on the same container
files. On the CPU the port runs K3's plain version. Tolerance: exact
equality of k, keys, counts (values and dtypes) and every cardinality."""

import json

import numpy as np
import pytest
import torch

from zotpu import cli as zcli
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu_torch import cli as tcli
from zotpu_torch.workloads import setops as TW

torch.set_num_threads(1)

K = 25
COUNT_MAX = 0xFFFFFFFF
OPS = ["union", "intersect", "diff"]
GOLD = {"union": G.union, "intersect": G.intersect, "diff": G.difference}
CASES = ["overlap", "count_max_both", "empty_a", "empty_b", "disjoint",
         "identical", "counts_less_b"]


def _set(rng, n, hi=1 << (2 * K)):
    keys = np.unique(rng.integers(0, hi, n, dtype=np.uint64))
    return keys, rng.integers(1, 500, len(keys)).astype(np.uint32)


def _pair(name):
    """Two seeded (keys, counts) sets; B's counts are None for a
    counts-less set."""
    rng = np.random.default_rng(sum(map(ord, name)) + 22)
    a, b = _set(rng, 4000), _set(rng, 3000)
    shared = a[0][::3]
    b_keys = np.unique(np.concatenate([b[0], shared]))
    b = (b_keys, rng.integers(1, 500, len(b_keys)).astype(np.uint32))
    empty = (np.empty(0, np.uint64), np.empty(0, np.uint32))
    if name == "overlap":
        return a, b
    if name == "count_max_both":
        ca = a[1].copy()
        ca[::2] = COUNT_MAX
        cb = np.full(len(b[0]), COUNT_MAX, np.uint32)
        cb[1::4] = 7
        return (a[0], ca), (b[0], cb)
    if name == "empty_a":
        return empty, b
    if name == "empty_b":
        return a, empty
    if name == "disjoint":
        keep = ~np.isin(b[0], a[0])
        return a, (b[0][keep], b[1][keep])
    if name == "identical":
        return a, (a[0].copy(), a[1][::-1].copy())
    if name == "counts_less_b":
        return a, (b[0], None)
    raise KeyError(name)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{case: (path A, path B, A, B with counts of one for a counts-less
    set)}, and a k=15 set."""
    d = tmp_path_factory.mktemp("setops_paths")
    out = {}
    for name in CASES:
        a, b = _pair(name)
        paths = []
        for side, (keys, counts) in (("a", a), ("b", b)):
            path = str(d / f"{name}_{side}.zkf")
            container.write(path, container.KmerSet(k=K, keys=keys,
                                                    counts=counts))
            paths.append(path)
        ones = (b[0], np.ones(len(b[0]), np.uint32)) if b[1] is None else b
        out[name] = (*paths, a, ones)
    k15 = str(d / "k15.zkf")
    container.write(k15, container.KmerSet(
        k=15, keys=np.arange(3, dtype=np.uint64),
        counts=np.ones(3, np.uint32)))
    return out, k15


def _zotpu(capsys, argv):
    capsys.readouterr()
    assert zcli.main([str(a) for a in argv]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", CASES)
def test_set_op_paths_equals_golden_and_zotpu(files, tmp_path, capsys, case,
                                              op):
    pa, pb, a, b = files[0][case]
    k, keys, counts = TW.set_op_paths(pa, pb, op, device="cpu")
    want = GOLD[op](a, b)
    assert k == K
    assert keys.dtype == np.uint64 and counts.dtype == np.uint32
    assert np.array_equal(keys, want[0])
    assert np.array_equal(counts, want[1])
    out = tmp_path / "z.zkf"
    line = json.loads(_zotpu(capsys, [op, out, pa, pb]))
    z = container.read(str(out))
    assert line == {"command": op, "unique": len(keys)}
    assert z.k == k
    assert np.array_equal(z.keys, keys) and np.array_equal(z.counts, counts)
    if case == "count_max_both" and op != "diff":
        assert (counts == COUNT_MAX).sum() > 0


@pytest.mark.parametrize("case", CASES)
def test_jaccard_paths_equals_golden_and_zotpu(files, capsys, case):
    pa, pb, a, b = files[0][case]
    got = TW.jaccard_paths(pa, pb, device="cpu")
    ni = len(np.intersect1d(a[0], b[0]))
    nu = len(np.union1d(a[0], b[0]))
    assert got == {"a": len(a[0]), "b": len(b[0]), "intersect": ni,
                   "union": nu, "jaccard": ni / nu if nu else 0.0}
    line = json.loads(_zotpu(capsys, ["jaccard", pa, pb]))
    assert line == {"command": "jaccard", **got}


def test_set_op_paths_refuses_a_k_mismatch(files):
    pa, _, _, _ = files[0]["overlap"]
    with pytest.raises(ValueError, match=r"K mismatch \(25 vs 15\)"):
        TW.set_op_paths(pa, files[1], "union", device="cpu")


@pytest.mark.parametrize("op", OPS + ["jaccard"])
def test_the_cli_runs_the_path_entries(files, tmp_path, capsys, monkeypatch,
                                       op):
    """The one-device commands go through the entries: one call each, with
    the files and device named on the command line."""
    pa, pb, _, _ = files[0]["overlap"]
    name = "jaccard_paths" if op == "jaccard" else "set_op_paths"
    calls, real = [], getattr(TW, name)
    monkeypatch.setattr(TW, name, lambda *a, **kw: calls.append(
        (a, kw)) or real(*a, **kw))
    out = tmp_path / "t.zkf"
    argv = [op, "--device", "cpu"] + ([] if op == "jaccard" else [out])
    capsys.readouterr()
    assert tcli.main([str(x) for x in argv + [pa, pb]]) == 0
    capsys.readouterr()
    want = (pa, pb) if op == "jaccard" else (pa, pb, op)
    assert calls == [(want, {"device": torch.device("cpu")})]
