"""The port's spectrum slice (BASELINE config 4) on the CPU:
``zotpu_torch.kernels.hist.spectrum`` against ``zotpu.kernels.hist.spectrum``
(XLA) and ``golden.spectrum``, ``workloads/spectrum`` against the JAX
package's, and the CLI's ``hist`` and ``filter`` against ``python -m zotpu``.
Tolerance: exact equality of every bin (int32 on both sides) and of the
fit's dict; the printed histogram and JSON lines are compared as strings,
the containers by keys, counts and k (``meta["tool"]`` names the
package)."""

import json

import numpy as np
import pytest
import torch

from zotpu import cli as zcli
from zotpu.io import container
from zotpu.kernels import hist as JH
from zotpu.reference_impl import golden as G
from zotpu.workloads import spectrum as JS
from zotpu_torch import cli as tcli
from zotpu_torch.kernels import hist as TH
from zotpu_torch.workloads import spectrum as TS

torch.set_num_threads(1)


def _counts(kind, max_count):
    rng = np.random.default_rng(max_count)
    if kind == "empty":
        return np.zeros(0, np.uint32)
    if kind == "zeros_only":
        return np.zeros(50, np.uint32)
    if kind == "around_max":        # at, below and above max_count, + zeros
        c = np.array([max_count, max_count - 1, max_count + 1, 1, 1, 0, 0,
                      max_count, 2 * max_count + 7, 0xFFFFFFFF], np.int64)
        return np.maximum(c, 0).astype(np.uint32)
    if kind == "poisson":
        c = rng.poisson(25, 20000).astype(np.uint32)
        c[::7] = rng.integers(1, 4, len(c[::7]))
        c[::501] = 0                # padding rows
        return c
    if kind == "wide":              # counts spread past every max_count
        return rng.integers(0, 200000, 30000).astype(np.uint32)
    raise KeyError(kind)


KINDS = ["empty", "zeros_only", "around_max", "poisson", "wide"]


@pytest.mark.parametrize("max_count", [1, 1024, 70000])
@pytest.mark.parametrize("kind", KINDS)
def test_spectrum_kernel_matches_jax_and_golden(kind, max_count):
    counts = _counts(kind, max_count)
    got = TH.spectrum(torch.from_numpy(counts.astype(np.int64)),
                      max_count=max_count)
    assert got.dtype == torch.int32 and got.shape == (max_count + 1,)
    padded = np.zeros(max(len(counts), 8), np.uint32)
    padded[:len(counts)] = counts
    want = np.asarray(JH.spectrum(padded, max_count=max_count))
    assert want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    gold = G.spectrum(counts, max_count=max_count)
    gold[0] = 0                     # golden counts the padding rows in bin 0
    assert np.array_equal(got.numpy(), gold)
    assert int(got[0]) == 0
    assert int(got.sum()) == int((counts > 0).sum())


def test_spectrum_kernel_rejects_other_dtypes():
    with pytest.raises(ValueError, match="int64"):
        TH.spectrum(torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("max_count", [1024, 300])
@pytest.mark.parametrize("kind", ["poisson", "wide", "empty"])
def test_spectrum_workload_matches_jax(kind, max_count):
    counts = _counts(kind, 1024)
    got = TS.spectrum(counts, max_count=max_count, device="cpu")
    want = JS.spectrum(counts, max_count=max_count)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    fit, jfit = (f(counts, max_count=max_count) for f in (
        lambda c, **kw: TS.spectrum_with_cutoff(c, device="cpu", **kw),
        JS.spectrum_with_cutoff))
    assert np.array_equal(fit.pop("hist"), jfit.pop("hist"))
    assert fit == jfit
    assert [type(v) for v in fit.values()] == [type(v) for v in jfit.values()]


@pytest.fixture(scope="module")
def coverage_set(tmp_path_factory):
    """A 25x set with an error peak: the spectrum has a valley and a
    coverage peak, so --cutoff and --auto have something to find."""
    rng = np.random.default_rng(8)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    reads = []
    for off in rng.integers(0, 2900, 750):
        r = list(genome[off:off + 100])
        for i in np.flatnonzero(rng.random(100) < 0.01):
            r[i] = "ACGT"[("ACGT".index(r[i]) + 1) % 4]
        reads.append("".join(r))
    keys, counts = G.kmerize(21, reads)
    d = tmp_path_factory.mktemp("spectrum")
    container.write(str(d / "s.zkf"),
                    container.KmerSet(k=21, keys=keys, counts=counts))
    container.write(str(d / "noc.zkf"),
                    container.KmerSet(k=21, keys=keys, counts=None))
    container.write(str(d / "empty.zkf"), container.KmerSet(
        k=21, keys=np.empty(0, np.uint64), counts=np.empty(0, np.uint32)))
    return d, keys, counts


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("name", ["s", "noc", "empty"])
@pytest.mark.parametrize("flags", [[], ["--cutoff"], ["--host"],
                                   ["--host", "--cutoff"],
                                   ["--max-count", "12"],
                                   ["--max-count", "70000", "--cutoff"]],
                         ids=lambda f: "".join(f).replace("--", "-") or
                         "plain")
def test_cli_hist_byte_equal(coverage_set, capsys, flags, name):
    d, _, counts = coverage_set
    argv = ["hist", *flags, d / f"{name}.zkf"]
    port = _run(tcli.main, argv + ([] if "--host" in flags
                                   else ["--device", "cpu"]), capsys)
    assert port == _run(zcli.main, argv, capsys)
    assert port[0] == 0 and port[2] == ""
    if name == "s" and flags == ["--cutoff"]:
        lines = port[1].splitlines()
        fit = json.loads(lines[-1])
        assert fit["cutoff"] > 1 and 15 < fit["coverage_peak"] < 30
        want = G.spectrum(counts)
        assert lines[:-1] == [f"{f}\t{int(want[f])}"
                              for f in range(1, len(want)) if want[f]]


@pytest.mark.parametrize("flags", [["--min-count", "3"], ["--auto"],
                                   ["--min-count", "1", "--codec", "delta"],
                                   ["--auto", "--codec", "zlib"],
                                   ["--min-count", "100000"]],
                         ids=lambda f: "".join(f).replace("--", "-"))
def test_cli_filter_byte_equal(coverage_set, tmp_path, capsys, flags):
    d, keys, counts = coverage_set
    outs = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", zcli.main, [])):
        out = tmp_path / f"{name}.zkf"
        rc, stdout, err = _run(main, ["filter", *flags, *extra, out,
                                      d / "s.zkf"], capsys)
        assert rc == 0, err
        outs[name] = (stdout, container.read(str(out)))
    assert outs["port"][0] == outs["jax"][0]
    port, jx = outs["port"][1], outs["jax"][1]
    assert port.k == jx.k == 21
    assert np.array_equal(port.keys, jx.keys)
    assert np.array_equal(port.counts, jx.counts)
    assert port.meta.pop("tool") == "zotpu_torch filter"
    assert jx.meta.pop("tool") == "zotpu filter"
    assert port.meta == jx.meta
    line = json.loads(outs["port"][0])
    assert np.array_equal(port.keys, keys[counts >= line["min_count"]])
    if "--auto" in flags:
        assert line["min_count"] == G.error_peak_cutoff(G.spectrum(counts))
        assert 0 < line["kept"] < line["of"]


def test_cli_filter_with_neither_flag_exits_1(coverage_set, tmp_path, capsys):
    d, _, _ = coverage_set
    argv = ["filter", tmp_path / "o.zkf", d / "s.zkf"]
    port = _run(tcli.main, argv, capsys)
    assert port == _run(zcli.main, argv, capsys)
    assert port[0] == 1 and port[2] == "error: pass --min-count N or --auto\n"
    assert not (tmp_path / "o.zkf").exists()


@pytest.mark.parametrize("argv", [["hist", "IN"], ["hist", "--cutoff", "IN"],
                                  ["filter", "--auto", "OUT", "IN"]],
                         ids=lambda a: "-".join(a))
def test_device_cuda_without_a_card_exits_1(coverage_set, tmp_path, capsys,
                                            monkeypatch, argv):
    d, _, _ = coverage_set
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.zkf"
    argv = [{"IN": d / "s.zkf", "OUT": out}.get(a, a) for a in argv]
    rc, stdout, err = _run(tcli.main, argv, capsys)
    assert rc == 1 and stdout == ""
    assert "--device cuda" in err and "is_available() is false" in err
    assert not out.exists()


def test_filter_min_count_needs_no_device(coverage_set, tmp_path, capsys,
                                          monkeypatch):
    """``filter --min-count`` is host-only in both packages: it has no
    device work to fall back from."""
    d, keys, counts = coverage_set
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = _run(tcli.main, ["filter", "--min-count", 4,
                                  tmp_path / "o.zkf", d / "s.zkf"], capsys)
    assert rc == 0, err
    assert np.array_equal(container.read(str(tmp_path / "o.zkf")).keys,
                          keys[counts >= 4])
