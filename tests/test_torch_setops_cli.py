"""``python -m zotpu_torch merge|union|intersect|diff|jaccard --device cpu``
against ``python -m zotpu`` in process on the same inputs: the written
containers (keys, counts, k) and the printed lines, byte for byte. The one
stated exception is ``meta["tool"]``, which names the package. On the CPU
the port runs K3's plain version and the JAX package its XLA paths (the
8-fake-device mesh for ``--shards``)."""

import json

import numpy as np
import pytest
import torch

from zotpu import cli as zcli
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu_torch import cli as tcli

torch.set_num_threads(1)

K = 21


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Three overlapping sets from one genome, a counts-less copy of one, a
    k=15 set and an empty set."""
    d = tmp_path_factory.mktemp("setops_cli")
    rng = np.random.default_rng(77)
    genome = "".join(rng.choice(list("ACGT"), size=9000))

    def reads(lo, hi, n):
        offs = rng.integers(lo, hi - 100, n)
        return [genome[o:o + 100] for o in offs]

    data = {"a": G.kmerize(K, reads(0, 6000, 300)),
            "b": G.kmerize(K, reads(3000, 9000, 300)),
            "c": G.kmerize(K, reads(0, 9000, 150))}
    for name, (keys, counts) in data.items():
        container.write(str(d / f"{name}.zkf"),
                        container.KmerSet(k=K, keys=keys, counts=counts))
    container.write(str(d / "noc.zkf"), container.KmerSet(
        k=K, keys=data["c"][0], counts=None), codec="delta")
    k15 = G.kmerize(15, reads(0, 3000, 50))
    container.write(str(d / "k15.zkf"),
                    container.KmerSet(k=15, keys=k15[0], counts=k15[1]))
    container.write(str(d / "empty.zkf"), container.KmerSet(
        k=K, keys=np.empty(0, np.uint64), counts=np.empty(0, np.uint32)))
    return d, data


@pytest.fixture(autouse=True)
def _small_merge_chunk(monkeypatch):
    """Both CLIs read ZOTPU_MERGE_CHUNK; the default of 2^22 keys makes the
    JAX package sort 2^23-key arrays per merge on the CPU."""
    monkeypatch.setenv("ZOTPU_MERGE_CHUNK", "4096")


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(capsys, tmp_path, command, flags, inputs, port_flags=("--device",
                                                                "cpu")):
    """Run a set-writing command through both CLIs; returns the port's
    container after holding it, and the printed lines, equal to the JAX
    package's."""
    outs = {}
    for name, main, extra in (("port", tcli.main, port_flags),
                              ("jax", zcli.main, ())):
        out = tmp_path / f"{name}.zkf"
        rc, stdout, err = _run(main, [command, *flags, *extra, out, *inputs],
                               capsys)
        assert rc == 0, err
        outs[name] = (stdout, container.read(str(out)))
    (pout, port), (jout, jx) = outs["port"], outs["jax"]
    assert pout == jout
    assert port.k == jx.k
    assert np.array_equal(port.keys, jx.keys)
    assert port.counts.dtype == jx.counts.dtype == np.uint32
    assert np.array_equal(port.counts, jx.counts)
    assert port.meta == {"tool": f"zotpu_torch {command}"}
    assert jx.meta == {"tool": f"zotpu {command}"}
    return port, pout


@pytest.mark.parametrize("flags,names", [
    ([], ["a", "b", "c"]),
    (["--host"], ["a", "b", "c"]),
    ([], ["a", "noc"]),                       # a counts-less input: ones
    (["--codec", "zlib"], ["a", "b"]),
    (["--codec", "delta"], ["b", "c", "a"]),
    (["--codec", "raw"], ["a"]),
    ([], ["empty", "a", "empty"]),
    ([], ["empty", "empty"]),                 # an empty set with the inputs' k
], ids=lambda x: "-".join(x) or "plain")
def test_merge_matches_jax(sets, tmp_path, capsys, flags, names):
    d, data = sets
    port, line = _both(capsys, tmp_path, "merge", flags,
                       [d / f"{n}.zkf" for n in names],
                       port_flags=() if "--host" in flags else ("--device",
                                                                "cpu"))
    ones = (data["c"][0], np.ones(len(data["c"][0]), np.uint32))
    empty = (np.empty(0, np.uint64), np.empty(0, np.uint32))
    want = G.merge([{"noc": ones, "empty": empty}.get(n) or data[n]
                    for n in names])
    assert np.array_equal(port.keys, want[0])
    assert np.array_equal(port.counts, want[1])
    assert json.loads(line) == {"command": "merge", "inputs": len(names),
                                "unique": len(want[0])}
    assert port.k == K


@pytest.mark.parametrize("chunk", [64, 500])
def test_merge_in_small_chunks_takes_several_levels(sets, tmp_path, capsys,
                                                    monkeypatch, chunk):
    """ZOTPU_MERGE_CHUNK far below a set's size: every input comes in many
    chunks (the last one short), and the accumulator merges through
    several levels."""
    d, data = sets
    monkeypatch.setenv("ZOTPU_MERGE_CHUNK", str(chunk))
    assert min(len(v[0]) for v in data.values()) > 8 * chunk
    from zotpu_torch.workloads import accumulator
    levels = []
    real = accumulator.DeviceAccumulator.result
    monkeypatch.setattr(accumulator.DeviceAccumulator, "result",
                        lambda self: levels.append(len(self.levels)) or real(
                            self))
    port, _ = _both(capsys, tmp_path, "merge", [],
                    [d / "a.zkf", d / "b.zkf", d / "noc.zkf"])
    assert levels and levels[0] >= 4
    assert len(port.keys) == len(np.union1d(
        np.union1d(data["a"][0], data["b"][0]), data["c"][0]))


def test_merge_saturates(tmp_path, capsys):
    keys = np.arange(5, dtype=np.uint64)
    paths = []
    for i, c in enumerate((0xFFFFFFF0, 0x0F, 0x01, 0xFFFFFFFF)):
        paths.append(tmp_path / f"s{i}.zkf")
        container.write(str(paths[-1]), container.KmerSet(
            k=K, keys=keys[i % 2:], counts=np.full(5 - i % 2, c, np.uint32)))
    port, _ = _both(capsys, tmp_path, "merge", [], paths)
    # key 0 is in the first and third set only: 0xFFFFFFF0 + 0x01
    assert port.counts.tolist() == [0xFFFFFFF1] + [0xFFFFFFFF] * 4


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_merge_k_mismatch_exits_1_with_the_same_message(sets, tmp_path,
                                                        capsys, host):
    d, _ = sets
    argv = ["merge", *(["--host"] if host else []), tmp_path / "o.zkf",
            d / "a.zkf", d / "k15.zkf"]
    port = _run(tcli.main, argv + ([] if host else ["--device", "cpu"]),
                capsys)
    assert port == _run(zcli.main, argv, capsys)
    assert port[0] == 1 and "K mismatch" in port[2] and "k=15" in port[2]
    assert not (tmp_path / "o.zkf").exists()


def test_merge_capacity_error_exits_1(sets, tmp_path, capsys, monkeypatch):
    """The sizes sit far from the edge: the port's CapacityError is bound
    by the run capacity itself and the JAX package's by a tile-rounded one,
    so the two agree only away from it. 512-key chunks, a capacity of 1024
    keys, thousands of unique keys: both exit 1; a roomy capacity: both
    merge."""
    d, data = sets
    monkeypatch.setenv("ZOTPU_MERGE_CHUNK", "512")
    n_union = len(np.union1d(data["a"][0], data["b"][0]))
    assert n_union > 4 * 1024
    argv = ["merge", "--merge-capacity", 1024, tmp_path / "o.zkf",
            d / "a.zkf", d / "b.zkf"]
    rc, out, err = _run(tcli.main, [*argv, "--device", "cpu"], capsys)
    assert rc == 1 and out == "" and "--merge-capacity" in err
    assert _run(zcli.main, argv, capsys)[0] == 1
    _both(capsys, tmp_path, "merge", ["--merge-capacity", 1 << 16],
          [d / "a.zkf", d / "b.zkf"])


_SETOP_FLAGS = [[], ["--host"], ["--shards", "4"], ["--shards", "2"],
                ["--stream", "--shards", "4"], ["--codec", "zlib"],
                ["--codec", "delta"], ["--codec", "raw"],
                ["--shards", "4", "--codec", "delta"]]


@pytest.mark.parametrize("flags", _SETOP_FLAGS,
                         ids=lambda f: "".join(f).replace("--", "-") or
                         "plain")
@pytest.mark.parametrize("op", ["union", "intersect", "diff"])
def test_binary_setop_matches_jax(sets, tmp_path, capsys, op, flags):
    d, data = sets
    port, line = _both(capsys, tmp_path, op, flags, [d / "a.zkf",
                                                     d / "b.zkf"],
                       port_flags=() if "--host" in flags else ("--device",
                                                                "cpu"))
    gold = {"union": G.union, "intersect": G.intersect,
            "diff": G.difference}[op]
    want = gold(data["a"], data["b"])
    assert np.array_equal(port.keys, want[0])
    assert np.array_equal(port.counts, want[1])
    got = json.loads(line)
    assert got["unique"] == len(want[0])
    assert ("cards" in got) == ("--stream" in flags)
    if "cards" in got:
        ni = len(np.intersect1d(data["a"][0], data["b"][0]))
        assert got["cards"]["intersect"] == ni
        assert got["cards"]["a"] == len(data["a"][0])


@pytest.mark.parametrize("flags", [[], ["--shards", "4"], ["--stream"]],
                         ids=["plain", "shards", "stream"])
def test_binary_setop_with_a_counts_less_and_an_empty_input(sets, tmp_path,
                                                            capsys, flags):
    d, _ = sets
    for op, inputs in (("intersect", ["a", "noc"]), ("diff", ["noc", "b"]),
                       ("union", ["empty", "a"]), ("diff", ["a", "empty"])):
        _both(capsys, tmp_path, op, flags, [d / f"{n}.zkf" for n in inputs])


@pytest.mark.parametrize("flags", [[], ["--shards", "4"],
                                   ["--stream", "--shards", "4"]],
                         ids=["plain", "shards", "stream"])
def test_binary_setop_k_mismatch_exits_1_with_the_same_message(
        sets, tmp_path, capsys, flags):
    d, _ = sets
    argv = ["union", *flags, tmp_path / "o.zkf", d / "a.zkf", d / "k15.zkf"]
    port = _run(tcli.main, [*argv, "--device", "cpu"], capsys)
    assert port == _run(zcli.main, argv, capsys)
    assert port[0] == 1 and port[2].startswith("error: K mismatch")
    assert not (tmp_path / "o.zkf").exists()


@pytest.mark.parametrize("op", ["union", "intersect", "diff"])
def test_binary_setop_multi_host_flag_exits_1(sets, tmp_path, capsys, op):
    """A flag that cannot make a multi-controller run exits 1 before any
    process group is joined: no --process-id (the JAX package's message),
    or --shards not a multiple of the process count."""
    d, _ = sets
    argv = [op, "--num-processes", 2, "--coordinator", "127.0.0.1:1",
            tmp_path / "o.zkf", d / "a.zkf", d / "b.zkf"]
    got = _run(tcli.main, [*argv, "--device", "cpu"], capsys)
    assert got == _run(zcli.main, argv, capsys)
    assert got == (1, "", "error: --num-processes needs --coordinator "
                          "HOST:PORT and --process-id\n")
    rc, out, err = _run(tcli.main, [*argv, "--device", "cpu", "--process-id",
                                    0, "--shards", 3], capsys)
    assert rc == 1 and out == "" and err == (
        "error: --shards 3 must be a power of two and a multiple of "
        "--num-processes 2\n")
    assert not (tmp_path / "o.zkf").exists()


@pytest.mark.parametrize("flags", [[], ["--host"], ["--shards", "4"],
                                   ["--shards", "8"]],
                         ids=lambda f: "".join(f).replace("--", "-") or
                         "plain")
@pytest.mark.parametrize("names", [["a", "b"], ["a", "b", "c"],
                                   ["a", "noc", "empty", "b"]],
                         ids=lambda n: "-".join(n))
def test_jaccard_matches_jax(sets, capsys, names, flags):
    d, data = sets
    argv = ["jaccard", *flags, *[d / f"{n}.zkf" for n in names]]
    extra = [] if "--host" in flags else ["--device", "cpu"]
    port = _run(tcli.main, argv + extra, capsys)
    assert port == _run(zcli.main, argv, capsys)
    lines = [json.loads(x) for x in port[1].splitlines()]
    assert port[0] == 0
    assert len(lines) == len(names) * (len(names) - 1) // 2
    ni = len(np.intersect1d(data["a"][0], data["b"][0]))
    nu = len(np.union1d(data["a"][0], data["b"][0]))
    if len(names) < 4:
        assert lines[0]["intersect"] == ni and lines[0]["union"] == nu
        assert lines[0]["jaccard"] == ni / nu


def test_jaccard_matrix_uses_one_partition_cache(sets, capsys, monkeypatch):
    d, _ = sets
    from zotpu_torch.workloads import setops as WS
    calls = []
    real = WS._partition_sorted_prefix
    monkeypatch.setattr(WS, "_partition_sorted_prefix",
                        lambda *a: calls.append(1) or real(*a))
    rc, out, _ = _run(tcli.main, ["jaccard", "--device", "cpu", "--shards", 4,
                                  d / "a.zkf", d / "b.zkf", d / "c.zkf"],
                      capsys)
    assert rc == 0 and len(out.splitlines()) == 3 and len(calls) == 3


@pytest.mark.parametrize("argv", [
    ["merge", "OUT", "a.zkf", "b.zkf"],
    ["union", "OUT", "a.zkf", "b.zkf"],
    ["intersect", "--shards", "4", "OUT", "a.zkf", "b.zkf"],
    ["diff", "--stream", "OUT", "a.zkf", "b.zkf"],
    ["jaccard", "a.zkf", "b.zkf"],
    ["jaccard", "--shards", "4", "a.zkf", "b.zkf", "c.zkf"],
], ids=lambda a: "-".join(x for x in a if not x.endswith(".zkf")
                          and x != "OUT"))
def test_device_cuda_without_a_card_exits_1(sets, tmp_path, capsys,
                                            monkeypatch, argv):
    """--device cuda is the default and nothing carries on on the CPU."""
    d, _ = sets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.zkf"
    argv = [out if a == "OUT" else d / a if a.endswith(".zkf") else a
            for a in argv]
    rc, stdout, err = _run(tcli.main, argv, capsys)
    assert rc == 1 and stdout == ""
    assert "--device cuda" in err and "is_available() is false" in err
    assert not out.exists()
