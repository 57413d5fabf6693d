"""The rest of the CLI surface against ``python -m zotpu`` in process:
``spikein``, ``sample``, ``dump``, ``info``, ``casket ls|new|add|extract``
and ``-V`` print the same bytes and write the same files (``sample``'s
container meta names the tool); ``kmerize --metrics`` writes a JSONL line
with the JAX package's keys and counts, and ``--trace`` a JSON trace."""

import json
import os

import numpy as np
import pytest
import torch

from zotpu import cli as zcli
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu_torch import cli as tcli
from zotpu_torch import metrics

torch.set_num_threads(1)

K = 21
MAINS = (("port", tcli.main), ("jax", zcli.main))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 9 kbp genome: reads of it, two sets, a counts-less set, an empty
    set, a casket of two members, and a reference FASTA."""
    d = tmp_path_factory.mktemp("cli_parity")
    rng = np.random.default_rng(31)
    seq = "".join(rng.choice(list("ACGT"), size=9000))
    reads = [seq[o:o + 100] for o in rng.integers(0, 8900, 400)]
    reads[7] = reads[7][:50] + "N" + reads[7][51:]
    (d / "reads.fastq").write_text("".join(
        f"@r{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in enumerate(reads)))
    a, b = G.kmerize(K, reads[:250]), G.kmerize(K, reads[150:])
    container.write(str(d / "a.zkf"), container.KmerSet(k=K, keys=a[0],
                                                        counts=a[1]))
    container.write(str(d / "b.zkf"), container.KmerSet(k=K, keys=b[0],
                                                        counts=b[1]),
                    codec="delta")
    container.write(str(d / "noc.zkf"), container.KmerSet(k=K, keys=b[0]))
    container.write(str(d / "empty.zkf"), container.KmerSet(
        k=K, keys=np.empty(0, np.uint64), counts=np.empty(0, np.uint32)))
    container.casket_write(str(d / "c.zkc"), [
        ("a", container.read(str(d / "a.zkf"))),
        ("noc", container.read(str(d / "noc.zkf")))], codec="zlib")
    (d / "ref.fa").write_text(">chr1\n" + "".join(
        seq[i:i + 60] + "\n" for i in range(0, 3000, 60)))
    return d, seq


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys, tmp_path, monkeypatch):
    """Run argv through both CLIs, each in its own working directory (so
    relative output paths print the same); returns the two directories
    after holding the exit codes and printed bytes equal."""
    got = {}
    for name, main in MAINS:
        wd = tmp_path / name
        wd.mkdir(exist_ok=True)
        monkeypatch.chdir(wd)
        got[name] = _run(main, argv, capsys)
    assert got["port"] == got["jax"]
    return tmp_path / "port", tmp_path / "jax", got["port"]


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["-V"])
    assert e.value.code == 0
    assert capsys.readouterr().out == "zotpu_torch 0.1.0\n"
    with pytest.raises(SystemExit):
        zcli.main(["--version"])
    assert capsys.readouterr().out.startswith("zotpu ")


@pytest.mark.parametrize("flags", [
    [], ["--vaf", "0.3", "--coverage", "12", "--read-len", "80",
         "--error-rate", "0.01", "--seed", "4"],
    ["--vaf", "1.0", "--seed", "9"]], ids=["defaults", "error", "vaf1"])
def test_spikein_writes_the_same_fastq(data, capsys, tmp_path, monkeypatch,
                                       flags):
    d, seq = data
    specs = [f"chr1:g.1200{seq[1199]}>{'ACGT'['ACGT'.index(seq[1199]) - 1]}",
             "chr1:g.2000_2002del"]
    port, jax_, (rc, out, _) = _both(
        ["spikein", d / "ref.fa", "s.fastq", *specs, *flags], capsys,
        tmp_path, monkeypatch)
    assert rc == 0 and json.loads(out)["command"] == "spikein"
    fq = (port / "s.fastq").read_bytes()
    assert fq == (jax_ / "s.fastq").read_bytes() and fq.startswith(b"@")


@pytest.mark.parametrize("flags", [["--rate", "0.5"],
                                   ["--rate", "0.1", "--seed", "7"],
                                   ["--rate", "1.0", "--codec", "delta"],
                                   ["--rate", "0.0"]],
                         ids=["half", "seed", "all-delta", "none"])
@pytest.mark.parametrize("src", ["a.zkf", "noc.zkf", "c.zkc#a"])
def test_sample_matches_jax(data, capsys, tmp_path, monkeypatch, flags, src):
    d, _ = data
    port, jax_, (rc, out, _) = _both(["sample", *flags, "o.zkf", d / src],
                                     capsys, tmp_path, monkeypatch)
    assert rc == 0 and json.loads(out)["command"] == "sample"
    p, j = (container.read(str(x / "o.zkf")) for x in (port, jax_))
    assert p.k == j.k == K
    assert p.keys.tobytes() == j.keys.tobytes()
    assert p.counts.tobytes() == j.counts.tobytes()
    assert p.meta.pop("tool") == "zotpu_torch sample"
    assert j.meta.pop("tool") == "zotpu sample"
    assert p.meta == j.meta == {"rate": float(flags[1]),
                                "seed": int(dict(zip(flags[::2],
                                                     flags[1::2])).get(
                                                         "--seed", 0))}


@pytest.mark.parametrize("src", ["a.zkf", "b.zkf", "noc.zkf", "empty.zkf",
                                 "c.zkc#a", "c.zkc#noc"])
def test_dump_matches_jax(data, capsys, tmp_path, monkeypatch, src):
    d, _ = data
    _, _, (rc, out, _) = _both(["dump", d / src], capsys, tmp_path,
                               monkeypatch)
    assert rc == 0
    ks = container.read(str(d / src))
    assert len(out.splitlines()) == ks.n


@pytest.mark.parametrize("srcs", [["a.zkf"], ["b.zkf", "noc.zkf",
                                              "empty.zkf"],
                                  ["c.zkc#noc"], ["c.zkc"],
                                  ["c.zkc", "c.zkc#a", "a.zkf"],
                                  ["missing.zkf"], ["reads.fastq"]],
                         ids=["one", "three", "member", "casket", "mixed",
                              "missing", "not-zkf"])
def test_info_matches_jax(data, capsys, tmp_path, monkeypatch, srcs):
    d, _ = data
    _, _, (rc, out, err) = _both(["info", *[d / s for s in srcs]], capsys,
                                 tmp_path, monkeypatch)
    if srcs[-1] in ("missing.zkf", "reads.fastq"):
        assert rc == 1 and err.startswith("error: ")
    else:
        assert rc == 0 and len(out.splitlines()) == len(srcs)


@pytest.mark.parametrize("codec", [[], ["--codec", "delta"]],
                         ids=["raw", "delta"])
def test_casket_verbs_match_jax(data, capsys, tmp_path, monkeypatch, codec):
    d, _ = data
    steps = [
        ["casket", "new", "m.zkc", f"a={d / 'a.zkf'}", f"e={d / 'empty.zkf'}",
         *codec],
        ["casket", "add", "m.zkc", "b", d / "b.zkf", *codec],
        ["casket", "add", "m.zkc", "a", f"{d / 'c.zkc'}#noc", *codec],
        ["casket", "ls", "m.zkc"],
        ["casket", "extract", "m.zkc", "b", "b.zkf", *codec],
        ["casket", "add", "n.zkc", "x", d / "a.zkf"],   # creates the casket
    ]
    for argv in steps:
        port, jax_, (rc, _, err) = _both(argv, capsys, tmp_path, monkeypatch)
        assert rc == 0, err
    for name in ("m.zkc", "b.zkf", "n.zkc"):
        assert (port / name).read_bytes() == (jax_ / name).read_bytes(), name
    toc = json.loads(_both(["casket", "ls", "m.zkc"], capsys, tmp_path,
                           monkeypatch)[2][1])
    # a replaced member moves to the end
    assert [m["name"] for m in toc["members"]] == ["e", "b", "a"]


@pytest.mark.parametrize("argv", [
    ["casket", "new", "m.zkc", "a"],                      # not NAME=SET
    ["casket", "ls", "a.zkf"],                            # not a casket
    ["casket", "extract", "c.zkc", "zz", "o.zkf"],        # no such member
])
def test_casket_errors_match_jax(data, capsys, tmp_path, monkeypatch, argv):
    d, _ = data
    argv = [str(d / a) if a in ("a.zkf", "c.zkc") else a for a in argv]
    _, _, (rc, out, err) = _both(argv, capsys, tmp_path, monkeypatch)
    assert rc == 1 and out == "" and err.startswith("error: ")


_COUNTS = ("reads", "bases", "kmers", "unique", "n_chips", "routed_per_shard")


@pytest.mark.parametrize("flags", [[], ["--shards", "4"], ["--host"],
                                   ["--shards", "2", "--shard-hash",
                                    "mixed"]],
                         ids=["one", "shards4", "host", "mixed2"])
def test_kmerize_metrics_line_matches_jax(data, capsys, tmp_path, flags):
    d, _ = data
    lines = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", zcli.main, [])):
        m = tmp_path / f"{name}.jsonl"
        rc, out, err = _run(main, [
            "kmerize", "-k", K, "--batch-reads", 64, "--max-len", 128,
            "--metrics", m, *flags,
            *([] if "--host" in flags else extra),
            tmp_path / f"{name}.zkf", d / "reads.fastq"], capsys)
        assert rc == 0, err
        rows = [json.loads(x) for x in m.read_text().splitlines()]
        assert len(rows) == 1
        lines[name] = (rows[0], json.loads(out.splitlines()[-1]))
    (port, pstats), (jax_, _) = lines["port"], lines["jax"]
    assert set(port) == set(jax_)
    sharded = "--shards" in flags
    assert ("routing_skew" in port) == sharded
    assert port["event"] == "kmerize" and port["host"] == jax_["host"] == 0
    for key in _COUNTS:
        assert port.get(key) == jax_.get(key), key
        if key in pstats:
            assert port.get(key, pstats[key]) == pstats[key], key
    if sharded:
        routed = port["routed_per_shard"]
        assert port["routing_skew"] == jax_["routing_skew"] == (
            max(routed) / (sum(routed) / len(routed)))
    assert port["dedup_ratio"] == jax_["dedup_ratio"] == (
        port["unique"] / port["kmers"])
    assert port["bases_per_s"] > 0 and port["kmers_per_s_per_chip"] > 0


def test_kmerize_metrics_appends_and_trace_writes_json(data, capsys,
                                                       tmp_path):
    d, _ = data
    m, tdir = tmp_path / "m.jsonl", tmp_path / "tr"
    argv = ["kmerize", "-k", K, "--device", "cpu", "--batch-reads", 64,
            "--max-len", 128, "--metrics", m]
    for i in range(2):
        rc, _, err = _run(tcli.main, [*argv, *(["--trace", tdir] if i else
                                               []),
                                      tmp_path / "o.zkf", d / "reads.fastq"],
                          capsys)
        assert rc == 0, err
    rows = [json.loads(x) for x in m.read_text().splitlines()]
    assert len(rows) == 2 and rows[0]["unique"] == rows[1]["unique"] > 0
    assert os.listdir(tdir) == [metrics.TRACE_FILE]
    trace = json.loads((tdir / metrics.TRACE_FILE).read_text())
    assert trace["traceEvents"]
    got = container.read(str(tmp_path / "o.zkf"))
    assert len(got.keys) == rows[1]["unique"]


def test_profiled_on_cuda_needs_device_activity(tmp_path, monkeypatch):
    """--trace on cuda never writes a host-only trace: a profiler that
    cannot record CUDA activity raises before the block runs."""
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    ran = []
    with pytest.raises(RuntimeError, match="cannot record CUDA"):
        with metrics.profiled(str(tmp_path / "tr"), torch.device("cuda")):
            ran.append(1)
    assert not ran and not (tmp_path / "tr").exists()
    with metrics.profiled(None, torch.device("cuda")):
        ran.append(1)
    assert ran == [1]


def test_kmerize_trace_on_cuda_without_a_card_exits_1(data, capsys,
                                                      tmp_path, monkeypatch):
    d, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(tcli.main, ["kmerize", "-k", K, "--trace",
                                    tmp_path / "tr", tmp_path / "o.zkf",
                                    d / "reads.fastq"], capsys)
    assert rc == 1 and out == "" and "--device cuda" in err
    assert not (tmp_path / "tr").exists()


@pytest.mark.parametrize("fields", [
    dict(reads=10, bases=1000, kmers=900, unique=300),
    dict(reads=0, bases=0, kmers=0, unique=0),
    dict(reads=5, bases=500, kmers=400, unique=100, n_chips=4,
         routed_per_shard=[150, 100, 100, 50]),
    dict(reads=1, bases=10, kmers=0, unique=0, n_chips=2,
         routed_per_shard=[0, 0])], ids=["one", "empty", "sharded", "zeros"])
@pytest.mark.parametrize("wall", [0.0, 2.5])
def test_stage_metrics_and_timed_match_jax(tmp_path, fields, wall):
    """``kmerize_stage_metrics`` on the port's Stats equals the JAX
    package's on its own, and ``MetricsLogger.log`` of it writes the same
    record but for the clock. (The port has no ``timed``: its stages are
    ``metrics.span``s in a profiler's trace, tests/test_torch_spans.py.)"""
    from zotpu import metrics as zmetrics
    from zotpu.workloads import kmerize as ZW
    from zotpu_torch.workloads import kmerize as TW
    n = fields.get("n_chips", 1)
    port = metrics.kmerize_stage_metrics(TW.Stats(**fields), wall, n)
    assert port == zmetrics.kmerize_stage_metrics(ZW.Stats(**fields), wall,
                                                  n)
    recs = {}
    for name, mod in (("port", metrics), ("jax", zmetrics)):
        log = mod.MetricsLogger(str(tmp_path / f"{name}.jsonl"), host_id=3)
        returned = log.log("kmerize", batch=7, **port)
        log.close()
        lines = (tmp_path / f"{name}.jsonl").read_text().splitlines()
        assert len(lines) == 1 and json.loads(lines[0]) == returned
        recs[name] = returned
    for rec in recs.values():
        assert rec.pop("ts") > 0
    assert recs["port"] == recs["jax"] == {"host": 3, "event": "kmerize",
                                           "batch": 7, **port}
