"""``python -m zotpu_torch scan`` and ``union|intersect|diff`` with
``--num-processes 2`` on the CPU (gloo), L = 1 and L = 2 slots a process.

scan (prefix and mixed owners, ``--per-read --out-reads``): process 0
prints every sample's summary line, equal to the single-controller port's
at the same ``--shards``, to ``python -m zotpu scan --shards 4`` (in
process, 8 fake devices) and to ``--host``; the owner of a sample (samples
go round-robin) prints its per-read rows, equal to the single run's; the
``.p0``/``.p1`` read files hold the single run's reads between them, each
the reads of its own samples. The set ops run streamed: process 0 writes a
container equal to ``--host`` and the single-controller ``--stream`` run,
and prints the same line; the container also equals ``python -m zotpu
union|intersect|diff --shards 4``. Tolerance: exact equality (bytes of
every line)."""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_multiproc_mesh import run_cli_commands
from zotpu import cli as zcli
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu_torch import cli as tcli

torch.set_num_threads(1)

K = 25
SCAN = ["--batch-reads", 32, "--max-len", 128, "--per-read"]
CASES = [(2, "prefix"), (4, "prefix"), (4, "mixed")]
OPS = ("union", "intersect", "diff")


def _write_fastq(path, reads, tag):
    with open(path, "w") as f:
        f.write("".join(f"@{tag}_{i}\n{r}\n+\n{'I' * len(r)}\n"
                        for i, r in enumerate(reads)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A panel of a genome's first 3 kbp, three samples of ragged reads
    (half from the panel region, N bases, one overlong record), and two
    sets A and B with shared keys and counts."""
    rng = np.random.default_rng(23)
    genome = rng.choice(list("ACGT"), size=8000)
    d = tmp_path_factory.mktemp("mps")
    panel_k, _ = G.kmerize(K, ["".join(genome[:3000])])
    container.write(str(d / "panel.zkf"),
                    container.KmerSet(k=K, keys=panel_k))
    samples = []
    for j, n_reads in enumerate((60, 45, 20)):
        reads = []
        for _ in range(n_reads):
            n = int(rng.integers(20, 121))
            off = int(rng.integers(0, len(genome) - n))
            r = genome[off:off + n].copy()
            r[rng.random(n) < 0.02] = "N"
            reads.append("".join(r))
        reads.append("".join(genome[500:800]))
        _write_fastq(d / f"s{j}.fastq", reads, f"s{j}")
        samples.append(str(d / f"s{j}.fastq"))
    a = np.unique(rng.integers(0, 1 << (2 * K), 3000, dtype=np.uint64))
    b = np.unique(np.concatenate([a[::3], rng.integers(
        0, 1 << (2 * K), 2000, dtype=np.uint64)]))
    for name, keys in (("a", a), ("b", b)):
        container.write(str(d / f"{name}.zkf"), container.KmerSet(
            k=K, keys=keys, counts=rng.integers(
                1, 60, len(keys)).astype(np.uint32)))
    return d, str(d / "panel.zkf"), samples


def _scan_argv(d, panel, samples, shards, shard_hash, tag):
    return ["scan", *SCAN, "--device", "cpu", "--shards", shards,
            "--shard-hash", shard_hash, "--out-reads", d / f"{tag}.fq",
            panel, *samples]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    d, panel, samples = data
    cmds = [_scan_argv(d, panel, samples, s, h, f"m{s}{h}")
            for s, h in CASES]
    for shards in (2, 4):
        cmds += [[op, "--device", "cpu", "--shards", shards,
                  d / f"m{op}{shards}.zkf", d / "a.zkf", d / "b.zkf"]
                 for op in OPS]
    return run_cli_commands(tmp_path_factory.mktemp("mps_run"), cmds)


def _cli(main, argv, capsys):
    capsys.readouterr()
    assert main([str(a) for a in argv]) == 0
    return capsys.readouterr().out


def _records(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [tuple(lines[i:i + 4]) for i in range(0, len(lines), 4)]


@pytest.mark.parametrize("shards,shard_hash", CASES,
                         ids=[f"L{s // 2}-{h}" for s, h in CASES])
def test_scan_two_processes(data, runs, capsys, shards, shard_hash):
    d, panel, samples = data
    (rc0, out0), (rc1, out1) = runs[CASES.index((shards, shard_hash))]
    assert rc0 == rc1 == 0
    single = _cli(tcli.main, _scan_argv(d, panel, samples, shards,
                                        shard_hash, "single"), capsys)
    summary = [x for x in single.splitlines() if x.startswith("{")]
    jax = _cli(zcli.main, ["scan", *SCAN, "--shards", 4, "--shard-hash",
                           shard_hash, panel, *samples], capsys)
    host = _cli(zcli.main, ["scan", *SCAN, "--host", panel, *samples],
                capsys)
    assert jax == host == single
    assert [x for x in out0.splitlines() if x.startswith("{")] == summary
    assert not [x for x in out1.splitlines() if x.startswith("{")]
    rows = {}
    for x in single.splitlines():
        if not x.startswith("{"):
            rows.setdefault(x.split("\t")[0], []).append(x)
    assert sum(len(r) for r in rows.values()) > 100
    for pid, out in enumerate((out0, out1)):
        mine = [x for x in out.splitlines() if not x.startswith("{")]
        assert mine == [x for s in samples[pid::2] for x in rows[s]]
        recs = _records(d / f"m{shards}{shard_hash}.fq.p{pid}")
        assert {r[0].split("_")[0] for r in recs} == {
            f"@s{j}" for j in range(pid, 3, 2)}
        assert recs == [r for r in _records(d / "single.fq")
                        if int(r[0][2:].split("_")[0]) % 2 == pid]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shards", [2, 4], ids=["L1", "L2"])
def test_setops_two_processes(data, runs, capsys, op, shards):
    d, _, _ = data
    j = len(CASES) + (shards // 4) * len(OPS) + OPS.index(op)
    (rc0, out0), (rc1, out1) = runs[j]
    assert rc0 == rc1 == 0
    single_out = d / f"s{op}{shards}.zkf"
    line = _cli(tcli.main, [op, "--device", "cpu", "--stream", "--shards",
                            shards, single_out, d / "a.zkf", d / "b.zkf"],
                capsys)
    assert out0 == line and out1 == ""
    host_out, jax_out = d / f"h{op}{shards}.zkf", d / f"j{op}{shards}.zkf"
    _cli(zcli.main, [op, "--host", host_out, d / "a.zkf", d / "b.zkf"],
         capsys)
    _cli(zcli.main, [op, "--shards", 4, jax_out, d / "a.zkf", d / "b.zkf"],
         capsys)
    got = container.read(str(d / f"m{op}{shards}.zkf"))
    for other in (single_out, host_out, jax_out):
        want = container.read(str(other))
        assert got.k == want.k == K
        assert np.array_equal(got.keys, want.keys)
        assert np.array_equal(got.counts, want.counts)
    assert json.loads(line)["cards"]["a"] == container.read(
        str(d / "a.zkf")).n
