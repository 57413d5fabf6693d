"""``python -m zotpu_torch kmerize --num-processes 2`` on the CPU (gloo):
two processes with L = 1 and L = 2 slots each (``--shards 2`` and 4),
prefix and mixed owners, against the port's single-controller run at the
same ``--shards``, ``python -m zotpu kmerize --shards 4`` in process (the
8 fake devices), and ``--host``. An input of one file leaves process 1
drained from the start. Tolerance: exact equality of k, keys and counts,
and of the stats line's reads, bases, kmers, unique, n_chips and
routed_per_shard (``batches`` counts each process's own parsed batches)."""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_multiproc_mesh import (free_port, run_cli_commands,
                                             spawn)
from zotpu import cli as zcli
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu_torch import cli as tcli

torch.set_num_threads(1)

K = 21
FLAGS = ["-k", K, "--batch-reads", 64, "--max-len", 128]
CASES = [(2, "prefix"), (2, "mixed"), (4, "prefix"), (4, "mixed")]


def _write_fastq(path, reads, tag):
    with open(path, "w") as f:
        f.write("".join(f"@{tag}_{i}\n{r}\n+\n{'I' * len(r)}\n"
                        for i, r in enumerate(reads)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three files of one genome's reads (ragged, N bases, one record
    longer than --max-len, so halo-chunked over rows): 170, 90 and 40
    reads, so the processes parse unequal batch counts."""
    rng = np.random.default_rng(41)
    genome = rng.choice(list("ACGT"), size=5000)
    d = tmp_path_factory.mktemp("mpk")
    paths, seqs = [], []
    for j, n_reads in enumerate((170, 90, 40)):
        reads = []
        for _ in range(n_reads):
            n = int(rng.integers(30, 121))
            off = int(rng.integers(0, len(genome) - n))
            r = genome[off:off + n].copy()
            r[rng.random(n) < 0.01] = "N"
            reads.append("".join(r))
        if j == 0:
            reads.append("".join(genome[100:400]))
        _write_fastq(d / f"f{j}.fastq", reads, f"f{j}")
        paths.append(str(d / f"f{j}.fastq"))
        seqs += reads
    return d, paths, seqs


def _out_path(d, shards, shard_hash):
    return str(d / f"m{shards}_{shard_hash}.zkf")


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Every two-process command of this file, in one process group."""
    d, paths, _ = data
    cmds = [["kmerize", *FLAGS, "--device", "cpu", "--shards", s,
             "--shard-hash", h, _out_path(d, s, h), *paths]
            for s, h in CASES]
    cmds.append(["kmerize", *FLAGS, "--device", "cpu", "--shards", 4,
                 str(d / "one.zkf"), paths[0]])
    return run_cli_commands(tmp_path_factory.mktemp("mpk_run"), cmds)


@pytest.fixture(scope="module")
def jax4(data):
    """python -m zotpu kmerize --shards 4 (prefix and mixed) and --host, in
    process: (keys, counts, stats line)."""
    d, paths, _ = data
    out = {}
    for name, extra in (("prefix", ["--shards", 4]),
                        ("mixed", ["--shards", 4, "--shard-hash", "mixed"]),
                        ("host", ["--host"])):
        path = str(d / f"jax_{name}.zkf")
        assert zcli.main([str(a) for a in ["kmerize", *FLAGS, *extra, path,
                                           *paths]]) == 0
        ks = container.read(path)
        out[name] = (ks.keys, ks.counts)
    return out


def _single(d, paths, shards, shard_hash, capsys, tag=""):
    path = str(d / f"single{tag}{shards}_{shard_hash}.zkf")
    capsys.readouterr()
    assert tcli.main([str(a) for a in [
        "kmerize", *FLAGS, "--device", "cpu", "--shards", shards,
        "--shard-hash", shard_hash, path, *paths]]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    return container.read(path), line


def _last_json(out):
    """The last JSON line of a process's output (gloo may log to it)."""
    return json.loads([x for x in out.splitlines() if x.startswith("{")][-1])


def _same_line(got, want):
    drop = lambda x: {k: v for k, v in x.items() if k != "batches"}
    assert drop(got) == drop(want)


@pytest.mark.parametrize("shards,shard_hash", CASES,
                         ids=[f"L{s // 2}-{h}" for s, h in CASES])
def test_kmerize_two_processes_match_single_jax_and_host(
        data, runs, jax4, capsys, shards, shard_hash):
    d, paths, seqs = data
    (rc0, out0), (rc1, out1) = runs[CASES.index((shards, shard_hash))]
    assert rc0 == rc1 == 0
    got = container.read(_out_path(d, shards, shard_hash))
    single, line = _single(d, paths, shards, shard_hash, capsys)
    want_k, want_c = G.kmerize(K, seqs)
    assert got.k == single.k == K
    for keys, counts in ((single.keys, single.counts), jax4[shard_hash],
                         jax4["host"], (want_k, want_c)):
        assert np.array_equal(got.keys, keys)
        assert np.array_equal(got.counts, counts)
    lines = [_last_json(o) for o in (out0, out1)]
    for x in lines:
        _same_line(x, line)
        assert x["n_chips"] == shards
    # each process counted its own batches: files 0 and 2 for process 0
    assert lines[0]["batches"] + lines[1]["batches"] >= line["batches"]
    assert got.meta["inputs"] == paths[0::2]
    assert got.meta["tool"] == "zotpu_torch kmerize"


def test_kmerize_one_file_leaves_a_process_drained(data, runs, jax4,
                                                   capsys):
    """Process 1 has no file: it feeds all-padding rows in every step, and
    the result is the one file's set."""
    d, paths, _ = data
    (rc0, out0), (rc1, out1) = runs[-1]
    assert rc0 == rc1 == 0
    got = container.read(str(d / "one.zkf"))
    single, line = _single(d, paths[:1], 4, "prefix", capsys, tag="one")
    assert np.array_equal(got.keys, single.keys)
    assert np.array_equal(got.counts, single.counts)
    lines = [_last_json(o) for o in (out0, out1)]
    _same_line(lines[0], line)
    _same_line(lines[1], line)
    assert lines[1]["batches"] == 0 and lines[0]["batches"] > 1


def test_kmerize_cli_processes_join_their_own_group(data, tmp_path, capsys):
    """``python -m zotpu_torch`` itself in two processes: the CLI joins
    the group, defaults --shards to the process count and leaves; process
    0 alone writes the container."""
    d, paths, _ = data
    out = str(tmp_path / "cli.zkf")
    port = free_port()
    res = spawn([["-m", "zotpu_torch", "kmerize", *FLAGS, "--device", "cpu",
                  "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                  2, "--process-id", pid, out, *paths] for pid in range(2)])
    for rc, o in res:
        assert rc == 0, o
    single, line = _single(d, paths, 2, "prefix", capsys, tag="cli")
    got = container.read(out)
    assert np.array_equal(got.keys, single.keys)
    assert np.array_equal(got.counts, single.counts)
    for _, o in res:
        _same_line(_last_json(o), line)
