"""``kmerize --spill-dir/--resume`` of the port with ``--num-processes 2``
on the CPU (gloo), 4 slots: every process writes its own slots' rows of a
batch as ``run{batch:06d}.p{pid}.zkf``; a run crashed after one batch and
resumed reuses each process's file and equals the uninterrupted run (same
run files, byte for byte), ``python -m zotpu kmerize --shards 4`` in
process and golden; a process that lost a run file makes that batch
recompute on every process; a directory left by four processes is
recomputed under two (the stamp's ``process_count``). Tolerance: exact
equality of keys, counts and run-file bytes."""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_multiproc_mesh import run_cli_commands
from zotpu import cli as zcli
from zotpu.io import container
from zotpu.reference_impl import golden as G

torch.set_num_threads(1)

K = 21
FLAGS = ["-k", K, "--batch-reads", 64, "--max-len", 128, "--device", "cpu",
         "--shards", 4]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(77)
    genome = rng.choice(list("ACGT"), size=4000)
    d = tmp_path_factory.mktemp("mpsp")
    paths, seqs = [], []
    for j, n_reads in enumerate((100, 70)):
        reads = ["".join(genome[o:o + 90]) for o in
                 rng.integers(0, len(genome) - 90, n_reads)]
        with open(d / f"f{j}.fastq", "w") as f:
            f.write("".join(f"@f{j}_{i}\n{r}\n+\n{'I' * len(r)}\n"
                            for i, r in enumerate(reads)))
        paths.append(str(d / f"f{j}.fastq"))
        seqs += reads
    for name in ("crash", "clean", "mixed", "four"):
        (d / name).mkdir()
    return d, paths, seqs


def _kmerize(d, paths, out, spill, *extra):
    return ["kmerize", *FLAGS, *extra, "--spill-dir", d / spill, d / out,
            *paths]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """A four-process spill run, then the two-process commands."""
    d, paths, _ = data
    tmp = tmp_path_factory.mktemp("mpsp_run")
    four = run_cli_commands(tmp, [_kmerize(d, paths, "four.zkf", "four")],
                            nproc=4)
    crash = {"crash": {"paths": paths, "k": K, "shards": 4,
                       "batch_reads": 64, "max_len": 128,
                       "spill_dir": str(d / "crash"),
                       "shard_hash": "prefix", "fail_after": 1}}
    two = run_cli_commands(tmp, [
        crash,                                                    # 0
        {"mtimes": str(d / "crash")},                             # 1
        _kmerize(d, paths, "resumed.zkf", "crash", "--resume"),   # 2
        {"mtimes": str(d / "crash")},                             # 3
        {"remove": str(d / "crash" / "run000002.p0.zkf"), "pid": 0},
        _kmerize(d, paths, "again.zkf", "crash", "--resume"),     # 5
        {"mtimes": str(d / "crash")},                             # 6
        _kmerize(d, paths, "clean.zkf", "clean"),                 # 7
        _kmerize(d, paths, "mixed.zkf", "mixed", "--shard-hash", "mixed"),
        _kmerize(d, paths, "from4.zkf", "four", "--resume"),      # 9
    ])
    return four, two


@pytest.fixture(scope="module")
def want(data):
    """golden, and python -m zotpu kmerize --shards 4 (spill mode)."""
    d, paths, seqs = data
    jdir = d / "jax"
    jdir.mkdir()
    assert zcli.main([str(a) for a in [
        "kmerize", "-k", K, "--batch-reads", 64, "--max-len", 128,
        "--shards", 4, "--spill-dir", jdir, d / "jax.zkf", *paths]]) == 0
    jx = container.read(str(d / "jax.zkf"))
    gk, gc = G.kmerize(K, seqs)
    assert np.array_equal(jx.keys, gk) and np.array_equal(jx.counts, gc)
    return gk, gc


def _same(path, want):
    ks = container.read(str(path))
    assert np.array_equal(ks.keys, want[0])
    assert np.array_equal(ks.counts, want[1])


def _names(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".zkf"))


def test_crash_then_resume_reuses_each_process_file(data, runs, want):
    d, _, _ = data
    _, two = runs
    assert [rc for rc, _ in two[0]] == [3, 3]     # both crashed in step
    assert "before batch 2" in two[0][0][1]
    first = json.loads(two[1][0][1])
    assert sorted(first) == ["run000001.p0.zkf", "run000001.p1.zkf"]
    assert [rc for rc, _ in two[2]] == [0, 0]
    after = json.loads(two[3][0][1])
    for name, t in first.items():
        assert after[name] == t                   # reused, not rewritten
    _same(d / "resumed.zkf", want)
    _same(d / "clean.zkf", want)
    names = _names(d / "clean")
    assert names == sorted(after) and len(names) >= 6
    assert {n.split(".")[1] for n in names} == {"p0", "p1"}
    for n in names:   # the same bytes as the uninterrupted run's files
        assert (d / "clean" / n).read_bytes() == (d / "crash" / n
                                                  ).read_bytes()
        meta = container.read(str(d / "clean" / n)).meta
        assert meta["process_count"] == 2
        assert meta["process_index"] == int(n.split(".")[1][1:])


def test_a_lost_run_file_recomputes_the_batch_everywhere(data, runs, want):
    d, _, _ = data
    _, two = runs
    assert [rc for rc, _ in two[5]] == [0, 0]
    before, after = json.loads(two[3][0][1]), json.loads(two[6][0][1])
    assert sorted(after) == sorted(before)
    for name in before:
        changed = after[name] != before[name]
        assert changed == name.startswith("run000002."), name
    _same(d / "again.zkf", want)


def test_mixed_owner_spill_and_a_four_process_directory(data, runs, want):
    d, _, _ = data
    four, two = runs
    assert all(rc == 0 for rc, _ in four[0])
    _same(d / "four.zkf", want)
    _same(d / "mixed.zkf", want)
    assert {n.split(".")[1] for n in _names(d / "mixed")} == {"p0", "p1"}
    # resumed by two processes: the p0 / p1 files of four processes cover
    # other slots and rows (their stamps say so), so every batch of the
    # two-process run recomputes and rewrites its files
    assert [rc for rc, _ in two[9]] == [0, 0]
    _same(d / "from4.zkf", want)
    steps = len(_names(d / "clean")) // 2
    for n in _names(d / "four"):
        meta = container.read(str(d / "four" / n)).meta
        pid, batch = int(n.split(".")[1][1:]), int(n[3:9])
        assert meta["process_count"] == (2 if pid < 2 and batch <= steps
                                         else 4), n
