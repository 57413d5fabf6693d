"""``kmerize --spill-dir/--resume`` of the port against the JAX package on
the CPU, one device and ``--shards 4`` (the JAX package on the 8-fake-device
mesh), on the wire path (32 | max_len) and the u8 path. The run files are
the contract between the two packages: names, keys, counts and the stamp in
the meta are equal file by file (the files are byte-equal), and either
package resumes a directory the other left. Tolerance: exact equality."""

import json
import os

import numpy as np
import pytest
import torch

from zotpu import cli as zcli
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu.workloads import kmerize as JW
from zotpu_torch import cli as tcli
from zotpu_torch.workloads import kmerize as TW
from zotpu_torch.workloads import setops as TS

torch.set_num_threads(1)

K = 21
BATCH = 64


def _write_fastq(path, reads):
    with open(path, "w") as f:
        f.write("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                        for i, r in enumerate(reads)))


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    """400 reads of one genome (so k-mers recur over batches), ragged, with
    N bases and one record longer than every --max-len; and a second file."""
    rng = np.random.default_rng(99)
    genome = rng.choice(list("ACGT"), size=6000)
    reads = []
    for _ in range(400):
        n = int(rng.integers(30, 101))
        off = int(rng.integers(0, len(genome) - n))
        r = genome[off:off + n].copy()
        r[rng.random(n) < 0.01] = "N"
        reads.append("".join(r))
    reads.append("".join(genome[200:600]))
    d = tmp_path_factory.mktemp("spill")
    _write_fastq(d / "r.fastq", reads)
    _write_fastq(d / "r2.fastq", reads[:150])
    return str(d / "r.fastq"), str(d / "r2.fastq"), reads


def _port(paths, spill=None, shards=1, max_len=128, k=K, batch=BATCH, **kw):
    if spill is not None:
        os.makedirs(spill, exist_ok=True)
    stats = TW.Stats()
    common = dict(batch_reads=batch, max_len=max_len, stats=stats,
                  spill_dir=spill and str(spill), device="cpu", **kw)
    if shards > 1:
        out = TW.kmerize_paths_sharded(paths, k, shards, **common)
    else:
        out = TW.kmerize_paths(paths, k, **common)
    return out, stats


def _jax(paths, spill=None, shards=1, max_len=128, k=K, batch=BATCH, **kw):
    if spill is not None:
        os.makedirs(spill, exist_ok=True)
    stats = JW.Stats()
    common = dict(batch_reads=batch, max_len=max_len, stats=stats,
                  spill_dir=spill and str(spill), **kw)
    if shards > 1:
        out = JW.kmerize_paths_sharded(paths, k, shards, **common)
    else:
        out = JW.kmerize_paths(paths, k, **common)
    return out, stats


def _same(a, b):
    assert a[0].dtype == b[0].dtype == np.uint64
    assert a[1].dtype == b[1].dtype == np.uint32
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _runs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".zkf"))


def _assert_dirs_equal(port_dir, jax_dir):
    names = _runs(port_dir)
    assert names == _runs(jax_dir) and len(names) > 3
    assert names[0] == "run000001.zkf"
    for name in names:
        p = container.read(os.path.join(port_dir, name))
        j = container.read(os.path.join(jax_dir, name))
        assert p.k == j.k and p.meta == j.meta, name
        _same((p.keys, p.counts), (j.keys, j.counts))
        with open(os.path.join(port_dir, name), "rb") as f, \
                open(os.path.join(jax_dir, name), "rb") as g:
            assert f.read() == g.read(), name
    return names


@pytest.mark.parametrize("max_len", [128, 100], ids=["wire", "u8"])
@pytest.mark.parametrize("shards", [1, 4])
def test_spill_run_matches_accumulator_and_jax(fq, tmp_path, shards, max_len):
    path, _, reads = fq
    got, stats = _port([path], tmp_path / "p", shards, max_len)
    want, jstats = _jax([path], tmp_path / "j", shards, max_len)
    _same(got, want)
    _same(got, _port([path], None, shards, max_len)[0])
    _same(got, G.kmerize(K, reads))
    assert stats.as_dict() == jstats.as_dict()
    names = _assert_dirs_equal(tmp_path / "p", tmp_path / "j")
    assert len(names) == stats.batches
    meta = container.read(str(tmp_path / "p" / names[2])).meta
    want_meta = {"run": 3, "k": K, "batch_reads": BATCH, "max_len": max_len}
    if shards > 1:
        want_meta.update(process_count=1, process_index=0, n_shards=shards,
                         shard_hash="prefix")
    assert meta == want_meta
    # and the directory alone rebuilds the set
    _same(TW.resume_from_spills(str(tmp_path / "p"), device="cpu"), got)
    _same(JW.resume_from_spills(str(tmp_path / "p")), got)


def test_sharded_spill_mixed_hash_matches_jax(fq, tmp_path):
    path, _, reads = fq
    got, stats = _port([path], tmp_path / "p", 4, shard_hash="mixed")
    want, jstats = _jax([path], tmp_path / "j", 4, shard_hash="mixed")
    _same(got, want)
    _same(got, G.kmerize(K, reads))
    assert stats.routed_per_shard == jstats.routed_per_shard
    _assert_dirs_equal(tmp_path / "p", tmp_path / "j")


@pytest.mark.parametrize("shards", [1, 4])
def test_crash_and_resume(fq, tmp_path, shards):
    """Fault injection: exactly N run files exist after a crash past batch
    N, a resume recomputes the rest, and the result equals the
    uninterrupted spill run's and the accumulator's."""
    path, _, reads = fq
    clean, cstats = _port([path], tmp_path / "clean", shards)
    with pytest.raises(TW.Interrupted, match="before batch 3"):
        _port([path], tmp_path / "s", shards, fail_after_batches=2)
    assert _runs(tmp_path / "s") == ["run000001.zkf", "run000002.zkf"]
    with pytest.raises(JW.Interrupted):
        _jax([path], tmp_path / "js", shards, fail_after_batches=2)
    assert _runs(tmp_path / "js") == _runs(tmp_path / "s")
    before = {n: os.stat(tmp_path / "s" / n).st_mtime_ns
              for n in _runs(tmp_path / "s")}
    got, stats = _port([path], tmp_path / "s", shards, resume=True)
    _same(got, clean)
    _same(got, G.kmerize(K, reads))
    assert stats.kmers == cstats.kmers and stats.batches == cstats.batches
    assert _runs(tmp_path / "s") == _runs(tmp_path / "clean")
    for n, t in before.items():             # the completed runs were reused
        assert os.stat(tmp_path / "s" / n).st_mtime_ns == t


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("first", ["port", "jax"])
def test_either_package_resumes_the_others_directory(fq, tmp_path, first,
                                                     shards):
    path, _, reads = fq
    crash, resume = (_port, _jax) if first == "port" else (_jax, _port)
    err = TW.Interrupted if first == "port" else JW.Interrupted
    d = tmp_path / "s"
    with pytest.raises(err):
        crash([path], d, shards, fail_after_batches=3)
    assert len(_runs(d)) == 3
    # the other package accepts every run file the first one left ...
    stamp = {"k": K, "batch_reads": BATCH, "max_len": 128}
    if shards > 1:
        stamp.update(process_count=1, process_index=0, n_shards=shards,
                     shard_hash="prefix")
    load = JW._load_run_if_valid if first == "port" else TW._load_run_if_valid
    for n in _runs(d):
        assert load(str(d / n), stamp) is not None
    before = {n: os.stat(d / n).st_mtime_ns for n in _runs(d)}
    # ... and finishes the run from them
    got, _ = resume([path], d, shards, resume=True)
    _same(got, G.kmerize(K, reads))
    for n, t in before.items():
        assert os.stat(d / n).st_mtime_ns == t


def test_resume_recomputes_stale_k_and_stale_batch_reads(fq, tmp_path):
    path, _, reads = fq
    d = tmp_path / "s"
    with pytest.raises(TW.Interrupted):
        _port([path], d, fail_after_batches=2)
    got, _ = _port([path], d, k=25, resume=True)            # stale k
    _same(got, G.kmerize(25, reads))
    got, _ = _port([path], d, batch=32, resume=True)        # stale batching
    _same(got, G.kmerize(K, reads))
    got, _ = _port([path], d, max_len=96, batch=32, resume=True)
    _same(got, G.kmerize(K, reads))
    assert container.read(str(d / "run000001.zkf")).meta["max_len"] == 96


@pytest.mark.parametrize("first", ["port", "jax"])
def test_plain_resume_recomputes_a_sharded_directory(fq, tmp_path, first):
    """A sharded run's files carry layout keys that a plain resume's stamp
    lacks: they cover another batch layout and are recomputed. The reverse
    holds too (the sharded stamp's keys are missing from a plain file)."""
    path, _, reads = fq
    d = tmp_path / "s"
    (_port if first == "port" else _jax)([path], d, 4)
    assert "n_shards" in container.read(str(d / "run000001.zkf")).meta
    got, _ = _port([path], d, resume=True)
    _same(got, G.kmerize(K, reads))
    assert "n_shards" not in container.read(str(d / "run000001.zkf")).meta
    got, _ = _port([path], d, 4, resume=True)
    _same(got, G.kmerize(K, reads))
    got, _ = _port([path], d, 2, resume=True)       # another slot count
    _same(got, G.kmerize(K, reads))
    assert container.read(str(d / "run000001.zkf")).meta["n_shards"] == 2


def test_resume_from_spills_rejects_mixed_stamps(fq, tmp_path):
    path, _, _ = fq
    d = tmp_path / "s"
    with pytest.raises(TW.Interrupted):
        _port([path], d, batch=16, fail_after_batches=9)
    _port([path], d, batch=128)     # overwrites the batch numbers it reaches
    assert len(_runs(d)) == 9
    msgs = []
    for fn, kw in ((TW.resume_from_spills, {"device": "cpu"}),
                   (JW.resume_from_spills, {})):
        with pytest.raises(ValueError, match="different layouts") as e:
            fn(str(d), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("shards", [1, 4])
def test_two_files_in_spill_mode_give_the_same_runs_twice(fq, tmp_path,
                                                          monkeypatch,
                                                          shards):
    """Spill mode parses the files one after another (no worker pool), so
    that run N covers the same reads on every run; a pool would interleave
    the files' batches as they come."""
    path, second, reads = fq
    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", "4")
    seen = []
    real = TW._iter_batches
    monkeypatch.setattr(TW, "_iter_batches", lambda *a, **kw: seen.append(
        kw.get("parallel")) or real(*a, **kw))
    got, _ = _port([path, second], tmp_path / "p1", shards)
    _port([path, second], tmp_path / "p2", shards)
    _port([path, second], None, shards)
    assert seen == [False, False, True]
    want, _ = _jax([path, second], tmp_path / "j", shards)
    _same(got, want)
    _same(got, G.kmerize(K, reads + reads[:150]))
    _assert_dirs_equal(tmp_path / "p1", tmp_path / "p2")
    _assert_dirs_equal(tmp_path / "p1", tmp_path / "j")
    # a crash in the second file resumes without counting a read twice
    n = len(_runs(tmp_path / "p1"))
    d = tmp_path / "s"
    with pytest.raises(TW.Interrupted):
        _port([path, second], d, shards, fail_after_batches=n - 1)
    _same(_port([path, second], d, shards, resume=True)[0], got)


@pytest.mark.parametrize("force_host", [False, True])
@pytest.mark.parametrize("total", ["below", "at", "above"])
def test_merge_runs_on_both_sides_of_the_threshold(monkeypatch, total,
                                                   force_host):
    rng = np.random.default_rng(4)
    runs = []
    for _ in range(5):
        keys = np.unique(rng.integers(0, 5000, 400, dtype=np.uint64))[:300]
        runs.append((keys, rng.integers(1, 9, 300).astype(np.uint32)))
    n = sum(len(r[0]) for r in runs)
    threshold = {"below": n + 1, "at": n, "above": n - 1}[total]
    monkeypatch.setattr(TW, "DEVICE_MERGE_THRESHOLD", threshold)
    monkeypatch.setattr(JW, "DEVICE_MERGE_THRESHOLD", threshold)
    calls = []
    real = TS.merge_tree_device
    monkeypatch.setattr(TS, "merge_tree_device",
                        lambda r, device: calls.append(device) or real(
                            r, device=device))
    got = TW.merge_runs(runs, force_host=force_host, device="cpu")
    _same(got, G.merge(runs))
    _same(got, JW.merge_runs(runs, force_host=force_host))
    assert calls == ([] if force_host or total == "below" else ["cpu"])
    assert TW.DEVICE_MERGE_THRESHOLD == threshold
    _same(TW.merge_runs([], device="cpu"), JW.merge_runs([]))


def test_the_real_threshold_is_the_jax_packages():
    assert TW.DEVICE_MERGE_THRESHOLD == JW.DEVICE_MERGE_THRESHOLD == 1 << 20
    assert TW._STAMP_KEYS == JW._STAMP_KEYS


def _cli(main, argv, capsys):
    capsys.readouterr()
    rc = main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("shards", [1, 4])
def test_cli_spill_and_resume_match_jax(fq, tmp_path, capsys, shards):
    """--spill-dir and --resume through both CLIs: equal JSON lines,
    containers and run files. --resume reaches the workload: a run file
    with a valid stamp and other contents is taken as it is, by both."""
    path, _, reads = fq
    flags = ["-k", K, "--batch-reads", BATCH, "--max-len", 128]
    if shards > 1:
        flags += ["--shards", shards]
    outs = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", zcli.main, [])):
        d = tmp_path / name
        d.mkdir()
        rc, out, err = _cli(main, ["kmerize", *flags, *extra, "--spill-dir",
                                   d, tmp_path / f"{name}.zkf", path], capsys)
        assert rc == 0, err
        outs[name] = out
    assert outs["port"] == outs["jax"]
    names = _assert_dirs_equal(tmp_path / "port", tmp_path / "jax")
    want = G.kmerize(K, reads)
    ks = container.read(str(tmp_path / "port.zkf"))
    _same((ks.keys, ks.counts), want)
    assert ks.meta["stats"] == container.read(
        str(tmp_path / "jax.zkf")).meta["stats"]

    # plant batch 2's run as batch 1's (same stamp, other reads)
    for name in ("port", "jax"):
        d = tmp_path / name
        two = container.read(str(d / names[1]))
        container.write(str(d / names[0]), container.KmerSet(
            k=K, keys=two.keys, counts=two.counts,
            meta={**two.meta, "run": 1}))
    outs = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", zcli.main, [])):
        rc, out, err = _cli(main, ["kmerize", *flags, *extra, "--spill-dir",
                                   tmp_path / name, "--resume",
                                   tmp_path / f"{name}_r.zkf", path], capsys)
        assert rc == 0, err
        outs[name] = out
    assert outs["port"] == outs["jax"]
    got = container.read(str(tmp_path / "port_r.zkf"))
    jx = container.read(str(tmp_path / "jax_r.zkf"))
    _same((got.keys, got.counts), (jx.keys, jx.counts))
    assert json.loads(outs["port"])["kmers"] != int(want[1].sum())
    # without --resume the planted file is recomputed
    rc, out, _ = _cli(tcli.main, ["kmerize", *flags, "--device", "cpu",
                                  "--spill-dir", tmp_path / "port",
                                  tmp_path / "port_c.zkf", path], capsys)
    assert rc == 0
    ks = container.read(str(tmp_path / "port_c.zkf"))
    _same((ks.keys, ks.counts), want)


def test_cli_spill_with_a_multi_host_flag_exits_1(fq, tmp_path, capsys):
    """--num-processes without --process-id exits 1 with the JAX package's
    message before any process group is joined, and writes no run file."""
    argv = ["kmerize", "-k", K, "--shards", 2, "--spill-dir", tmp_path,
            "--coordinator", "127.0.0.1:1", "--num-processes", 2,
            tmp_path / "o.zkf", fq[0]]
    got = _cli(tcli.main, [*argv, "--device", "cpu"], capsys)
    assert got == _cli(zcli.main, argv, capsys)
    assert got == (1, "", "error: --num-processes needs --coordinator "
                          "HOST:PORT and --process-id\n")
    assert _runs(tmp_path) == []


def test_reads_shorter_than_k_in_spill_mode(tmp_path):
    """One batch that holds no k-mer: an empty run file, an empty set."""
    short = tmp_path / "e.fastq"
    _write_fastq(short, ["ACGT", "ACGTN"])
    for shards in (1, 2):
        got, stats = _port([str(short)], tmp_path / f"p{shards}", shards)
        want, jstats = _jax([str(short)], tmp_path / f"j{shards}", shards)
        _same(got, want)
        assert len(got[0]) == 0 and stats.as_dict() == jstats.as_dict()
        assert _runs(tmp_path / f"p{shards}") == ["run000001.zkf"]
        assert _runs(tmp_path / f"j{shards}") == ["run000001.zkf"]
