"""The host feed (``workloads/feed.py``) and the stagers
(``workloads/staging.py``) on the CPU: the record count of every parse
path's batches, the pool against the ordered feed, the copies to the host,
and the direction of the imports between the workload modules."""

import ast
import gzip
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zotpu_torch import metrics
from zotpu_torch.dist.mesh import make_mesh
from zotpu_torch.io import fastq, native
from zotpu_torch.workloads import feed, staging

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
K, BATCH, MAX_LEN, WORKERS = 21, 16, 128, 4


def _seq(rng, n):
    return "".join(rng.choice(list("ACGTN"), size=n, p=[.24] * 4 + [.04]))


def _fastq(path, rng, n, lo=30, hi=120, long_at=None):
    """n FASTQ records of lengths in [lo, hi]; the one at ``long_at`` 301
    bases long. Returns the path and the record count."""
    with open(path, "w") as f:
        for i in range(n):
            m = 301 if i == long_at else int(rng.integers(lo, hi + 1))
            f.write(f"@r{i}\n{_seq(rng, m)}\n+\n{'I' * m}\n")
    return str(path), n


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("feed")
    rng = np.random.default_rng(20)
    plain, n = _fastq(d / "r.fq", rng, 90)
    gz = d / "r.fq.gz"
    with open(plain, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    fa = d / "r.fa"
    with open(fa, "w") as f:
        for i in range(9):
            f.write(f">c{i}\n{_seq(rng, int(rng.integers(20, 700)))}\n")
    return {"plain": (plain, n), "gz": (str(gz), n), "fasta": (str(fa), 9),
            "overlong": _fastq(d / "long.fq", rng, 70, long_at=33),
            "halo": _fastq(d / "halo.fq", rng, 80, lo=40, hi=200),
            "files": [_fastq(d / f"f{i}.fq", rng, 20 + 13 * i)
                      for i in range(WORKERS)]}


def _parsed(case, inputs, monkeypatch):
    """The batches of one parse path, and the input's record count."""
    if case == "fastq_numpy":   # the fallback where no C++ compiler exists
        monkeypatch.setattr(native, "get_lib", lambda: None)
    key = {"fastq_native": "plain", "fastq_numpy": "plain", "fasta": "fasta",
           "gz": "gz", "cut_overlong": "overlong", "halo_64": "halo"}[case]
    path, n = inputs[key]
    max_len = 64 if case == "halo_64" else MAX_LEN
    if case == "cut_overlong":
        got = [b for piece, rec0 in fastq.cut_fastq(path, BATCH)
               for b in fastq.parse_fastq_piece(piece, rec0, BATCH, max_len,
                                                halo=K - 1)]
    else:
        got = list(fastq.parse_batches(path, BATCH, max_len, halo=K - 1))
    return path, n, max_len, got


@pytest.mark.parametrize("case", ["fastq_native", "fastq_numpy", "fasta",
                                  "gz", "cut_overlong", "halo_64"])
def test_run_count_equals_unique_count(inputs, monkeypatch, case):
    path, n, max_len, parsed = _parsed(case, inputs, monkeypatch)
    runs = 0
    for b in parsed:
        ids = b.record_ids[:b.n_reads]
        assert np.all(np.diff(ids) >= 0)
        starts = feed.record_starts(ids)
        assert len(starts) == len(np.unique(ids))
        assert np.array_equal(ids[starts], np.unique(ids))
        runs += len(np.unique(ids))
    assert runs >= n
    if case in ("fasta", "halo_64"):
        assert runs > n         # some record spans two batches
    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", str(WORKERS))
    got = list(feed.batches([path], BATCH, max_len, K, wire_pack=True,
                            parallel=case == "cut_overlong"))
    assert sum(n_rec for *_, n_rec in got) == n
    assert len(got) == -(-sum(b.n_reads for b in parsed) // BATCH)


def test_record_starts_of_no_rows():
    assert len(feed.record_starts(np.zeros(0, np.int64))) == 0


def _key(batch, host):
    n = batch.n_reads
    return (batch.codes[:n].tobytes(), batch.lengths[:n].tobytes(),
            batch.record_ids[:n].tobytes(), n, batch.bases,
            tuple(t.numpy().tobytes() for t in host))


@pytest.mark.parametrize("n_files", [1, 3, WORKERS],
                         ids=["one_file", "three_files", "as_many_as_workers"])
def test_pool_and_ordered_feed_give_the_same_batches(inputs, monkeypatch,
                                                     n_files):
    """One file and three are cut into pieces for the pool; as many files
    as workers are parsed whole by it."""
    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", str(WORKERS))
    files = inputs["files"][:n_files]
    paths = [p for p, _ in files]
    out = {}
    for parallel in (False, True):
        out[parallel] = list(feed.batches(paths, BATCH, MAX_LEN, K,
                                          wire_pack=True, parallel=parallel))
    ordered, pooled = out[False], out[True]
    assert (sorted(_key(b, h) for _, b, h, _ in pooled)
            == sorted(_key(b, h) for _, b, h, _ in ordered))
    for got in (ordered, pooled):
        assert sum(n_rec for *_, n_rec in got) == sum(n for _, n in files)
        for f, (_, n) in enumerate(files):
            assert sum(r for g, _, _, r in got if g == f) == n
    want = [(f, b) for f, p in enumerate(paths)
            for b in fastq.parse_batches(p, BATCH, MAX_LEN, halo=K - 1)]
    assert [f for f, *_ in ordered] == [f for f, _ in want]
    assert all(np.array_equal(b.record_ids, w.record_ids)
               and np.array_equal(b.codes, w.codes)
               for (_, b, _, _), (_, w) in zip(ordered, want))


@pytest.mark.parametrize("n_files", [1, 2, WORKERS, WORKERS + 1],
                         ids=["one_file", "fewer_than_workers",
                              "as_many_as_workers", "more_than_workers"])
def test_in_order_pool_keeps_each_file_in_order(inputs, monkeypatch,
                                                n_files):
    """With ``in_order`` the pool takes whole files whatever their number:
    each file's batches come in ``fastq.parse_batches``' order, nothing is
    cut, and ``parse.threads`` counts min(W, files) threads (1 for one
    file: the serial path). The first file holds records halo-chunked at
    ``max_len`` 64, one of them over two batches."""
    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", str(WORKERS))
    max_len = 64
    files = [inputs["halo"], *inputs["files"]][:n_files]
    paths = [p for p, _ in files]
    want = [list(fastq.parse_batches(p, BATCH, max_len, halo=K - 1))
            for p in paths]
    assert len(want[0]) > 2
    assert any(a.record_ids[a.n_reads - 1] == b.record_ids[0]
               for a, b in zip(want[0], want[0][1:]))
    metrics.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(feed.batches(paths, BATCH, max_len, K, wire_pack=True,
                                parallel=True, in_order=True))
    assert {name: v for name, v in metrics.counters().items()
            if not name.startswith("load.")} == {
        "parse.threads": min(WORKERS, n_files)}
    for f, ((_, n), mine) in enumerate(zip(files, want)):
        out = [(b, h, r) for g, b, h, r in got if g == f]
        assert [_key(b, h) for b, h, _ in out] == [
            _key(w, feed.host_tensors(w, True, False)) for w in mine]
        assert sum(r for *_, r in out) == n
    assert len(got) == sum(map(len, want))


@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_download_and_to_host_equal_cpu(n):
    t = torch.arange(n, dtype=torch.int64) * 3 - 5
    host, done = staging.Stager("cpu").download(t)
    assert done is None and torch.equal(host, t.cpu())
    parts = [t, t[: n // 2], t.flip(0)]
    got = staging.to_host(parts)
    assert len(got) == 3
    assert all(g.dtype == torch.int64 and torch.equal(g, p.cpu())
               for g, p in zip(got, parts))


def test_stagers_give_each_slot_its_rows():
    mesh = make_mesh(4, device="cpu")
    stagers = staging.Stagers(mesh, 3)
    host = (torch.arange(24).reshape(12, 2), torch.arange(12))
    slots = stagers.upload(host)
    stagers.wait(slots)
    assert len(slots) == 4
    for d, ts in enumerate(slots):
        assert all(torch.equal(t, h[3 * d:3 * d + 3])
                   for t, h in zip(ts, host))


def _workload_imports(name):
    """The ``zotpu_torch.workloads`` modules that a workload module imports,
    wherever the import stands."""
    tree = ast.parse((ROOT / "zotpu_torch" / "workloads"
                      / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module] + [f"{node.module}.{a.name}"
                                    for a in node.names]
        else:
            continue
        for mod in mods:
            parts = mod.split(".")
            if parts[:2] == ["zotpu_torch", "workloads"] and len(parts) > 2:
                yield parts[2]


@pytest.mark.parametrize("name", ["pulldown", "setops", "spectrum",
                                  "accumulator", "feed", "staging"])
def test_imports_point_one_way(name):
    got = set(_workload_imports(name))
    assert "kmerize" not in got
    if name in ("feed", "staging"):
        assert got == set()
