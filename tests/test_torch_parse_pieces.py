"""The cut path of the host pipeline on the CPU: a plain FASTQ file cut
into pieces of ``batch_reads`` records (``io/fastq.cut_fastq``) and parsed
by the workers of the parse pool (``parse_fastq_piece`` through
``workloads/kmerize._iter_batches``), against the serial path that parses
the file on one thread. Small batches and tiny chunks make pieces straddle
chunks; every join has a timeout."""

import gzip
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from zotpu_torch import metrics
from zotpu_torch.io import fastq, native
from zotpu_torch.workloads import kmerize as TW

torch.set_num_threads(1)

K, BATCH, MAX_LEN = 21, 16, 64


def _records(rng, n, lo=20, hi=64):
    """n FASTQ records as (name, seq, qual) of random lengths in [lo, hi]."""
    out = []
    for i in range(n):
        m = int(rng.integers(lo, hi + 1))
        seq = "".join(rng.choice(list("ACGTN"), size=m, p=[.24] * 4 + [.04]))
        qual = "".join(rng.choice(list("@+I#5"), size=m))
        out.append((f"r{i}", seq, qual))
    return out


def _text(recs, nl="\n", first_qual=None):
    lines = []
    for i, (name, seq, qual) in enumerate(recs):
        if first_qual is not None:
            qual = first_qual[i % len(first_qual)] + qual[1:]
        lines += [f"@{name}", seq, "+", qual]
    return nl.join(lines) + nl


def _write(path, text):
    with open(path, "w", newline="") as f:
        f.write(text)
    return str(path)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The inputs the cut path must parse as the serial path does, each a
    list of files."""
    d = tmp_path_factory.mktemp("pieces")
    rng = np.random.default_rng(17)
    overlong = _records(rng, 70)
    overlong[33] = ("long", "".join(rng.choice(list("ACGT"), size=301)),
                    "I" * 301)
    return {
        "crlf": [_write(d / "crlf.fq", _text(_records(rng, 90), "\r\n"))],
        "quals_at_and_plus": [_write(d / "q.fq", _text(
            _records(rng, 77), first_qual="@+"))],
        "no_final_newline": [_write(d / "nonl.fq",
                                    _text(_records(rng, 53))[:-1])],
        "exact_multiple": [_write(d / "mult.fq",
                                  _text(_records(rng, 4 * BATCH)))],
        "smaller_than_a_piece": [_write(d / "small.fq",
                                        _text(_records(rng, BATCH - 5)))],
        "overlong_read": [_write(d / "long.fq", _text(overlong))],
        "two_files": [_write(d / "a.fq", _text(_records(rng, 61))),
                      _write(d / "b.fq", _text(_records(rng, 44)))],
    }


CASES = ["crlf", "quals_at_and_plus", "no_final_newline", "exact_multiple",
         "smaller_than_a_piece", "overlong_read", "two_files"]


def _rows(batches):
    """Every row of the batches: (record id, length, codes)."""
    return sorted((int(b.record_ids[i]), int(b.lengths[i]),
                   b.codes[i].tobytes())
                  for b in batches for i in range(b.n_reads))


def _cut_batches(path):
    return [b for piece, rec0 in fastq.cut_fastq(path, BATCH)
            for b in fastq.parse_fastq_piece(piece, rec0, BATCH, MAX_LEN,
                                             halo=K - 1)]


def _drain(env, paths, workers, parallel=True):
    """_iter_batches' wire words of every batch, as bytes, sorted; its
    Stats; and the pieces it counted (under a profiler, on this thread)."""
    env.setenv("ZOTPU_PARSE_WORKERS", str(workers))
    stats = TW.Stats()
    metrics.reset_counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        hosts = [tuple(t.numpy().tobytes() for t in h) for h in
                 TW._iter_batches(paths, BATCH, MAX_LEN, K, stats,
                                  wire_pack=True, parallel=parallel)]
    return sorted(hosts), stats, metrics.counters().get("parse.pieces")


@pytest.fixture
def env(monkeypatch):
    """Restores ZOTPU_PARSE_WORKERS and ZOTPU_CHUNK_BYTES."""
    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", "1")
    return monkeypatch


@pytest.mark.parametrize("parser", ["native", "numpy"])
@pytest.mark.parametrize("chunk", [997, 1 << 20], ids=["tiny_chunks",
                                                        "one_chunk"])
@pytest.mark.parametrize("case", CASES)
def test_cut_path_equals_the_serial_path(cases, env, case, chunk, parser):
    env.setenv("ZOTPU_CHUNK_BYTES", str(chunk))
    if parser == "numpy":   # the fallback where no C++ compiler exists
        env.setattr(native, "get_lib", lambda: None)
    paths = cases[case]
    for path in paths:
        want = list(fastq.parse_batches(path, BATCH, MAX_LEN, halo=K - 1))
        got = _cut_batches(path)
        assert _rows(got) == _rows(want)
        assert sum(b.bases for b in got) == sum(b.bases for b in want)
        if case == "overlong_read":
            assert len(got) >= len(want)
            continue
        by_id = {int(b.record_ids[0]): b for b in want}
        assert len(got) == len(want) == len(by_id)
        for b in got:
            w = by_id[int(b.record_ids[0])]
            assert b.n_reads == w.n_reads and b.bases == w.bases
            assert np.array_equal(b.codes, w.codes)
            assert np.array_equal(b.lengths, w.lengths)
            assert np.array_equal(b.record_ids, w.record_ids)

    serial, s_stats, s_pieces = _drain(env, paths, 1)
    cut, c_stats, c_pieces = _drain(env, paths, 4)
    assert ((c_stats.reads, c_stats.bases, c_stats.batches)
            == (s_stats.reads, s_stats.bases, s_stats.batches))
    n_rec = s_stats.reads
    assert n_rec == sum(len(_text_records(p)) for p in paths)
    assert s_pieces == 0
    assert c_pieces == sum(-(-len(_text_records(p)) // BATCH)
                           for p in paths)
    if case != "overlong_read":
        assert cut == serial


def _text_records(path):
    with open(path, "rb") as f:
        return list(fastq.read_fastq(f))


@pytest.mark.parametrize("case", ["overlong_read", "two_files", "crlf"])
def test_one_call_of_kmerize_paths_equals_the_serial_path(cases, env, case):
    paths = cases[case]
    env.setenv("ZOTPU_CHUNK_BYTES", "997")
    out = {}
    for workers in (1, 4):
        env.setenv("ZOTPU_PARSE_WORKERS", str(workers))
        stats = TW.Stats()
        keys, counts = TW.kmerize_paths(paths, K, batch_reads=BATCH,
                                        max_len=MAX_LEN, stats=stats,
                                        device="cpu")
        out[workers] = keys, counts, stats
    (ka, ca, sa), (kb, cb, sb) = out[1], out[4]
    assert len(ka) > 0
    assert np.array_equal(ka, kb) and np.array_equal(ca, cb)
    assert sa == sb


@pytest.mark.parametrize("chunk", [997, 1 << 20])
def test_native_cut_and_numpy_fallback_cut_at_the_same_offsets(
        cases, env, chunk):
    if native.get_lib() is None:
        pytest.skip("no C++ compiler: only the numpy fallback is here")
    env.setenv("ZOTPU_CHUNK_BYTES", str(chunk))
    arr = np.frombuffer(open(cases["crlf"][0], "rb").read(), np.uint8)
    calls = ((1, 0), (4 * BATCH, 0), (4 * BATCH, 13), (10 ** 6, 5),
             (3, len(arr) - 2), (7, len(arr)))
    paths = [p for case in CASES for p in cases[case]]

    def cuts():
        return ([fastq._skip_lines(arr, n, off) for n, off in calls],
                [[(p.tobytes(), r) for p, r in fastq.cut_fastq(path, BATCH)]
                 for path in paths])

    want = cuts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "skip_lines", lambda *a: None)
        got = cuts()
    assert got == want
    assert want[0][-1] == (0, 0) and all(want[1])


def test_cut_path_is_not_taken_for_other_inputs(cases, env, tmp_path):
    """.gz and FASTA files, spill mode and as many files as workers go the
    way they went."""
    cut = []
    real = fastq.cut_fastq
    env.setattr(fastq, "cut_fastq", lambda *a: cut.append(a) or real(*a))
    text = open(cases["crlf"][0], "rb").read()
    gz = tmp_path / "r.fastq.gz"
    with gzip.open(gz, "wb") as f:
        f.write(text)
    fa = _write(tmp_path / "r.fa", ">c\n" + "ACGT" * 60 + "\n")
    plain = cases["two_files"][0]
    for paths in ([str(gz)], [fa], [plain, str(gz)], [plain] * 4,
                  [plain] * 16):
        _, _, pieces = _drain(env, paths, 4)
        assert pieces == 0
    _, _, pieces = _drain(env, [plain], 4, parallel=False)
    assert pieces == 0
    assert cut == []
    env.setenv("ZOTPU_PARSE_WORKERS", "4")
    run_dir = tmp_path / "spill"
    run_dir.mkdir()
    TW.kmerize_paths([plain], K, batch_reads=BATCH, max_len=MAX_LEN,
                     spill_dir=str(run_dir), device="cpu")
    assert cut == [] and len(os.listdir(run_dir)) > 1
    _drain(env, [plain], 4)
    assert cut == [(plain, BATCH)]


def _new_threads_end(before):
    for t in set(threading.enumerate()) - before:
        t.join(timeout=10)
        assert not t.is_alive(), t


def test_closing_early_leaves_no_live_thread(cases, env):
    env.setenv("ZOTPU_CHUNK_BYTES", "997")
    env.setenv("ZOTPU_PARSE_WORKERS", "4")
    before = set(threading.enumerate())
    gen = TW._iter_batches(cases["crlf"] * 2, 4, MAX_LEN, K, TW.Stats())
    next(gen)
    gen.close()
    _new_threads_end(before)


@pytest.mark.parametrize("where", ["worker", "cutter"])
def test_an_error_reaches_the_consumer(cases, env, where):
    env.setenv("ZOTPU_CHUNK_BYTES", "997")
    env.setenv("ZOTPU_PARSE_WORKERS", "4")
    if where == "worker":
        real = fastq.parse_fastq_piece

        def parse(piece, rec0, *a, **kw):
            if rec0 == 2 * BATCH:
                raise RuntimeError("piece failed")
            return real(piece, rec0, *a, **kw)
        env.setattr(fastq, "parse_fastq_piece", parse)
    else:
        real = fastq._skip_lines
        calls = []

        def parse(*a):
            calls.append(a)
            if len(calls) > 3:
                raise RuntimeError("piece failed")
            return real(*a)
        env.setattr(fastq, "_skip_lines", parse)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="piece failed"):
        for _ in TW._iter_batches(cases["crlf"], BATCH, MAX_LEN, K,
                                  TW.Stats()):
            pass
    _new_threads_end(before)


def test_stress_more_workers_than_cores(tmp_path, env):
    """Workers above the core count and a short switch interval: the totals
    of every piece reach the consumer, within a time bound."""
    rng = np.random.default_rng(5)
    recs = _records(rng, 2000, 20, 64)
    path = _write(tmp_path / "s.fq", _text(recs))
    env.setenv("ZOTPU_CHUNK_BYTES", "4093")
    env.setenv("ZOTPU_PARSE_WORKERS", str(2 * (os.cpu_count() or 1) + 3))
    want_bases = sum(len(s) for _, s, _ in recs)
    interval = sys.getswitchinterval()
    result = {}

    def drain():
        stats = TW.Stats()
        batches = sum(1 for _ in TW._iter_batches([path], 8, MAX_LEN, K,
                                                  stats))
        result.update(stats=stats, batches=batches)

    sys.setswitchinterval(1e-5)
    try:
        t0 = time.perf_counter()
        t = threading.Thread(target=drain)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert time.perf_counter() - t0 < 60
    stats = result["stats"]
    assert (stats.reads, stats.bases) == (len(recs), want_bases)
    assert result["batches"] == stats.batches == -(-len(recs) // 8)
