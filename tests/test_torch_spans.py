"""Spans and counters inside zotpu_torch (``metrics.span``, ``count``,
``count_device``, ``count_load``) on the CPU: which spans a job opens under
``torch.profiler`` and on which thread, that the counters equal the same
numbers taken from separate plain calls, and that nothing is recorded
while no profiler runs."""

import collections
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from zotpu_torch import cli as tcli
from zotpu_torch import metrics
from zotpu_torch.io import container, fastq, native
from zotpu_torch.keys import SENTINEL
from zotpu_torch.kernels import merge_fused, sortdedup
from zotpu_torch.kernels.pack import pack_canonical_wire
from zotpu_torch.workloads import accumulator, feed, staging
from zotpu_torch.workloads import kmerize as TW
from zotpu_torch.workloads import pulldown as TP
from zotpu_torch.workloads import setops as TS

torch.set_num_threads(1)

K, BATCH, MAX_LEN = 21, 64, 128
KMERIZE_SPANS = {"parse_wait", "account", "upload", "step", "merge",
                 "result"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three FASTQ files of 150-190 reads of one seeded genome, and the
    panel of the genome's first 2 kb."""
    rng = np.random.default_rng(16)
    genome = "".join(rng.choice(list("ACGT"), size=8000))
    d = tmp_path_factory.mktemp("spans")
    paths = []
    for f in range(3):
        path = d / f"r{f}.fastq"
        with open(path, "w") as fh:
            for i in range(150 + 20 * f):
                n = int(rng.integers(40, 121))
                off = int(rng.integers(0, len(genome) - n))
                fh.write(f"@r{f}.{i}\n{genome[off:off + n]}\n+\n{'I' * n}\n")
        paths.append(str(path))
    keys, _ = TW.kmerize_paths([paths[0]], K, batch_reads=BATCH,
                               max_len=MAX_LEN, device="cpu")
    return paths, keys[::3].copy()


def _profiled(fn):
    """``fn()`` under the profiler from fresh counters: (its result, the
    spans' names without the prefix counted, the counters)."""
    metrics.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.job"):
            out = fn()
    evs = list(prof.events())
    job = next(e for e in evs if e.name == "test.job")
    spans = [e for e in evs if e.name.startswith(metrics.SPAN_PREFIX)]
    assert all(e.thread == job.thread for e in spans)
    names = collections.Counter(e.name[len(metrics.SPAN_PREFIX):]
                                for e in spans)
    return out, names, metrics.counters()


def _host_batches(paths):
    """The kmerize iterator's host tensors, drained apart from any job."""
    return list(TW._iter_batches(paths, BATCH, MAX_LEN, K, TW.Stats(),
                                 wire_pack=True))


@pytest.mark.parametrize("n_files", [1, 3], ids=["one_file", "pool"])
def test_kmerize_spans_and_counters(data, monkeypatch, n_files):
    """One file against 3 workers is cut into pieces of BATCH records,
    which the workers parse; 3 files against 3 workers parse whole. The
    waits and the accounting stand on the driving thread either way, and
    ``parse.threads`` counts the 3 workers."""
    paths = data[0][:n_files]
    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", "3")
    merges = []

    def spy(ka, ca, kb, cb, op="merge", n_a=None, n_b=None):
        _, _, n = merge_fused.set_op_plain(ka, ca, kb, cb, op, n_a, n_b)
        merges.append((int(n_a) + int(n_b), int(n)))
        return merge_fused.set_op_fused(ka, ca, kb, cb, op, n_a, n_b)

    monkeypatch.setattr(accumulator, "set_op_fused", spy)
    stats = TW.Stats()
    (keys, _), spans, got = _profiled(lambda: TW.kmerize_paths(
        paths, K, batch_reads=BATCH, max_len=MAX_LEN, stats=stats,
        device="cpu"))
    b = stats.batches
    assert b > 2 and len(merges) >= b - 1
    assert set(spans) == KMERIZE_SPANS
    # one wait more than batches: the last one meets the end of the stream
    assert spans["parse_wait"] == b + 1
    assert (spans["step"] == spans["account"] == spans["merge"]
            == spans["upload"] == b)
    assert spans["result"] == 1

    hosts = _host_batches(paths)
    assert len(hosts) == b
    unique = [int(sortdedup.dedup_compact_plain(torch.sort(
        pack_canonical_wire(*h, K)).values)[2]) for h in hosts]
    windows = BATCH * (MAX_LEN - K + 1)
    assert got == {"dedup.keys_in": b * windows,
                   "dedup.keys_out": sum(unique),
                   "merge.keys_in": sum(m[0] for m in merges),
                   "merge.keys_out": sum(m[1] for m in merges),
                   "h2d.bytes": sum(t.nbytes for h in hosts for t in h),
                   "parse.pieces": -(-150 // BATCH) if n_files == 1 else 0,
                   "parse.threads": 3}
    assert len(keys) == stats.unique > 0


def test_pulldown_spans_and_counters(data):
    paths, panel = data
    batches = sum(-(-(150 + 20 * f) // BATCH) for f in range(3))
    res, spans, got = _profiled(lambda: TP.pulldown_paths(
        panel, paths, K, batch_reads=BATCH, max_len=MAX_LEN, device="cpu"))
    assert len(res) == 3 and sum(r[0] for r in res) > 0
    # no download to wait for on the CPU
    assert set(spans) == {"parse_wait", "upload", "step", "aggregate"}
    assert spans["parse_wait"] == batches + 1
    assert spans["step"] == batches
    assert spans["upload"] == batches + 1              # and the panel's
    assert spans["aggregate"] == batches + 1           # and the results
    host = sum(t.nbytes for _, _, h in TP._iter_scan_batches(
        paths, BATCH, MAX_LEN, K, True, False) for t in h)
    panel_bytes = TP.panel_to_device(panel, device="cpu").nbytes
    # no read is longer than MAX_LEN: one row a record, none carried; the
    # parse pool takes the three samples whole
    assert got == {"h2d.bytes": host + panel_bytes,
                   "aggregate.records": sum(150 + 20 * f for f in range(3)),
                   "aggregate.carried": 0,
                   "parse.threads": min(feed.parse_workers(), 3)}


def test_aggregate_counts_records_and_carried_records(data):
    """At a max_len that halo-chunks the longer reads, a record's rows may
    straddle two batches: ``aggregate.records`` counts every read once and
    ``aggregate.carried`` each record continued into the next batch; with
    no profiler neither is recorded."""
    paths, panel = data
    max_len = 64
    split = 0
    for path in paths:
        last = None
        for batch in fastq.parse_batches(path, BATCH, max_len, halo=K - 1):
            ids = batch.record_ids[:batch.n_reads]
            split += int(len(ids) > 0 and ids[0] == last)
            last = ids[-1] if len(ids) else last
    assert split > 0

    def run():
        return TP.pulldown_paths(panel, paths, K, batch_reads=BATCH,
                                 max_len=max_len, device="cpu")

    metrics.reset_counters()
    want = run()
    assert {name: v for name, v in metrics.counters().items()
            if not name.startswith("load.")} == {}
    got, _, counters = _profiled(run)
    assert got == want
    assert counters["aggregate.records"] == sum(len(r[2]) for r in got) \
        == sum(150 + 20 * f for f in range(3))
    assert counters["aggregate.carried"] == split


def _dense(rng, n, hi):
    """A dense sorted unique (keys, counts, n) set in a capacity of n + 3
    with a SENTINEL / 0 tail."""
    keys = np.unique(rng.integers(0, hi, n))
    k = torch.full((n + 3,), SENTINEL, dtype=torch.int64)
    c = torch.zeros(n + 3, dtype=torch.int64)
    k[:len(keys)] = torch.from_numpy(keys)
    c[:len(keys)] = torch.from_numpy(rng.integers(1, 9, len(keys)))
    return k, c, torch.tensor(len(keys), dtype=torch.int64)


def test_kernel_counters_equal_plain_calls():
    rng = np.random.default_rng(3)
    sorted_keys = [torch.sort(torch.cat([
        torch.from_numpy(rng.integers(0, 40, n)),
        torch.full((4,), SENTINEL, dtype=torch.int64)])).values
        for n in (0, 1, 37, 500)]
    pairs = [(_dense(rng, na, 200), _dense(rng, nb, 200))
             for na, nb in ((0, 0), (5, 0), (30, 41), (120, 7))]
    calls = [(a, b, op, given) for a, b in pairs
             for op in ("merge", "intersect", "diff")
             for given in ((True, True), (True, False), (False, False))]

    def run():
        for keys in sorted_keys:
            sortdedup.dedup_compact(keys)
        for (ka, ca, na), (kb, cb, nb), op, (ga, gb) in calls:
            merge_fused.set_op_fused(ka, ca, kb, cb, op, na if ga else None,
                                     nb if gb else None)

    _, _, got = _profiled(run)
    keys_in = sum((int(na) if ga else len(ka)) + (int(nb) if gb else len(kb))
                  for (ka, _, na), (kb, _, nb), _, (ga, gb) in calls)
    keys_out = sum(int(merge_fused.set_op_plain(
        ka, ca, kb, cb, op, na if ga else None, nb if gb else None)[2])
        for (ka, ca, na), (kb, cb, nb), op, (ga, gb) in calls)
    assert got == {
        "dedup.keys_in": sum(len(k) for k in sorted_keys),
        "dedup.keys_out": sum(int(sortdedup.dedup_compact_plain(k)[2])
                              for k in sorted_keys),
        "merge.keys_in": keys_in, "merge.keys_out": keys_out}


def test_upload_counts_the_tensors_bytes():
    host = (torch.zeros((3, 8), dtype=torch.int32),
            torch.zeros(5, dtype=torch.uint8), torch.zeros(2))
    _, spans, got = _profiled(lambda: staging.Stager("cpu").upload(host))
    assert spans == {"upload": 1}
    assert got == {"h2d.bytes": 96 + 5 + 8}


def test_nothing_is_recorded_without_a_profiler(data, monkeypatch):
    opened = []
    monkeypatch.setattr(metrics, "_Range", opened.append)
    assert not torch._C._autograd._profiler_enabled()
    metrics.reset_counters()
    paths, panel = data
    TW.kmerize_paths(paths, K, batch_reads=BATCH, max_len=MAX_LEN,
                     device="cpu")
    TP.pulldown_paths(panel, paths, K, batch_reads=BATCH, max_len=MAX_LEN,
                      device="cpu")
    assert opened == []
    assert {name: v for name, v in metrics.counters().items()
            if not name.startswith("load.")} == {}


@pytest.mark.parametrize("op", ["union", "intersect", "diff", "jaccard"])
def test_setop_paths_spans_and_counters(tmp_path, monkeypatch, op):
    """One call of ``set_op_paths`` (or ``jaccard_paths``) opens each of
    its four spans once and counts both sides' keys, n_out, and the bytes
    it copies up: n and the keys of each side, and the counts where the
    op takes them. Without a profiler it records nothing."""
    rng = np.random.default_rng(22)
    sides = []
    for name, n in (("a", 300), ("b", 200)):
        keys = np.unique(rng.integers(0, 1000, n)).astype(np.uint64)
        path = str(tmp_path / f"{name}.zkf")
        container.write(path, container.KmerSet(
            k=K, keys=keys, counts=rng.integers(1, 9, len(keys)).astype(
                np.uint32)))
        sides.append((path, keys))
    (pa, a), (pb, b) = sides

    def call():
        if op == "jaccard":
            return TS.jaccard_paths(pa, pb, device="cpu")
        return TS.set_op_paths(pa, pb, op, device="cpu")

    with monkeypatch.context() as m:
        opened = []
        m.setattr(metrics, "_Range", opened.append)
        metrics.reset_counters()
        want = call()
        assert opened == [] and metrics.counters() == {}
    got, spans, counters = _profiled(call)
    assert got == want if op == "jaccard" else all(
        np.array_equal(x, y) for x, y in zip(got, want))
    assert spans == {"set_read": 1, "upload": 1, "step": 1,
                     "download_wait": 1}
    n_out = len({"union": np.union1d, "diff": np.setdiff1d}.get(
        op, np.intersect1d)(a, b))
    per_key = 8 if op == "jaccard" else 16
    keys_in = len(a) + len(b)
    assert counters == {"h2d.bytes": per_key * keys_in + 2 * 8,
                        "container.read_direct_bytes": 12 * keys_in,
                        f"setop.{op}.keys_in": keys_in,
                        f"setop.{op}.keys_out": n_out,
                        "merge.keys_in": keys_in, "merge.keys_out": n_out}


@pytest.mark.parametrize("counts", [False, True], ids=["kset", "kfset"])
def test_container_read_counts_the_bytes_read_into_its_arrays(tmp_path,
                                                              counts):
    """A raw set's ``read`` counts 8 bytes a key and 4 a count as
    ``container.read_direct_bytes``; a zlib or delta set counts none, and
    nothing is counted without a profiler."""
    rng = np.random.default_rng(23)
    keys = np.unique(rng.integers(0, 1 << 40, 500)).astype(np.uint64)
    c = rng.integers(1, 9, len(keys)).astype(np.uint32) if counts else None
    got = {}
    for codec in ("raw", "zlib", "delta"):
        path = str(tmp_path / f"{codec}.zkf")
        container.write(path, container.KmerSet(k=K, keys=keys, counts=c),
                        codec=codec)
        metrics.reset_counters()
        container.read(path)
        assert metrics.counters() == {}
        ks, _, counters = _profiled(lambda: container.read(path))
        assert np.array_equal(ks.keys, keys)
        got[codec] = counters.get("container.read_direct_bytes", 0)
    assert got == {"raw": (12 if counts else 8) * len(keys), "zlib": 0,
                   "delta": 0}


def test_load_seconds_after_the_first_native_load(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    metrics.reset_counters()
    assert native.get_lib() is not None
    got = metrics.counters()
    assert got["load.s"] > 0 and got["load.build_s"] >= 0
    assert set(got) == {"load.s", "load.build_s"}
    native.get_lib()                       # loaded: not counted again
    assert metrics.counters() == got


def test_native_build_returns_its_compile_seconds(monkeypatch, tmp_path):
    """A build in an empty directory compiles and says how long; the next
    finds the library and compiles nothing."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    so, seconds = native._build()
    assert so is not None and so.startswith(str(tmp_path)) and seconds > 0
    assert native._build() == (so, 0.0)


def test_spans_use_the_range_with_no_device_event():
    """The span class is private to torch: an upgrade that drops it fails
    here, and spans fall back to record_function."""
    assert metrics._Range is torch._C._profiler._RecordFunctionFast


def test_device_counters_do_no_device_work_until_read():
    """count_device keeps the tensors; counters() sums them, int32 and
    int64 alike."""
    metrics.reset_counters()
    a, b = torch.tensor(3), torch.tensor([4], dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics.count_device("x", a)
        metrics.count_device("x", b)
        metrics.count_device("y", a)
    assert not [e for e in prof.events() if e.name.startswith("aten::")]
    assert metrics.counters() == {"x": 7, "y": 3}
    metrics.reset_counters()


def test_load_counter_from_many_threads():
    """count_load from more threads than cores, with a short switch
    interval, loses no update."""
    metrics.reset_counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            metrics.count_load(1.0, 0.5) for _ in range(500)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert metrics.counters() == {"load.s": 8000.0, "load.build_s": 4000.0}


def test_kmerize_trace_holds_the_spans(data, tmp_path, capsys):
    tdir = tmp_path / "tr"
    rc = tcli.main(["kmerize", "-k", str(K), "--device", "cpu",
                    "--batch-reads", str(BATCH), "--max-len", str(MAX_LEN),
                    "--trace", str(tdir), str(tmp_path / "o.zkf"),
                    data[0][0]])
    capsys.readouterr()
    assert rc == 0
    trace = json.loads((tdir / metrics.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"zotpu.parse_wait", "zotpu.result"} <= names
