"""The zotpu_torch scan/pulldown slice on the CPU: ``RecordAggregator`` and
``panel_to_device`` against the JAX package's, ``pulldown_paths`` against
the JAX one (also with samples interleaved on the parse pool, on one slot
and sharded over four), and the CLI (``scan``, ``evidence``, ``probes``,
``query``) against ``python -m zotpu`` on JAX-CPU and its ``--host``
golden path, byte for byte; plus the not-yet-ported multi-device flags and
the no-fallback rule for ``--device cuda``."""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.profiler import ProfilerActivity, profile

from zotpu import cli as zcli
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu.workloads import pulldown as JPD
from zotpu_torch import cli as tcli
from zotpu_torch import keys as K
from zotpu_torch import metrics
from zotpu_torch.io import fastq
from zotpu_torch.workloads import pulldown as TPD

torch.set_num_threads(1)

K_SCAN = 25
N_SAMPLES = 16


def _write_fastq(path, reads, prefix="r"):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@{prefix}{i} x\n{r}\n+\n{'I' * len(r)}\n")


@st.composite
def _rows_and_cuts(draw):
    """Records of 1-4 rows each (halo chunks), per-row hits, and batch
    boundaries that may fall inside a record."""
    rows_per_rec = draw(st.lists(st.integers(1, 4), max_size=30))
    first = draw(st.integers(0, 1000))
    rids = np.repeat(np.arange(first, first + len(rows_per_rec)),
                     rows_per_rec).astype(np.int64)
    hits = np.asarray(draw(st.lists(st.integers(0, 60), min_size=len(rids),
                                    max_size=len(rids))), np.int32)
    cuts = sorted(draw(st.lists(st.integers(0, len(rids)), max_size=6)))
    return hits, rids, [0, *cuts, len(rids)]


@settings(max_examples=60, deadline=None)
@given(_rows_and_cuts())
def test_record_aggregator_matches_jax(case):
    hits, rids, bounds = case
    port, ref = TPD.RecordAggregator(), JPD.RecordAggregator()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        port.add(hits[lo:hi], rids[lo:hi])
        ref.add(hits[lo:hi], rids[lo:hi])
    assert port.result() == ref.result()
    per_rec = [int(hits[rids == r].sum()) for r in np.unique(rids)]
    assert port.result() == (sum(per_rec), sum(h > 0 for h in per_rec),
                             per_rec)


def _batches(*spec):
    """Batches of (row hits, record ids) from (ids, hits) lists."""
    return [(np.asarray(h, np.int32), np.asarray(r, np.int64))
            for r, h in spec]


AGGREGATOR_CASES = {
    "empty_first_and_middle": _batches(
        ([], []), ([0, 0, 1], [3, 0, 2]), ([], []), ([1, 2, 2], [5, 0, 0]),
        ([3], [0])),
    "record_over_three_batches": _batches(
        ([4, 5], [1, 2]), ([5, 5, 5], [7, 0, 9]), ([5], [4]),
        ([5, 6, 7], [1, 0, 3])),
    "one_row_batch": _batches(([0], [6]), ([0], [1]), ([1], [0])),
    "58020_one_row_records": _batches(
        (np.arange(58020),
         np.random.default_rng(5).integers(0, 60, 58020))),
    "result_twice": _batches(([0, 1, 1], [2, 0, 3]), ([1, 2], [4, 1])),
}


@pytest.mark.parametrize("case", AGGREGATOR_CASES.values(),
                         ids=AGGREGATOR_CASES.keys())
def test_record_aggregator_cases_match_jax(case):
    """The port against the JAX package's class, with Python ints out;
    ``result()`` is asked after every batch, so a record that continues
    into the next batch is carried past a ``result()`` too."""
    port, ref = TPD.RecordAggregator(), JPD.RecordAggregator()
    for hits, rids in case:
        port.add(hits, rids)
        ref.add(hits, rids)
        want = ref.result()
        want = (want[0], want[1], list(want[2]))
        got = port.result()
        assert got == want and port.result() == want
        assert all(type(v) is int for v in (got[0], got[1], *got[2]))


@pytest.mark.parametrize("n", [0, 1, 5, 8, 9, 1000])
def test_panel_to_device_matches_jax(n):
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))[:n]
    got = TPD.panel_to_device(keys, device="cpu")
    hi, lo = JPD.panel_to_device(keys)
    assert torch.equal(got, K.from_hi_lo(np.asarray(hi), np.asarray(lo)))
    with pytest.raises(ValueError, match="2\\*\\*62"):
        TPD.panel_to_device(np.asarray([1 << 62], np.uint64),
                            device="cpu")


@pytest.fixture(scope="module")
def scan_data(tmp_path_factory):
    """A panel from part of a genome and 16 samples of ragged reads with N
    bases; sample 3 holds a 400 bp record, longer than every --max-len
    (halo-chunked rows across batches), and sample 9 is empty of hits."""
    d = tmp_path_factory.mktemp("scan")
    rng = np.random.default_rng(55)
    genome = rng.choice(list("ACGT"), size=12000)
    panel_k, _ = G.kmerize(K_SCAN, ["".join(genome[:3000])])
    panel = d / "panel.zkf"
    container.write(str(panel), container.KmerSet(k=K_SCAN, keys=panel_k))
    samples = []
    for s in range(N_SAMPLES):
        reads = []
        for _ in range(int(rng.integers(20, 90))):
            n = int(rng.integers(15, 121))
            off = int(rng.integers(3000 if s == 9 else 0, len(genome) - n))
            r = genome[off:off + n].copy()
            r[rng.random(n) < 0.01] = "N"
            reads.append("".join(r))
        if s == 3:
            reads.insert(7, "".join(genome[1000:1400]))
        p = d / f"s{s}.fastq"
        _write_fastq(str(p), reads, prefix=f"s{s}_")
        samples.append(str(p))
    return d, str(panel), samples, panel_k


def _run(main, argv, capsys):
    rc = main([str(a) for a in argv])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("max_len", [128, 100])
def test_scan_cli_matches_jax_and_host(scan_data, tmp_path, capsys, max_len):
    """--max-len 128 takes the wire pack, 100 the u8 pack; 32 rows a batch
    split samples into several batches."""
    d, panel, samples, panel_k = scan_data
    flags = ["--batch-reads", 32, "--max-len", max_len, "--per-read"]
    outs = {}
    for name, main, extra in (
            ("port", tcli.main, ["--device", "cpu"]),
            ("jax", zcli.main, []),
            ("host", zcli.main, ["--host"]),
            ("port_host", tcli.main, ["--host"])):
        fq = tmp_path / f"{name}.fastq"
        rc, out, err = _run(main, ["scan", panel, *samples, *flags, *extra,
                                   "--out-reads", fq, "--min-hits", 2],
                            capsys)
        assert rc == 0, err
        outs[name] = (out, fq.read_text())
    for name in ("jax", "host", "port_host"):
        assert outs["port"][0] == outs[name][0], name
        assert outs["port"][1] == outs[name][1], name
    lines = outs["port"][0].splitlines()
    summary = [json.loads(x) for x in lines if x.startswith("{")]
    assert len(summary) == N_SAMPLES
    assert summary[9]["total_hits"] == 0
    assert all(s["total_hits"] > 0 for i, s in enumerate(summary) if i != 9)
    # per-read rows stay aligned to records: the overlong one is one row
    s3 = [x for x in lines if x.startswith(samples[3] + "\t")]
    assert len(s3) == sum(1 for x in open(samples[3]) if x.startswith("@"))
    assert outs["port"][1].startswith("@")


def test_pulldown_paths_matches_jax(scan_data, tmp_path):
    d, panel, samples, panel_k = scan_data
    short = tmp_path / "short.fastq"       # no read as long as k
    _write_fastq(str(short), ["ACGT", "N" * 30, "A"])
    paths = [samples[3], str(short), samples[0]]
    got = TPD.pulldown_paths(panel_k, paths, K_SCAN, batch_reads=16,
                             max_len=64, device="cpu")
    assert got == JPD.pulldown_paths(panel_k, paths, K_SCAN, batch_reads=16,
                                     max_len=64)
    assert got[1] == (0, 0, [0, 0, 0])


POOL_SAMPLES = [3, 0, 9, 5, 12]


@pytest.fixture(scope="module")
def pool_want(scan_data):
    """The JAX package's pulldown_paths over POOL_SAMPLES at 16 reads a
    batch and max_len 64: sample 3's 400 bp record is halo-chunked into
    rows that run from one batch into the next."""
    _, _, samples, panel_k = scan_data
    paths = [samples[i] for i in POOL_SAMPLES]
    batches = list(fastq.parse_batches(paths[0], 16, 64, halo=K_SCAN - 1))
    assert any(a.record_ids[a.n_reads - 1] == b.record_ids[0]
               for a, b in zip(batches, batches[1:]))
    return paths, JPD.pulldown_paths(panel_k, paths, K_SCAN,
                                     batch_reads=16, max_len=64)


@pytest.mark.parametrize("sharded", [False, True], ids=["one_slot",
                                                        "four_slots"])
@pytest.mark.parametrize("workers", [4, 2])
@pytest.mark.parametrize("n_samples", [2, 5])
def test_pulldown_on_the_parse_pool_matches_jax(scan_data, pool_want,
                                                monkeypatch, n_samples,
                                                workers, sharded):
    """Two and five samples on a pool of 4 and of 2 parse threads, which
    interleave the samples' batches: every sample's hits equal the JAX
    package's, on one slot and hash-sharded over 4 CPU slots."""
    _, _, _, panel_k = scan_data
    paths, want = pool_want
    paths = paths[:n_samples]
    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", str(workers))
    metrics.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        if sharded:
            got = TPD.pulldown_paths_sharded(panel_k, paths, K_SCAN, 4,
                                             batch_reads=16, max_len=64,
                                             device="cpu")
        else:
            got = TPD.pulldown_paths(panel_k, paths, K_SCAN, batch_reads=16,
                                     max_len=64, device="cpu")
    assert got == want[:n_samples]
    assert metrics.counters()["parse.threads"] == min(workers, n_samples)


def test_scan_multi_device_not_yet_ported(scan_data, capsys):
    """The multi-controller flags' checks: --num-processes without
    --coordinator or --process-id exits 1 with the JAX package's message
    before any process group is joined; --coordinator alone is ignored, as
    there; --shards N (one process) prints the single-device lines."""
    d, panel, samples, _ = scan_data
    for extra in (["--num-processes", 2, "--process-id", 0],
                  ["--num-processes", 2, "--coordinator", "127.0.0.1:1"]):
        argv = ["scan", panel, samples[0], *extra]
        got = _run(tcli.main, [*argv, "--device", "cpu"], capsys)
        assert got == _run(zcli.main, argv, capsys)
        assert got == (1, "", "error: --num-processes needs --coordinator "
                          "HOST:PORT and --process-id\n")
    runs = [_run(tcli.main, ["scan", panel, samples[0], "--device", "cpu",
                             *extra], capsys)
            for extra in ([], ["--shards", 2], ["--coordinator", "h:1"])]
    assert all(r[0] == 0 and r[1] == runs[0][1] for r in runs)


def test_device_cuda_without_cuda_exits_1(scan_data, tmp_path, capsys,
                                          monkeypatch):
    d, panel, samples, _ = scan_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("scan", "evidence"):
        rc, out, err = _run(tcli.main, [cmd, panel, samples[0]], capsys)
        assert rc == 1 and out == "", cmd
        assert "--device cuda" in err and "is_available() is false" in err


@pytest.fixture(scope="module")
def variant_data(tmp_path_factory):
    """A 1.2 kbp reference, two variants (an SNV and a deletion), their
    probe panel from each CLI, and spiked reads."""
    d = tmp_path_factory.mktemp("variants")
    rng = np.random.default_rng(77)
    seq = "".join(rng.choice(list("ACGT"), size=1200))
    ref = d / "ref.fa"
    ref.write_text(">chr1\n" + "".join(seq[i:i + 60] + "\n"
                                       for i in range(0, len(seq), 60)))
    base = seq[399]
    specs = [f"chr1:g.400{base}>{'G' if base != 'G' else 'T'}",
             "chr1:g.800_802del"]
    panels = {}
    for name, main in (("port", tcli.main), ("jax", zcli.main)):
        panels[name] = d / f"{name}.zkf"
        assert main(["probes", "-k", "15", str(ref), str(panels[name]),
                     *specs]) == 0
    fq = d / "spiked.fastq"
    assert zcli.main(["spikein", str(ref), str(fq), *specs, "--vaf", "0.4",
                      "--coverage", "30", "--seed", "5",
                      "--error-rate", "0.002"]) == 0
    return d, panels, specs, str(fq)


def test_probes_cli_matches_jax(variant_data, capsys):
    d, panels, specs, fq = variant_data
    capsys.readouterr()
    port = container.read(str(panels["port"]))
    jax_ = container.read(str(panels["jax"]))
    # the same file apart from the tool's name in the meta
    assert port.meta.pop("tool") == "zotpu_torch probes"
    assert jax_.meta.pop("tool") == "zotpu probes"
    assert port.meta == jax_.meta and port.k == jax_.k
    assert port.counts is None and jax_.counts is None
    assert port.keys.dtype == jax_.keys.dtype
    assert port.keys.tobytes() == jax_.keys.tobytes()
    assert len(port.meta["variants"]) == 2


@pytest.mark.parametrize("min_hits", [1, 3, 0])
def test_evidence_cli_matches_jax_and_host(variant_data, tmp_path, capsys,
                                           min_hits):
    d, panels, specs, fq = variant_data
    capsys.readouterr()
    flags = ["--batch-reads", 32, "--max-len", 128, "--min-hits", min_hits]
    outs = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", zcli.main, []),
                              ("host", zcli.main, ["--host"])):
        od = tmp_path / name
        rc, out, err = _run(main, ["evidence", panels["port"], fq, *flags,
                                   *extra, "--out-reads", od], capsys)
        assert rc == 0, err
        files = {p.name: p.read_text() for p in od.iterdir()}
        outs[name] = (out.replace(str(od), "OUT"), files)
    for name in ("jax", "host"):
        assert outs["port"] == outs[name], name
    rows = [json.loads(x) for x in outs["port"][0].splitlines()]
    assert [r["variant"] for r in rows[:2]] == specs
    assert all(r["alt"]["support"] > 0 for r in rows[:2])
    assert all(v > 0 for v in rows[2]["supporting_reads"].values())
    assert len(outs["port"][1]) == 2


def test_query_cli_matches_jax(variant_data, tmp_path, capsys):
    d, panels, specs, fq = variant_data
    kset = tmp_path / "s.zkf"
    assert tcli.main(["kmerize", "-k", "15", "--device", "cpu", str(kset),
                      fq]) == 0
    capsys.readouterr()
    reads = [x.strip() for x in open(fq)][1::4]
    for argv in (["query", kset, reads[0][:15], reads[1][3:18], "A" * 15],
                 ["query", kset, "--seq", reads[2], "ACGT" * 10],
                 ["query", kset, "C" * 15]):
        assert _run(tcli.main, argv, capsys) == _run(zcli.main, argv, capsys)
    rc, _, err = _run(tcli.main, ["query", kset, "ACG"], capsys)
    assert rc == 1 and "k=15" in err
