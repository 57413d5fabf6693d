"""CPU tests of the BGZF cell ``kmerize.ecoli30x.16bgzf``
(``jobs/kmerize_bgzf.py``: the fixture's 16 FASTQ files with binned
qualities, written as BGZF by the benchmark's own writer) and its readers
(``metrics/inflate_gb_per_s.py``, ``metrics/inflate_threads_per_job.py``),
at the harness's tiny size with the program's plain PyTorch versions.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import struct
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import control, fixture, program, run  # noqa: E402
from benchmark.jobs import kmerize  # noqa: E402
from benchmark.jobs import kmerize_bgzf as J  # noqa: E402

CELL = "kmerize.ecoli30x.16bgzf"
TINY = {"genome_bp": 20000, "coverage": 3, "batch_reads": 64}
MEDIUM = {"genome_bp": 200000, "coverage": 10}
NEW = ("inflate_gb_per_s", "inflate_threads_per_job")
# nothing to read without a card: device time, CUDA's allocators
DEVICE_ONLY = ("pack_roofline", "sort_roofline", "dedup_roofline",
               "merge_roofline", "accumulator_ms_per_batch", "h2d_gb_per_s",
               "device_idle_share", "device_peak_gib", "allocs_per_job")


def reader(name):
    return run.load_module(os.path.join(run.HERE, "metrics", name + ".py"))


def run_cell(capsys, trace=0, seed=2147483951, patch=None):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", str(trace)], root=ROOT,
                  devices=[torch.device("cpu")],
                  cfg_patch={**TINY, **(patch or {})})
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


def test_the_cell_is_16files_compressed():
    got = run.load_cell(CELL)
    plain = run.load_cell("kmerize.ecoli30x.16files")
    for key, value in plain.cfg.items():
        if key not in ("name", "source", "deployment", "assumed"):
            assert got.cfg[key] == value, key
    assert set(plain.cfg["assumed"]) - set(got.cfg["assumed"]) == {
        "every quality is I"}
    assert got.cfg["input"] == "bgzf" and got.cfg["bgzf_level"] == 6
    assert got.cfg["bgzf_block_bytes"] == 0xFF00
    assert got.cfg["quality_bins"] == {"F": 0.90, "8": 0.05, "-": 0.04,
                                       "#": 0.01}
    assert got.traffic == {"job": "kmerize_bgzf", "files": 16}
    assert got.job.LIMITS == plain.job.LIMITS
    assert J.LIMITS is kmerize.LIMITS and issubclass(J.Job, kmerize.Job)
    assert got.cell["chips"] == 1
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entry = next(c for c in spec["configs"] if c["name"] == got.cell["config"])
    assert entry["source"] == got.cfg["source"] and entry["reduced"] == []
    assert {m["name"] for m in got.per_layer} == {
        m["name"] for m in plain.per_layer} | set(NEW)
    assert [m["name"] for m in got.end_to_end] == [
        m["name"] for m in plain.end_to_end]


def test_a_checkout_without_the_job_stops_at_load_cell(tmp_path):
    """The parent of the cell has no job file: the run stops where the
    cell is loaded."""
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    os.remove(tmp_path / "benchmark/jobs/kmerize_bgzf.py")
    with pytest.raises(FileNotFoundError, match="kmerize_bgzf"):
        run.load_cell(CELL, root=str(tmp_path))


def _blocks(buf: bytes):
    """(BSIZE + 1, ISIZE) of each block of a BGZF file, walked by BSIZE."""
    off, out = 0, []
    while off < len(buf):
        assert buf[off:off + 4] == b"\x1f\x8b\x08\x04"
        assert buf[off + 10:off + 16] == struct.pack("<HBBH", 6, 66, 67, 2)
        size = struct.unpack("<H", buf[off + 16:off + 18])[0] + 1
        out.append((size, struct.unpack("<I", buf[off + size - 4:
                                                  off + size])[0]))
        off += size
    assert off == len(buf)
    return out


@pytest.mark.parametrize("size", [0, 1, 65280, 65281, 300_000])
def test_the_writer_writes_bgzf(tmp_path, size):
    from zotpu_torch.io import bgzf
    rng = np.random.default_rng(size)
    data = rng.choice(np.frombuffer(b"ACGTF8-#\n", np.uint8), size)
    path = str(tmp_path / "x.fastq.gz")
    J.write_bgzf(path, data, 6, 65280)
    buf = open(path, "rb").read()
    assert gzip.decompress(buf) == data.tobytes()
    assert bgzf.is_bgzf(path)
    blocks = _blocks(buf)
    assert all(isize <= 65280 for _, isize in blocks)
    assert [isize for _, isize in blocks[:-1]] == [
        min(65280, size - o) for o in range(0, size, 65280)]
    assert buf.endswith(J.EOF_BLOCK) and blocks[-1] == (28, 0)
    assert J.bgzf_block(b"", 6) == J.EOF_BLOCK


def test_the_quality_rewrite_keeps_ids_and_bases():
    """The compressed files hold the plain fixture's records with only the
    quality columns changed, drawn from the bins; the set they count to is
    the reference's."""
    from zotpu_torch.workloads import kmerize as W
    spec = run.load_cell(CELL)
    cfg = {**spec.cfg, **TINY}
    lay = J.record_layout(cfg["read_len"])
    a, b = lay["qual"]
    with tempfile.TemporaryDirectory() as tmp:
        inputs = fixture.make_inputs(cfg, spec.traffic, 2147483951, "cpu",
                                     tmp)
        plain = [np.fromfile(p, np.uint8).reshape(-1, lay["width"])
                 for p in inputs.paths]
        want = W.kmerize_paths(inputs.paths, cfg["k"], device="cpu")
        job = spec.job.Job(cfg, inputs, [torch.device("cpu")])
        job._compress()
        assert [os.path.basename(p) for p in job.inputs.paths] == [
            f"reads{i:02d}.fastq.gz" for i in range(16)]
        assert sorted(os.listdir(tmp)) == sorted(
            map(os.path.basename, job.inputs.paths))
        quals = []
        for p, rec in zip(job.inputs.paths, plain):
            with open(p, "rb") as f:
                got = np.frombuffer(gzip.decompress(f.read()), np.uint8)
            got = got.reshape(-1, lay["width"])
            assert np.array_equal(got[:, :a], rec[:, :a])
            assert np.array_equal(got[:, b:], rec[:, b:])
            quals.append(got[:, a:b].ravel())
        got = W.kmerize_paths(job.inputs.paths, cfg["k"], device="cpu")
        keys, counts = job.expected(torch.device("cpu"))
    quals = np.concatenate(quals)
    shares = {chr(q): float((quals == q).mean()) for q in np.unique(quals)}
    assert set(shares) == set(cfg["quality_bins"])
    for q, share in cfg["quality_bins"].items():
        assert abs(shares[q] - share) < 0.01, (q, shares[q])
    for x in (want, got):
        assert np.array_equal(x[0], keys) and np.array_equal(x[1], counts)


def test_a_record_off_the_layout_is_refused(tmp_path):
    path = tmp_path / "r.fastq"
    path.write_bytes(b"@r0000000\nACGT\n-\nIIII\n")
    with pytest.raises(ValueError, match="'\\+' at column 15"):
        J.binned_fastq(str(path), 4, J.quality_table({"F": 1.0}),
                       np.random.default_rng(0))
    with pytest.raises(ValueError, match="whole steps"):
        J.quality_table({"F": 0.5, "8": 0.49})


@pytest.mark.parametrize("trace, blocks", [(0, None), (1, None), (0, 1000)])
def test_the_cell_equals_the_reference(capsys, monkeypatch, trace, blocks):
    """``blocks``: blocks of so many input bytes, each inflated as a group
    of its own by a pool of 2 (the path the faults below break)."""
    if blocks:
        from zotpu_torch.io import bgzf
        monkeypatch.setenv("ZOTPU_BGZF_WORKERS", "2")
        monkeypatch.setattr(bgzf, "GROUP_BYTES", 1)
    rc, res = run_cell(capsys, trace=trace,
                       patch=blocks and {"bgzf_block_bytes": blocks})
    assert rc == 0
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["compared"] == {n: {"value": 0, "limit": 0} for n in
                               ("header_off", "keys_off", "counts_off")}
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
            if CELL in m.get("workloads", [CELL])}
    got = set(res["metrics"])
    if not trace:
        assert got == want == {"bases_per_s", "cpu_s_per_gbase", "setup_s"}
        return
    assert set(NEW) <= want
    assert got == want - set(DEVICE_ONLY)
    # one group a file: each file's pool runs one task, on one thread
    assert res["metrics"]["inflate_threads_per_job"]["value"] == 16
    assert res["metrics"]["inflate_gb_per_s"]["value"] > 0


def _fault(monkeypatch, fault):
    """Break the program's BGZF inflate underneath the harness: the first
    member dropped from each group of more than one, or each pair of
    groups (one block each) handed over swapped."""
    from zotpu_torch.io import bgzf
    monkeypatch.setenv("ZOTPU_BGZF_WORKERS", "2")
    if fault == "member_dropped":
        real = bgzf._inflate_members

        def inflate(data):
            size = struct.unpack("<H", data[16:18])[0] + 1
            return real(data[size:] if len(data) > size else data)
        monkeypatch.setattr(bgzf, "_inflate_members", inflate)
    else:
        monkeypatch.setattr(bgzf, "GROUP_BYTES", 1)
        real = bgzf._ordered_parallel

        def swapped(items, fn, workers, window):
            it = real(items, fn, workers, window)
            for a in it:
                b = next(it, None)
                yield from ((a,) if b is None else (b, a))
        monkeypatch.setattr(bgzf, "_ordered_parallel", swapped)


@pytest.mark.parametrize("fault", ["member_dropped", "groups_swapped"])
def test_a_broken_inflate_is_not_correct(capsys, monkeypatch, fault):
    """Blocks of 1,000 input bytes, so that each file has several."""
    _fault(monkeypatch, fault)
    rc, res = run_cell(capsys, patch={"bgzf_block_bytes": 1000})
    assert rc == 0
    assert res["correct"] is False


def test_control_is_not_correct(capsys):
    """The reference with keys held in 32 bits, in the program's place,
    fails the cell's comparison."""
    assert control.main(["--workload", CELL, "--seeds", "5", "6",
                         "--device", "cpu"], cfg_patch=MEDIUM) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for line in lines:
        got = json.loads(line)
        assert got["control_correct"] is False
        assert got["control"]["keys_off"] > 0


@pytest.mark.parametrize("counters, jobs, want", [
    ({"inflate.bytes_out": 291_495_620, "inflate.s": 0.5,
      "inflate.threads": 64}, 1, (0.58299124, 64.0)),
    ({"inflate.bytes_out": 6e8, "inflate.s": 2.0, "inflate.threads": 128},
     2, (0.3, 64.0)),
    ({"inflate.bytes_out": 9, "inflate.s": 0.0, "inflate.threads": 1}, 1,
     (None, 1.0)),
    ({"inflate.threads": 64}, 0, (None, None)),
    ({"parse.threads": 4, "h2d.bytes": 8}, 3, (None, None)),
    ({}, 3, (None, None)), (None, 3, (None, None))])
def test_readers_on_made_up_counters(monkeypatch, counters, jobs, want):
    monkeypatch.setattr(program, "counters", lambda: counters)
    ctx = SimpleNamespace(window=SimpleNamespace(jobs=[{}] * jobs))
    got = tuple(reader(name).read(ctx) for name in NEW)
    assert got == tuple(None if w is None else pytest.approx(w)
                        for w in want)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    import subprocess
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "2147483999", "--seconds", "3", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0
    assert set(NEW) <= set(res["metrics"])
    assert res["metrics"]["inflate_gb_per_s"]["value"] > 0
