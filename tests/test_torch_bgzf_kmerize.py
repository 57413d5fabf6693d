"""kmerize over gzip-compressed lanes on the CPU: BGZF (bgzip) and plain
gzip ``.fastq.gz`` files through ``workloads.kmerize.kmerize_paths`` and
the CLI, against the same reads as plain FASTQ, golden and ``python -m
zotpu kmerize``; inflate errors reaching the caller; and the counters
``inflate.*`` that ``workloads/feed.batches`` records for a traced call."""

import gzip
import os
import struct
import threading
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zotpu import cli as zcli
from zotpu_torch import cli as tcli
from zotpu_torch import metrics
from zotpu_torch.io import bgzf, container
from zotpu_torch.reference_impl import golden as G
from zotpu_torch.workloads import kmerize as TW

torch.set_num_threads(1)

K, BATCH, MAX_LEN = 21, 64, 128
LANES, BGZF_WORKERS, BLOCK = 5, 3, 1500
FORMS = ("plain", "bgzf", "gzip")


def _write_bgzf(path, data: bytes, block=BLOCK):
    """A BGZF file: gzip members of at most ``block`` input bytes, each
    with a BC extra subfield, then the empty end-of-file member."""
    with open(path, "wb") as f:
        for off in list(range(0, len(data), block)) + [None]:
            chunk = b"" if off is None else data[off:off + block]
            comp = zlib.compressobj(6, zlib.DEFLATED, -15)
            body = comp.compress(chunk) + comp.flush()
            bsize = 12 + 6 + len(body) + 8 - 1
            f.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                    + struct.pack("<H", 6) + b"BC"
                    + struct.pack("<HH", 2, bsize)
                    + body + struct.pack("<II", zlib.crc32(chunk), len(chunk)))


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """LANES lanes of reads of a 6 kbp genome, each as plain FASTQ, BGZF
    and plain gzip: {form: [paths]}, every read's sequence, and the FASTQ
    bytes of each lane. One read is longer than MAX_LEN (halo rows)."""
    d = tmp_path_factory.mktemp("bgzf_lanes")
    rng = np.random.default_rng(24)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    seqs, texts = [], []
    for lane in range(LANES):
        recs = []
        for i in range(90 + 17 * lane):
            n = 300 if (lane, i) == (2, 5) else int(rng.integers(30, 121))
            off = int(rng.integers(0, len(genome) - n))
            s = list(genome[off:off + n])
            for j in rng.integers(0, n, 2):
                s[j] = "ACGTN"[int(rng.integers(0, 5))]
            seqs.append("".join(s))
            qual = "".join(rng.choice(list("F8-#"), size=n))
            recs.append(f"@l{lane}r{i} x\n{seqs[-1]}\n+\n{qual}\n")
        texts.append("".join(recs).encode())
    paths = {form: [] for form in FORMS}
    for form in FORMS:
        (d / form).mkdir()
    for lane, text in enumerate(texts):
        name = f"L{lane}.fastq"
        (d / "plain" / name).write_bytes(text)
        _write_bgzf(d / "bgzf" / (name + ".gz"), text)
        with gzip.open(d / "gzip" / (name + ".gz"), "wb") as f:
            f.write(text)
        for form, leaf in (("plain", name), ("bgzf", name + ".gz"),
                           ("gzip", name + ".gz")):
            paths[form].append(str(d / form / leaf))
    return {"paths": paths, "seqs": seqs, "texts": texts}


@pytest.fixture
def env(monkeypatch):
    """A parse pool of 4 and BGZF pools of BGZF_WORKERS, whatever the
    cores (the defaults depend on them)."""
    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", "4")
    monkeypatch.setenv("ZOTPU_BGZF_WORKERS", str(BGZF_WORKERS))
    return monkeypatch


def _kmerize(paths):
    return TW.kmerize_paths(paths, K, batch_reads=BATCH, max_len=MAX_LEN,
                            device="cpu")


def _same_set(got, want):
    assert got[0].dtype == np.uint64 and got[1].dtype == np.uint32
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def _seqs_of(lanes, n):
    """The reads of the first ``n`` lanes."""
    count = sum(len(t.split(b"\n")) // 4 for t in lanes["texts"][:n])
    return lanes["seqs"][:count]


@pytest.mark.parametrize("n", [1, LANES], ids=["serial", "pool"])
@pytest.mark.parametrize("form", ["bgzf", "bgzf_groups", "gzip"])
def test_compressed_lanes_equal_plain_fastq_and_golden(lanes, env, form, n):
    """1 file takes the serial path, 5 the parse pool (whole files). In
    ``bgzf_groups`` each pipe inflates many groups of a few blocks."""
    paths = lanes["paths"]["gzip" if form == "gzip" else "bgzf"][:n]
    if form == "bgzf_groups":
        env.setattr(bgzf, "GROUP_BYTES", BLOCK)
        assert all(len(list(bgzf._iter_groups(p, bgzf.GROUP_BYTES))) > 2
                   for p in paths)
    assert all(bgzf.is_bgzf(p) == (form != "gzip") for p in paths)
    got = _kmerize(paths)
    _same_set(got, _kmerize(lanes["paths"]["plain"][:n]))
    _same_set(got, G.kmerize(K, _seqs_of(lanes, n)))


@pytest.mark.parametrize("form", ["bgzf", "gzip"])
def test_the_cli_over_compressed_lanes_equals_the_jax_cli(lanes, env,
                                                          tmp_path, form):
    """``kmerize`` of both packages, in process, over the compressed lanes:
    the keys and counts of the plain files' set."""
    want = _kmerize(lanes["paths"]["plain"])
    flags = ["kmerize", "-k", str(K), "--batch-reads", str(BATCH),
             "--max-len", str(MAX_LEN)]
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", zcli.main, [])):
        out = str(tmp_path / f"{name}.zkf")
        assert main(flags + extra + [out] + lanes["paths"][form]) == 0
        got = container.read(out)
        assert got.k == K
        _same_set((got.keys, got.counts), want)


def _new_threads_end(before):
    for t in set(threading.enumerate()) - before:
        t.join(timeout=10)
        assert not t.is_alive(), t


def _broken(src, dst, fault):
    """A copy of the BGZF file ``src``: cut in the middle of a block
    before its EOF block, or with a bad CRC in its third block."""
    data = bytearray(open(src, "rb").read())
    if fault == "truncated":
        data = data[:len(data) // 2 + 7]
    else:
        off = 0
        for _ in range(2):
            off += struct.unpack("<H", data[off + 16:off + 18])[0] + 1
        end = off + struct.unpack("<H", data[off + 16:off + 18])[0] + 1
        data[end - 8] ^= 0xFF          # the block's CRC32
    with open(dst, "wb") as f:
        f.write(bytes(data))
    return str(dst)


@pytest.mark.parametrize("n", [1, LANES], ids=["serial", "pool"])
@pytest.mark.parametrize("fault", ["truncated", "bad_crc"])
def test_an_inflate_error_reaches_the_caller(lanes, env, tmp_path, fault,
                                             n):
    paths = list(lanes["paths"]["bgzf"][:n])
    paths[n // 2] = _broken(paths[n // 2], tmp_path / "bad.fastq.gz", fault)
    before = set(threading.enumerate())
    with pytest.raises((ValueError, zlib.error),
                       match="truncated|corrupt|incorrect data check"):
        _kmerize(paths)
    _new_threads_end(before)


def _inflate_counters(paths, traced=True):
    metrics.reset_counters()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            _kmerize(paths)
    else:
        _kmerize(paths)
    return {k: v for k, v in metrics.counters().items()
            if k.startswith("inflate.")}


@pytest.mark.parametrize("n", [1, LANES], ids=["serial", "pool"])
@pytest.mark.parametrize("form", FORMS + ("bgzf_groups",))
def test_a_traced_call_counts_what_was_inflated(lanes, env, form, n):
    """Exactly: the FASTQ bytes out, the files' member bytes in, one thread
    a file of one group (a plain gzip file's prefetch thread, or the one
    task of a BGZF pool); seconds above 0. A BGZF file of many groups counts
    the threads of its pool that ran a task. Nothing for plain files."""
    paths = lanes["paths"]["bgzf" if form == "bgzf_groups" else form][:n]
    if form == "bgzf_groups":
        env.setattr(bgzf, "GROUP_BYTES", BLOCK)
    got = _inflate_counters(paths)
    if form == "plain":
        assert got == {}
        return
    assert set(got) == {"inflate.bytes_in", "inflate.bytes_out",
                        "inflate.s", "inflate.threads"}
    assert got["inflate.bytes_out"] == sum(map(len, lanes["texts"][:n]))
    assert got["inflate.bytes_in"] == sum(map(os.path.getsize, paths))
    if form == "bgzf_groups":
        assert n <= got["inflate.threads"] <= n * BGZF_WORKERS
    else:
        assert got["inflate.threads"] == n
    assert got["inflate.s"] > 0


@pytest.mark.parametrize("form", ["bgzf", "gzip"])
def test_an_untraced_call_counts_nothing(lanes, env, form):
    assert _inflate_counters(lanes["paths"][form], traced=False) == {}
