"""kmerize over gzip-compressed lanes on the CPU: BGZF (bgzip) and plain
gzip ``.fastq.gz`` files through ``workloads.kmerize.kmerize_paths`` and
the CLI, against the same reads as plain FASTQ, golden and ``python -m
zotpu kmerize``; inflate errors reaching the caller; each BGZF member
inflated from its own slice of a group; and the counters ``inflate.*``
that ``workloads/feed.batches`` records for a traced call."""

import gzip
import os
import struct
import threading
import tracemalloc
import types
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zotpu import cli as zcli
from zotpu.io import bgzf as zbgzf
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


def _fastq_bytes(n_bytes, seed=25):
    """FASTQ records of 150 random bases and binned qualities, about
    ``n_bytes`` of them."""
    rng = np.random.default_rng(seed)
    recs, size, i = [], 0, 0
    while size < n_bytes:
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 150).tobytes()
        qual = rng.choice(np.frombuffer(b"F:,#", np.uint8), 150,
                          p=[.8, .12, .06, .02]).tobytes()
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, qual))
        size += len(recs[-1])
        i += 1
    return b"".join(recs)


def _blocks(path):
    """The BGZF file's blocks, each its own bytes."""
    return list(bgzf._iter_groups(str(path), 1))


WRITERS = {
    "level1": lambda path, data: bgzf.write_bgzf(path, data, level=1),
    "level6": lambda path, data: bgzf.write_bgzf(path, data, level=6),
    "htslib_0xff00": lambda path, data: _write_bgzf(path, data, 0xFF00),
}
# the members of a group: data blocks first, then the EOF block or not
GROUPS = {"one": (1, False), "two": (2, False), "many": (9, False),
          "eof_only": (0, True), "many_then_eof": (9, True)}


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("writer", WRITERS)
def test_each_member_inflates_as_gzip_and_jax(tmp_path, writer, group):
    """A group of whole members inflates to the bytes that the standard
    library's gzip and the JAX package's ``_inflate_members`` give, which
    are the data the blocks hold."""
    n, eof = GROUPS[group]
    data = _fastq_bytes(9 * 0xFF00)
    WRITERS[writer](tmp_path / "r.fastq.gz", data)
    blocks = _blocks(tmp_path / "r.fastq.gz")
    assert len(blocks) == 11
    group_bytes = b"".join(blocks[:n] + blocks[-1:] * eof)
    got = bgzf._inflate_members(group_bytes)
    assert got == gzip.decompress(group_bytes)
    assert got == zbgzf._inflate_members(group_bytes)
    assert got == data[:len(got)] and len(got) == min(n * 0xFF00, len(data))


def test_zlib_sees_one_member_at_a_time(tmp_path, monkeypatch):
    """zlib, as the port's bgzf module reaches it, is handed each member of
    a group of 60 once and alone: no input over BGZF's 65,536 bytes, and
    the inputs add up to the group. The rest of the group is never handed
    over (it would be copied, as ``unused_data``, once a member)."""
    sizes = []

    class Recorded:
        def __init__(self, obj):
            self._obj = obj

        def decompress(self, data, *args):
            sizes.append(len(data))
            return self._obj.decompress(data, *args)

        def __getattr__(self, name):
            return getattr(self._obj, name)

    def decompress(data, *args):
        sizes.append(len(data))
        return zlib.decompress(data, *args)

    monkeypatch.setattr(bgzf, "zlib", types.SimpleNamespace(
        decompress=decompress,
        decompressobj=lambda *a, **kw: Recorded(zlib.decompressobj(*a, **kw))))
    data = _fastq_bytes(59 * BLOCK)
    _write_bgzf(tmp_path / "r.fastq.gz", data)
    group = b"".join(_blocks(tmp_path / "r.fastq.gz"))
    assert bgzf._inflate_members(group) == data
    assert len(sizes) == 61
    assert max(sizes) <= 65_536 and sum(sizes) == len(group)


def _member(piece, pad=b"", body_cut=0, isize=None, magic=b"\x1f\x8b",
            subfield=b"BC"):
    """A BGZF member of ``piece``, broken as asked: ``pad`` bytes after its
    gzip trailer inside its BSIZE, ``body_cut`` bytes cut from the end of
    its deflate stream, another ISIZE, another magic or another subfield
    id."""
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = comp.compress(piece) + comp.flush()
    body = body[:len(body) - body_cut]
    tail = struct.pack("<II", zlib.crc32(piece),
                       len(piece) if isize is None else isize) + pad
    bsize = 12 + 6 + len(body) + len(tail) - 1
    return (magic + b"\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6) + subfield
            + struct.pack("<HH", 2, bsize) + body + tail)


FAULTS = {
    "padded": ({"pad": b"\0\0\0"}, ValueError, "corrupt BGZF block at "),
    "unended": ({"body_cut": 9}, ValueError, "incomplete or truncated"),
    "isize_ffffffff": ({"isize": 0xFFFFFFFF}, zlib.error,
                       "incorrect length check"),
    "not_gzip": ({"magic": b"\x1f\x8c"}, ValueError,
                 "corrupt BGZF block header"),
    "no_bc": ({"subfield": b"BD"}, ValueError, "without BC subfield"),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_member_raises(fault):
    """The third member of a group, broken; the error names its offset in
    the group. An ISIZE of 0xFFFFFFFF fails zlib's length check and
    allocates nothing near that size."""
    kw, exc, match = FAULTS[fault]
    data = _fastq_bytes(4 * BLOCK)
    pieces = [data[i:i + BLOCK] for i in range(0, 4 * BLOCK, BLOCK)]
    members = [_member(p) for p in pieces[:2]]
    members += [_member(pieces[2], **kw), _member(pieces[3])]
    group = b"".join(members)
    tracemalloc.start()
    try:
        with pytest.raises(exc, match=match):
            bgzf._inflate_members(group)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20
    if exc is ValueError:
        offset = len(members[0]) + len(members[1])
        with pytest.raises(ValueError, match=f"at offset {offset}\\b"):
            bgzf._inflate_members(group)


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
    the threads of its pool that ran a task. The members inflated, each
    from its own slice, are the BGZF files' blocks, the EOF block
    included; a plain gzip file counts none. Nothing for plain files."""
    paths = lanes["paths"]["bgzf" if form == "bgzf_groups" else form][:n]
    if form == "bgzf_groups":
        env.setattr(bgzf, "GROUP_BYTES", BLOCK)
    got = _inflate_counters(paths)
    if form == "plain":
        assert got == {}
        return
    assert set(got) == {"inflate.bytes_in", "inflate.bytes_out",
                        "inflate.s", "inflate.threads", "inflate.members"}
    assert got["inflate.bytes_out"] == sum(map(len, lanes["texts"][:n]))
    blocks = sum(-(-len(t) // BLOCK) + 1 for t in lanes["texts"][:n])
    assert got["inflate.members"] == (0 if form == "gzip" else blocks)
    assert got["inflate.bytes_in"] == sum(map(os.path.getsize, paths))
    if form == "bgzf_groups":
        assert n <= got["inflate.threads"] <= n * BGZF_WORKERS
    else:
        assert got["inflate.threads"] == n
    assert got["inflate.s"] > 0


@pytest.mark.parametrize("form", ["bgzf", "gzip"])
def test_an_untraced_call_counts_nothing(lanes, env, form):
    assert _inflate_counters(lanes["paths"][form], traced=False) == {}
