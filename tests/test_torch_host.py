"""zotpu_torch's own host modules against the JAX package's originals, on
seeded numpy inputs. The port imports nothing of ``zotpu``; it keeps a copy
of every host module it uses (semantics, io/{delta,bgzf,container,prefetch,
native,fastq,wire}, reference_impl/golden, variants, sparse, stats, the
host-only CLI commands), and this file holds each copy equal to its original: equal
values, byte-equal files, byte-equal command output."""

import gzip
import importlib
import io
import json
import struct
import zlib

import numpy as np
import pytest

from zotpu import cli as zcli
from zotpu_torch import cli as tcli

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


def _pair(name):
    return (importlib.import_module(f"zotpu.{name}"),
            importlib.import_module(f"zotpu_torch.{name}"))


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(a, np.generic):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


# ---------------------------------------------------------------- semantics

_CONSTANTS = ["BASE_A", "BASE_C", "BASE_G", "BASE_T", "INVALID_CODE", "K_MAX", "COUNT_DTYPE", "COUNT_MAX", "KEY_DTYPE",
              "SENTINEL_KEY", "SENTINEL_HI", "SENTINEL_LO", "ENCODE_LUT",
              "DECODE_LUT"]


@pytest.mark.parametrize("name", _CONSTANTS)
def test_semantics_constants_equal(name):
    zs, ts = _pair("semantics")
    _same(getattr(zs, name), getattr(ts, name))


def _keys(rng, k, n=500):
    return rng.integers(0, 1 << (2 * k), n, dtype=np.uint64)


_SEMANTICS_CALLS = {
    "key_bits": lambda rng, k: (k,),
    "key_mask": lambda rng, k: (k,),
    "rc_u64": lambda rng, k: (k, _keys(rng, k)),
    "canonical_u64": lambda rng, k: (k, _keys(rng, k)),
    "shard_of_u64": lambda rng, k: (k, min(3, 2 * k), _keys(rng, k)),
    "split_hi_lo": lambda rng, k: (_keys(rng, k),),
    "join_hi_lo": lambda rng, k: (
        rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)),
    "routing_mix32": lambda rng, k: (
        rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)),
    "murmur_mix_u64": lambda rng, k: (_keys(rng, k), 7),
    "popcnt_u64": lambda rng, k: (_keys(rng, k),),
    "ham_u64": lambda rng, k: (_keys(rng, k), _keys(rng, k)),
    "lcp_u64": lambda rng, k: (k, _keys(rng, k), _keys(rng, k)),
    "saturating_add_counts": lambda rng, k: (
        rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)),
}


@pytest.mark.parametrize("k", [1, 16, 25, 31])
@pytest.mark.parametrize("fn", sorted(_SEMANTICS_CALLS))
def test_semantics_functions_equal(fn, k):
    zs, ts = _pair("semantics")
    args = _SEMANTICS_CALLS[fn](np.random.default_rng(k), k)
    _same(getattr(zs, fn)(*args), getattr(ts, fn)(*args))


@pytest.mark.parametrize("k", [0, 32])
def test_semantics_check_k_rejects(k):
    for mod in _pair("semantics"):
        with pytest.raises(ValueError):
            mod.check_k(k)


def test_semantics_public_names_match():
    zs, ts = _pair("semantics")
    names = lambda m: {n for n in dir(m) if not n.startswith("_")}
    assert names(zs) == names(ts)
    assert names(zs) - {"np", "annotations"} == (
        set(_CONSTANTS) | set(_SEMANTICS_CALLS) | {"check_k"})


# ------------------------------------------------------- delta and container

def _kmer_set(mod, rng, n, counts, k=25):
    keys = np.unique(rng.integers(0, 1 << (2 * k), n, dtype=np.uint64))
    if n:       # a delta above u32 and a count above u16: the exception list
        keys = np.unique(np.concatenate(
            [keys, [np.uint64((1 << 50) - 3)]])).astype(np.uint64)
    c = None
    if counts:
        c = rng.integers(1, 300, len(keys)).astype(np.uint32)
        if n:
            c[len(c) // 2] = 70000
    return mod.KmerSet(k=k, keys=keys, counts=c,
                       meta={"tool": "test", "inputs": ["a.fq"], "n": int(n)})


@pytest.mark.parametrize("counts", [False, True], ids=["kset", "kfset"])
def test_delta_codec_equal(counts):
    zd, td = _pair("io.delta")
    zc, _ = _pair("io.container")
    ks = _kmer_set(zc, np.random.default_rng(3), 4000, counts)
    enc_z, enc_t = zd.encode(ks.keys, ks.counts), td.encode(ks.keys, ks.counts)
    _same(enc_z, enc_t)
    _same(zd.decode(*enc_z, len(ks.keys)), td.decode(*enc_t, len(ks.keys)))


@pytest.mark.parametrize("n", [0, 3000])
@pytest.mark.parametrize("codec", ["raw", "zlib", "delta"])
@pytest.mark.parametrize("counts", [False, True], ids=["kset", "kfset"])
def test_container_written_by_either_is_read_by_the_other(tmp_path, counts,
                                                          codec, n):
    zc, tc = _pair("io.container")
    paths = {}
    for name, mod in (("jax", zc), ("port", tc)):
        ks = _kmer_set(mod, np.random.default_rng(n + counts), n, counts)
        paths[name] = tmp_path / f"{name}.zkf"
        mod.write(str(paths[name]), ks, codec=codec)
    # the same set and meta give the same file, byte for byte
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    for reader in (zc, tc):
        for path in paths.values():
            got = reader.read(str(path))
            assert got.k == ks.k and got.meta == ks.meta
            _same(got.keys, ks.keys)
            if counts:
                _same(got.counts, ks.counts)
            else:
                assert got.counts is None
            assert reader.read_header(str(path))["n"] == len(ks.keys)


@pytest.mark.parametrize("codec", ["raw", "zlib", "delta"])
def test_container_chunk_reader_equal(tmp_path, codec):
    zc, tc = _pair("io.container")
    ks = _kmer_set(tc, np.random.default_rng(9), 5000, True)
    path = str(tmp_path / "s.zkf")
    tc.write(path, ks, codec=codec)
    for a, b in zip(zc.ChunkReader(path).chunks(700),
                    tc.ChunkReader(path).chunks(700)):
        _same(tuple(a), tuple(b))


def test_container_casket_equal(tmp_path):
    zc, tc = _pair("io.container")
    rng = np.random.default_rng(1)
    members = {"a": _kmer_set(tc, rng, 300, True),
               "b": _kmer_set(tc, rng, 200, False)}
    for name, mod in (("jax", zc), ("port", tc)):
        mod.casket_write(str(tmp_path / f"{name}.zkc"),
                         [(n, mod.KmerSet(k=m.k, keys=m.keys, counts=m.counts,
                                          meta=m.meta))
                          for n, m in members.items()], meta={"x": 1})
    assert ((tmp_path / "jax.zkc").read_bytes()
            == (tmp_path / "port.zkc").read_bytes())
    got = zc.read(str(tmp_path / "port.zkc") + "#b")
    _same(got.keys, members["b"].keys)
    assert tc.casket_toc(str(tmp_path / "jax.zkc")) == zc.casket_toc(
        str(tmp_path / "jax.zkc"))


@pytest.mark.parametrize("where", ["file", "casket"])
@pytest.mark.parametrize("counts", [False, True], ids=["kset", "kfset"])
@pytest.mark.parametrize("n", [0, 3000])
def test_container_raw_read_returns_owned_arrays(tmp_path, n, counts, where):
    """A raw set, from a plain file or a casket member, is read into
    writable arrays of the file's dtypes that hold their own memory (no view
    of a bytes object), equal to what was written and to the JAX package's
    read."""
    zc, tc = _pair("io.container")
    rng = np.random.default_rng(n + counts)
    ks = _kmer_set(tc, rng, n, counts)
    path = str(tmp_path / "s.zkf")
    if where == "file":
        tc.write(path, ks)
    else:
        path = str(tmp_path / "c.zkc")
        tc.casket_write(path, [("x", _kmer_set(tc, rng, 50, True)),
                               ("s", ks)])
        path += "#s"
    got, want = tc.read(path), zc.read(path)
    assert got.k == want.k and got.meta == want.meta == ks.meta
    pairs = [(got.keys, want.keys, ks.keys, "<u8")]
    if counts:
        pairs.append((got.counts, want.counts, ks.counts, "<u4"))
    else:
        assert got.counts is None and want.counts is None
    for arr, jax_arr, written, dtype in pairs:
        assert arr.dtype == np.dtype(dtype)
        assert arr.flags.writeable
        assert arr.flags.owndata or not isinstance(arr.base, bytes)
        _same(arr, written)
        _same(arr, jax_arr)


@pytest.mark.parametrize("cut", ["keys", "counts"])
def test_container_raw_read_of_a_cut_file_raises(tmp_path, cut):
    """A raw file cut inside its keys or its counts blob raises
    ValueError from either package's read."""
    zc, tc = _pair("io.container")
    ks = _kmer_set(tc, np.random.default_rng(5), 3000, True)
    path = tmp_path / "s.zkf"
    tc.write(str(path), ks)
    data = path.read_bytes()
    counts_at = len(data) - 4 * ks.n
    end = (counts_at - 8 * (ks.n // 2) - 3 if cut == "keys"
           else len(data) - 4 * (ks.n // 2) - 1)
    path.write_bytes(data[:end])
    with pytest.raises(ValueError, match="truncated container"):
        tc.read(str(path))
    with pytest.raises(ValueError):
        zc.read(str(path))


# ------------------------------------------------------ fastq, native, wire

def _fastq_text(rng, n=300, fmt="fastq"):
    """Reads with N, lower case, empty and short reads, one longer than
    max_len, CRLF-free; deterministic."""
    out = []
    for i in range(n):
        length = int(rng.choice([0, 5, 24, 25, 60, 100, 150, 400],
                                p=[.02, .03, .05, .05, .2, .3, .3, .05]))
        seq = "".join(rng.choice(list("ACGTNacgt"), size=length,
                                 p=[.22] * 4 + [.02] + [.025] * 4))
        if fmt == "fastq":
            out.append(f"@r{i} x\n{seq}\n+\n{'I' * length}\n")
        else:
            out.append(f">r{i}\n" + "".join(
                seq[j:j + 70] + "\n" for j in range(0, max(length, 1), 70)))
    return "".join(out)


def _write_bgzf(path, data: bytes, block=20000):
    """A BGZF file: independent gzip members with a BC extra subfield, then
    the empty end-of-file member."""
    with open(path, "wb") as f:
        for off in list(range(0, len(data), block)) + [None]:
            chunk = b"" if off is None else data[off:off + block]
            comp = zlib.compressobj(6, zlib.DEFLATED, -15)
            body = comp.compress(chunk) + comp.flush()
            bsize = 12 + 6 + len(body) + 8 - 1
            f.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                    + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize)
                    + body + struct.pack("<II", zlib.crc32(chunk), len(chunk)))


@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(17)
    fq, fa = _fastq_text(rng), _fastq_text(rng, 40, "fasta")
    (d / "r.fastq").write_text(fq)
    (d / "r.fasta").write_text(fa)
    with gzip.open(d / "r.fastq.gz", "wb") as f:
        f.write(fq.encode())
    _write_bgzf(d / "r.bgzf.fastq.gz", fq.encode())
    return d


def _batches_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x.n_reads == y.n_reads and x.bases == y.bases
        _same(x.codes, y.codes)
        _same(x.lengths, y.lengths)
        _same(np.asarray(x.record_ids), np.asarray(y.record_ids))


@pytest.mark.parametrize("name", ["r.fastq", "r.fastq.gz", "r.bgzf.fastq.gz",
                                  "r.fasta"])
@pytest.mark.parametrize("max_reads,max_len,halo", [(64, 160, 24),
                                                    (7, 96, 0)])
def test_parse_batches_equal(read_files, name, max_reads, max_len, halo):
    zf, tf = _pair("io.fastq")
    path = str(read_files / name)
    assert zf.sniff_format(path) == tf.sniff_format(path)
    _batches_equal(zf.parse_batches(path, max_reads, max_len, halo=halo),
                   tf.parse_batches(path, max_reads, max_len, halo=halo))


@pytest.mark.parametrize("name", ["r.fastq", "r.fastq.gz", "r.fasta"])
def test_record_readers_equal(read_files, name):
    zf, tf = _pair("io.fastq")
    path = str(read_files / name)
    reader = "read_fasta" if name.endswith("fasta") else "read_fastq"
    with zf.open_file(path) as f, tf.open_file(path) as g:
        assert list(getattr(zf, reader)(f)) == list(getattr(tf, reader)(g))


def test_parse_small_chunks_equal(read_files, monkeypatch):
    """Records that straddle chunk boundaries: both packages read
    ZOTPU_CHUNK_BYTES."""
    zf, tf = _pair("io.fastq")
    monkeypatch.setenv("ZOTPU_CHUNK_BYTES", "4096")
    path = str(read_files / "r.fastq.gz")
    _batches_equal(zf.parse_batches(path, 32, 128, halo=24),
                   tf.parse_batches(path, 32, 128, halo=24))


def test_bgzf_detected_by_both(read_files):
    zb, tb = _pair("io.bgzf")
    for name, want in (("r.bgzf.fastq.gz", True), ("r.fastq.gz", False)):
        assert zb.is_bgzf(str(read_files / name)) is want
        assert tb.is_bgzf(str(read_files / name)) is want


def test_native_backend_and_buffer_parse_equal(read_files):
    """The port builds its own parser (into zotpu_torch/_build/) and says
    which one is in use; where g++ exists both packages parse natively and
    agree, and the numpy fallback gives the same batches either way."""
    zn, tn = _pair("io.native")
    assert tn.backend() in ("native", "numpy")
    assert (tn.backend() == "native") == (tn.get_lib() is not None)
    buf = (read_files / "r.fastq").read_bytes()
    a, b = zn.parse_fastq_buffer(buf, 64, 160), tn.parse_fastq_buffer(
        buf, 64, 160)
    assert (a is None) == (zn.get_lib() is None)
    assert (b is None) == (tn.backend() == "numpy")
    if a is not None and b is not None:
        n = a[2]
        assert a[2:] == b[2:]
        _same(a[0][:n], b[0][:n])
        _same(a[1][:n], b[1][:n])


@pytest.mark.parametrize("rows,L", [(1, 32), (37, 160), (5, 4096)])
def test_wire_pack_codes_byte_equal(rows, L, monkeypatch):
    zw, tw = _pair("io.wire")
    codes = np.random.default_rng(L).integers(0, 5, (rows, L)).astype(np.uint8)
    a, b = zw.pack_codes(codes), tw.pack_codes(codes)
    _same(a, b)
    assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()
    # and the port's numpy fallback against its native pack
    tn = importlib.import_module("zotpu_torch.io.native")
    monkeypatch.setattr(tn, "pack_wire", lambda codes: None)
    _same(tw.pack_codes(codes), b)
    with pytest.raises(ValueError):
        tw.pack_codes(codes[:, :24])


def test_wire_carries_no_jax_unpack():
    assert not hasattr(importlib.import_module("zotpu_torch.io.wire"),
                       "unpack_codes")


def test_prefetch_equal():
    zp, tp = _pair("io.prefetch")
    for mod in (zp, tp):
        assert list(mod.prefetch(iter(range(50)), depth=3)) == list(range(50))
        got = sorted(mod.prefetch_many(
            [lambda lo=lo: iter(range(lo, lo + 5)) for lo in (0, 10, 20)],
            workers=2))
        assert got == [(i, 10 * i + j) for i in range(3) for j in range(5)]

        def boom():
            yield 1
            raise RuntimeError("parse failed")
        with pytest.raises(RuntimeError, match="parse failed"):
            list(mod.prefetch(boom()))


# ------------------------------------------------------------------- golden

def _seqs(rng, n=60):
    return ["".join(rng.choice(list("ACGTN"), size=int(rng.integers(0, 200)),
                               p=[.245] * 4 + [.02])) for _ in range(n)]


@pytest.mark.parametrize("k", [1, 15, 25, 31])
def test_golden_kmerize_and_scan_equal(k):
    zg, tg = _pair("reference_impl.golden")
    seqs = _seqs(np.random.default_rng(k))
    a, b = zg.kmerize(k, seqs), tg.kmerize(k, seqs)
    _same(a, b)
    panel = a[0][::3]
    _same(zg.scan_panel(k, panel, seqs), tg.scan_panel(k, panel, seqs))
    _same(zg.kmerize_seq(k, seqs[1]), tg.kmerize_seq(k, seqs[1]))
    assert [zg.decode_kmer(k, int(x)) for x in a[0][:5]] == [
        tg.decode_kmer(k, int(x)) for x in b[0][:5]]


@pytest.mark.parametrize("fn", ["merge", "union", "intersect", "difference",
                                "spectrum", "error_peak_cutoff", "sample"])
def test_golden_set_functions_equal(fn):
    zg, tg = _pair("reference_impl.golden")
    rng = np.random.default_rng(5)
    A = zg.kmerize(15, _seqs(rng, 80))
    B = zg.kmerize(15, _seqs(rng, 80))
    args = {"merge": ([A, B],), "union": (A, B), "intersect": (A, B),
            "difference": (A, B), "spectrum": (A[1],),
            "error_peak_cutoff": (zg.spectrum(A[1]),),
            "sample": (A[0], A[1], 0.3, 4)}[fn]
    _same(getattr(zg, fn)(*args), getattr(tg, fn)(*args))


# -------------------------------------------------------------------- stats

def _spectrum_hist(kind):
    """Count-of-counts tables shaped like real spectra (tests/test_stats.py
    builds its fixtures the same way), and the degenerate ones."""
    rng = np.random.default_rng(len(kind))
    if kind == "empty":
        return np.zeros(1025, np.float64)
    if kind == "short":
        return np.array([0, 5, 1], np.float64)
    if kind == "no_valley":
        return np.concatenate([[0], 1000.0 / np.arange(1, 60)])
    lam = {"cov12": 12, "cov30": 30, "cov30_repeats": 30}[kind]
    counts = np.concatenate([
        rng.poisson(lam, 40000), 1 + rng.poisson(0.3, 9000),
        rng.poisson(2 * lam, 4000 if kind.endswith("repeats") else 0)])
    return np.bincount(np.minimum(counts, 1024),
                       minlength=1025).astype(np.float64)


_STATS_CALLS = {
    "log_gamma": lambda rng: (rng.uniform(0.01, 200, 300),),
    "log_fac": lambda rng: (rng.integers(0, 500, 300),),
    "log_choose": lambda rng: (rng.integers(50, 500, 300),
                               rng.integers(0, 50, 300)),
    "log_add": lambda rng: (np.append(rng.normal(0, 50, 300), -np.inf),
                            np.append(rng.normal(0, 50, 300), -np.inf)),
    "log_sum": lambda rng: (np.vstack([rng.normal(0, 50, (20, 30)),
                                       np.full((1, 30), -np.inf)]),),
    "log_poisson_pdf": lambda rng: (7.5, np.arange(60)),
    "poisson_pdf": lambda rng: (0.8, np.arange(20)),
    "poisson_cdf": lambda rng: (25.0, 30),
    "log_gamma_pdf": lambda rng: (rng.uniform(0.5, 9, 50),
                                  rng.uniform(0.1, 3, 50),
                                  rng.uniform(0.1, 40, 50)),
    "ks_distance": lambda rng: (np.sort(rng.random(100)),
                                np.sort(rng.random(100))),
}


@pytest.mark.parametrize("fn", sorted(_STATS_CALLS))
def test_stats_functions_equal(fn):
    zs, ts = _pair("stats")
    args = _STATS_CALLS[fn](np.random.default_rng(len(fn)))
    _same(getattr(zs, fn)(*args), getattr(ts, fn)(*args))


@pytest.mark.parametrize("max_cov", [100, 40])
@pytest.mark.parametrize("kind", ["cov12", "cov30", "cov30_repeats", "empty",
                                  "short", "no_valley"])
def test_stats_spectrum_mixture_fit_equal(kind, max_cov):
    zs, ts = _pair("stats")
    h = _spectrum_hist(kind)
    dz = zs.spectrum_mixture_fit_detail(h, max_cov=max_cov)
    dt = ts.spectrum_mixture_fit_detail(h, max_cov=max_cov)
    assert dz == dt and list(dz) == list(dt)
    assert [type(v) for v in dz.values()] == [type(v) for v in dt.values()]
    assert zs.spectrum_mixture_fit(h, max_cov=max_cov) == (
        ts.spectrum_mixture_fit(h, max_cov=max_cov))
    if kind.startswith("cov"):
        lam = 12 if kind == "cov12" else 30
        assert abs(dt["lam_g"] - lam) < 0.1 * lam and dt["cutoff"] > 1


def test_stats_public_names_match():
    zs, ts = _pair("stats")
    names = lambda m: {n for n in dir(m) if not n.startswith("_")}
    assert names(zs) == names(ts)
    assert names(ts) - {"np", "annotations"} == set(_STATS_CALLS) | {
        "spectrum_mixture_fit", "spectrum_mixture_fit_detail"}


# --------------------------------------------------- variants, sparse, CLI

@pytest.fixture(scope="module")
def variant_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("variants")
    rng = np.random.default_rng(23)
    seq = "".join(rng.choice(list("ACGT"), size=1500))
    (d / "ref.fa").write_text(">chr1 test\n" + "".join(
        seq[i:i + 60] + "\n" for i in range(0, len(seq), 60)))
    alt = "G" if seq[399] != "G" else "T"
    specs = {"snv": f"chr1:g.400{seq[399]}>{alt}",
             "del": "chr1:g.800_802del",
             "ins": "chr1:g.1000_1001insTTA",
             "delins": "chr1:g.1200_1203delinsGG"}
    (d / "vars.txt").write_text("# a panel\n" + "".join(
        f"{s}  # {n}\n" for n, s in specs.items()))
    return d, specs


@pytest.mark.parametrize("name", ["snv", "del", "ins", "delins"])
def test_variant_probes_equal(variant_files, name):
    d, specs = variant_files
    zv, tv = _pair("variants")
    ref_z, ref_t = (m.load_reference(str(d / "ref.fa")) for m in (zv, tv))
    assert ref_z == ref_t
    vz = zv.resolve_variant(zv.parse_variant(specs[name]), ref_z)
    vt = tv.resolve_variant(tv.parse_variant(specs[name]), ref_t)
    assert vars(vz) == vars(vt)
    _same(zv.probe_kmers(vz, ref_z, 21), tv.probe_kmers(vt, ref_t, 21))
    assert zv.apply_variant(ref_z["chr1"], vz) == tv.apply_variant(
        ref_t["chr1"], vt)


def test_variant_panel_evidence_and_spike_equal(variant_files, tmp_path):
    d, specs = variant_files
    zv, tv = _pair("variants")
    zg, _ = _pair("reference_impl.golden")
    zf, _ = _pair("io.fastq")
    pz = zv.build_panel(list(specs.values()), str(d / "ref.fa"), 21)
    pt = tv.build_panel(list(specs.values()), str(d / "ref.fa"), 21)
    _same(pz[0], pt[0])
    assert pz[1] == pt[1]
    for name, mod in (("z", zv), ("t", tv)):
        mod.spike_reads(str(d / "ref.fa"), list(specs.values()),
                        str(tmp_path / f"{name}.fq"), coverage=20, vaf=0.4,
                        read_len=100, error_rate=0.002, seed=3)
    assert (tmp_path / "z.fq").read_bytes() == (tmp_path / "t.fq").read_bytes()
    with zf.open_file(str(tmp_path / "z.fq")) as f:
        keys, counts = zg.kmerize(21, [s for _, s, _ in zf.read_fastq(f)])
    assert zv.evidence_from_counts(pz[1], keys, counts) == (
        tv.evidence_from_counts(pt[1], keys, counts))


def test_sparse_set_equal():
    zs, ts = _pair("sparse")
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 1 << 40, 3000, dtype=np.uint64))
    q = np.concatenate([keys[::7], rng.integers(0, 1 << 40, 200,
                                                dtype=np.uint64)])
    a, b = zs.SparseSet(keys), ts.SparseSet(keys)
    assert len(a) == len(b)
    _same(a.rank(q), b.rank(q))
    _same(a.access(q), b.access(q))
    _same(a.select(np.arange(0, len(keys), 11)),
          b.select(np.arange(0, len(keys), 11)))
    assert a.count_range(int(keys[10]), int(keys[900])) == b.count_range(
        int(keys[10]), int(keys[900]))


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture(scope="module")
def cli_sets(tmp_path_factory):
    """Two overlapping k-mer sets, a counts-less set and a k=15 set."""
    zc, _ = _pair("io.container")
    zg, _ = _pair("reference_impl.golden")
    d = tmp_path_factory.mktemp("sets")
    rng = np.random.default_rng(31)
    seqs = _seqs(rng, 50)
    a = zg.kmerize(21, seqs)
    b = zg.kmerize(21, seqs[:30] + _seqs(rng, 10))
    zc.write(str(d / "a.zkf"), zc.KmerSet(k=21, keys=a[0], counts=a[1]))
    zc.write(str(d / "a2.zkf"), zc.KmerSet(k=21, keys=a[0], counts=a[1]),
             codec="delta")
    zc.write(str(d / "b.zkf"), zc.KmerSet(k=21, keys=b[0], counts=b[1]))
    zc.write(str(d / "noc.zkf"), zc.KmerSet(k=21, keys=a[0], counts=None))
    c = zg.kmerize(15, seqs)
    zc.write(str(d / "k15.zkf"), zc.KmerSet(k=15, keys=c[0], counts=c[1]))
    zc.write(str(d / "empty.zkf"), zc.KmerSet(
        k=21, keys=np.zeros(0, np.uint64), counts=np.zeros(0, np.uint32)))
    return d, seqs


@pytest.mark.parametrize("argv", [
    ["a.zkf", "a2.zkf"], ["a.zkf", "b.zkf"], ["a.zkf", "k15.zkf"],
    ["a.zkf", "noc.zkf"], ["a.zkf", "noc.zkf", "--as-sets"],
    ["b.zkf", "a.zkf", "--as-sets"], ["empty.zkf", "empty.zkf"],
], ids=lambda a: "-".join(a))
def test_cmd_verify_output_byte_equal(cli_sets, capsys, argv):
    d, _ = cli_sets
    argv = ["verify"] + [a if a.startswith("--") else d / a for a in argv]
    assert _run(tcli.main, argv, capsys) == _run(zcli.main, argv, capsys)


@pytest.mark.parametrize("case", ["kmers", "seq", "miss", "empty_set",
                                  "at_file", "wrong_length"])
def test_cmd_query_output_byte_equal(cli_sets, tmp_path, capsys, case):
    d, seqs = cli_sets
    long = next(s for s in seqs if len(s) > 60 and "N" not in s[:60])
    (tmp_path / "q.txt").write_text(f"{long[:21]}  # first\n\n# none\n"
                                    f"{long[5:26]}\n")
    argv = {"kmers": [d / "a.zkf", long[:21], long[3:24], "A" * 21],
            "seq": [d / "a.zkf", "--seq", long[:60], "ACGT" * 10, "NNNN"],
            "miss": [d / "a.zkf", "C" * 21],
            "empty_set": [d / "empty.zkf", long[:21]],
            "at_file": [d / "a.zkf", f"@{tmp_path / 'q.txt'}"],
            "wrong_length": [d / "a.zkf", "ACG"]}[case]
    got = _run(tcli.main, ["query", *argv], capsys)
    assert got == _run(zcli.main, ["query", *argv], capsys)
    assert got[0] == (1 if case in ("miss", "empty_set", "wrong_length")
                      else 0)


@pytest.mark.parametrize("codec", [None, "zlib", "delta"])
@pytest.mark.parametrize("how", ["argv", "at_file"])
def test_cmd_probes_output_byte_equal(variant_files, tmp_path, capsys, how,
                                      codec):
    """The printed line is byte-equal; the container is the same file apart
    from the tool's name in its meta."""
    d, specs = variant_files
    tc = importlib.import_module("zotpu_torch.io.container")
    variants = list(specs.values()) if how == "argv" else [
        f"@{d / 'vars.txt'}"]
    outs = {}
    for name, main in (("port", tcli.main), ("jax", zcli.main)):
        out = tmp_path / f"{name}.zkf"
        argv = ["probes", "-k", 21, d / "ref.fa", out, *variants]
        if codec:
            argv += ["--codec", codec]
        rc, stdout, err = _run(main, argv, capsys)
        assert rc == 0, err
        outs[name] = (stdout, tc.read(str(out)))
    assert outs["port"][0] == outs["jax"][0]
    port, jax_ = outs["port"][1], outs["jax"][1]
    assert port.meta.pop("tool") == "zotpu_torch probes"
    assert jax_.meta.pop("tool") == "zotpu probes"
    assert port.meta == jax_.meta and port.k == jax_.k == 21
    _same(port.keys, jax_.keys)
    assert json.loads(outs["port"][0])["variants"] == len(specs)


def test_cli_helpers_equal(read_files, tmp_path):
    """The CLI's own copies of _read_all_seqs and _write_hit_reads."""
    paths = [str(read_files / n) for n in ("r.fastq.gz", "r.fasta")]
    assert tcli._read_all_seqs(paths) == zcli._read_all_seqs(paths)
    n = len(tcli._read_all_seqs(paths[:1]))
    hits = [i % 3 for i in range(n)]
    bufs = []
    for mod in (tcli, zcli):
        buf = io.StringIO()
        mod._write_hit_reads(buf, paths[0], hits, 2)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1] and bufs[0].count("\n") == 4 * hits.count(2)
