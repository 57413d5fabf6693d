"""The port's two-process runs against the JAX package's own two-process
runs (the form of tests/test_multiprocess.py: ``python -m zotpu`` in two
processes of 4 fake CPU devices each on jax.distributed, 8 shards), on the
same inputs: ``kmerize`` (prefix and mixed; containers and stats lines),
``kmerize --spill-dir`` (the per-process run files byte for byte, then
the resumed container), ``scan --per-read`` (every printed line) and the
streamed ``union`` (container and line). The port runs ``python -m
zotpu_torch ... --device cpu --shards 8`` in two processes on gloo (4
slots each). Marked slow: about a minute of processes. Tolerance: exact
equality."""

import json
import os

import numpy as np
import pytest

from tests.test_torch_multiproc_mesh import free_port, spawn
from zotpu.io import container
from zotpu.reference_impl import golden as G

pytestmark = pytest.mark.slow

K = 17
BATCH = ["--batch-reads", 16, "--max-len", 96]


def _jax_env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", ZOTPU_PLATFORM="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return env


def _pair(package, argv, cwd):
    """The command in two processes of ``package``; their outputs."""
    port = free_port()
    extra, env = [], _jax_env()
    if package == "zotpu_torch":   # 4 slots a process, as 4 fake devices
        extra = ["--device", "cpu"] + ([] if "--shards" in argv
                                       else ["--shards", 8])
        env = None
    res = spawn([["-m", package, *argv, *extra, "--coordinator",
                  f"127.0.0.1:{port}", "--num-processes", 2, "--process-id",
                  pid] for pid in range(2)], timeout=240, cwd=cwd, env=env)
    for rc, out in res:
        assert rc == 0, out
    # the result lines: JSON, and per-read rows (they start with the path)
    return [[x for x in out.splitlines() if x.startswith(("{", str(cwd)))]
            for _, out in res]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_multiprocess.py's inputs: 2 x 40 reads of 90 bp, and a
    scan panel of a 600 bp source with 2 x 30 reads of 80 bp."""
    d = tmp_path_factory.mktemp("mpj")
    rng = np.random.default_rng(7)
    paths, seqs = [], []
    for i in range(2):
        reads = ["".join(rng.choice(list("ACGT"), size=90))
                 for _ in range(40)]
        (d / f"in{i}.fastq").write_text("".join(
            f"@r{i}_{j}\n{s}\n+\n{'I' * len(s)}\n"
            for j, s in enumerate(reads)))
        paths.append(str(d / f"in{i}.fastq"))
        seqs += reads
    src = "".join(rng.choice(list("ACGT"), size=600))
    pk, _ = G.kmerize(13, [src])
    container.write(str(d / "panel.zkf"), container.KmerSet(k=13, keys=pk))
    samples = []
    for i in range(2):
        reads = [src[o:o + 80] if j % 3 == 0 else
                 "".join(rng.choice(list("ACGTN"), size=80))
                 for j, o in enumerate(rng.integers(0, 520, 30))]
        (d / f"s{i}.fastq").write_text("".join(
            f"@r{i}_{j}\n{s}\n+\n{'I' * len(s)}\n"
            for j, s in enumerate(reads)))
        samples.append(str(d / f"s{i}.fastq"))
    a = np.unique(rng.integers(0, 1 << 42, 4000, dtype=np.uint64))
    b = np.unique(np.concatenate([a[::3], rng.integers(
        0, 1 << 42, 3000, dtype=np.uint64)]))
    for name, keys in (("a", a), ("b", b)):
        container.write(str(d / f"{name}.zkf"), container.KmerSet(
            k=21, keys=keys,
            counts=rng.integers(1, 60, len(keys)).astype(np.uint32)))
    return d, paths, seqs, samples


def _same_set(p, q):
    a, b = container.read(str(p)), container.read(str(q))
    assert a.k == b.k
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(a.counts, b.counts)


@pytest.mark.parametrize("shard_hash", ["prefix", "mixed"])
def test_kmerize_two_processes_match_jax(data, shard_hash):
    d, paths, seqs, _ = data
    outs = {}
    for pkg in ("zotpu", "zotpu_torch"):
        out = d / f"{pkg}_{shard_hash}.zkf"
        lines = _pair(pkg, ["kmerize", "-k", K, *BATCH, "--shard-hash",
                            shard_hash, out, *paths], d)
        outs[pkg] = [json.loads(x[-1]) for x in lines]
    _same_set(d / f"zotpu_{shard_hash}.zkf",
              d / f"zotpu_torch_{shard_hash}.zkf")
    assert outs["zotpu"] == outs["zotpu_torch"]
    want = G.kmerize(K, seqs)
    assert np.array_equal(container.read(
        str(d / f"zotpu_torch_{shard_hash}.zkf")).keys, want[0])


def test_spill_run_files_match_jax_byte_for_byte(data):
    d, paths, seqs, _ = data
    for pkg in ("zotpu", "zotpu_torch"):
        (d / f"spill_{pkg}").mkdir()
        _pair(pkg, ["kmerize", "-k", K, *BATCH, "--spill-dir",
                    d / f"spill_{pkg}", d / f"spill_{pkg}.zkf", *paths], d)
    names = sorted(os.listdir(d / "spill_zotpu"))
    assert names == sorted(os.listdir(d / "spill_zotpu_torch"))
    assert {n.split(".")[1] for n in names} == {"p0", "p1"}
    for n in names:
        assert (d / "spill_zotpu" / n).read_bytes() == (
            d / "spill_zotpu_torch" / n).read_bytes(), n
    _same_set(d / "spill_zotpu.zkf", d / "spill_zotpu_torch.zkf")
    # each package resumes the other's directory, reusing every file
    _pair("zotpu_torch", ["kmerize", "-k", K, *BATCH, "--spill-dir",
                          d / "spill_zotpu", "--resume", d / "cross.zkf",
                          *paths], d)
    _same_set(d / "cross.zkf", d / "spill_zotpu.zkf")


def test_scan_two_processes_match_jax(data):
    d, _, _, samples = data
    got = {pkg: _pair(pkg, ["scan", *BATCH, "--per-read", "--shards", 8,
                            d / "panel.zkf", *samples], d)
           for pkg in ("zotpu", "zotpu_torch")}
    assert got["zotpu"] == got["zotpu_torch"]
    assert sum(len(x) for x in got["zotpu"]) == 2 + 60


def test_stream_union_two_processes_matches_jax(data):
    d, _, _, _ = data
    got = {}
    for pkg in ("zotpu", "zotpu_torch"):
        got[pkg] = _pair(pkg, ["union", d / f"u_{pkg}.zkf", d / "a.zkf",
                               d / "b.zkf"], d)
    assert got["zotpu"] == got["zotpu_torch"]
    _same_set(d / "u_zotpu.zkf", d / "u_zotpu_torch.zkf")
