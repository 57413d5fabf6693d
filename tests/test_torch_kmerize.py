"""The zotpu_torch kmerize slice end to end on the CPU: its CLI against the
JAX package's CLI on JAX-CPU and against the --host golden path, for the
wire path (--max-len 256) and the u8 path (--max-len 100); plus the import
firewall (no jax) and the no-fallback rule for --device cuda."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zotpu import cli as zcli
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu_torch import cli as tcli
from zotpu_torch import keys as K
from zotpu_torch.workloads import kmerize as TW

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """3000 reads from one seeded genome (so k-mers recur), ragged lengths,
    N bases, and one read longer than every --max-len (the halo path)."""
    rng = np.random.default_rng(2024)
    genome = rng.choice(list("ACGT"), size=20000)
    reads = []
    for _ in range(3000):
        n = int(rng.integers(10, 151))
        off = int(rng.integers(0, len(genome) - n))
        r = genome[off:off + n].copy()
        r[rng.random(n) < 0.01] = "N"
        reads.append("".join(r))
    reads.append("".join(genome[100:700]))
    path = tmp_path_factory.mktemp("kmerize") / "reads.fastq"
    _write_fastq(str(path), reads)
    return str(path), reads


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("max_len", [256, 100])
def test_kmerize_cli_matches_jax_and_golden(fastq, tmp_path, capsys, max_len):
    path, reads = fastq
    args = ["-k", "25", "--batch-reads", "512", "--max-len", str(max_len)]
    port, jx, host = (str(tmp_path / f) for f in ("t.zkf", "j.zkf", "h.zkf"))
    assert tcli.main(["kmerize", *args, "--device", "cpu", port, path]) == 0
    stats = _last_json(capsys)
    assert zcli.main(["kmerize", *args, jx, path]) == 0
    jstats = _last_json(capsys)
    assert zcli.main(["kmerize", "-k", "25", "--host", host, path]) == 0
    capsys.readouterr()

    ks = container.read(port)
    want_k, want_c = G.kmerize(25, reads)
    assert np.array_equal(ks.keys, want_k)
    assert np.array_equal(ks.counts, want_c)
    assert ks.meta["tool"] == "zotpu_torch kmerize"
    assert stats["batches"] > 2                 # the accumulator merged
    assert stats == jstats                      # the whole line, every key
    assert stats["reads"] == len(reads)
    for other in (jx, host):
        assert zcli.main(["verify", port, other]) == 0
        assert _last_json(capsys)["equal"] is True
    assert tcli.main(["verify", port, host]) == 0
    assert _last_json(capsys)["equal"] is True


def test_kmerize_paths_multi_file_matches_golden(fastq, tmp_path):
    """Two files parse in the worker pool and interleave their batches."""
    path, reads = fastq
    second = str(tmp_path / "second.fastq")
    _write_fastq(second, reads[:700])
    stats = TW.Stats()
    keys, counts = TW.kmerize_paths([path, second], 21, batch_reads=256,
                                    max_len=128, stats=stats, device="cpu")
    want_k, want_c = G.kmerize(21, reads + reads[:700])
    assert np.array_equal(keys, want_k)
    assert np.array_equal(counts, want_c)
    assert stats.reads == len(reads) + 700


def test_kmerize_capacity_error(fastq):
    """CapacityError iff the unique count exceeds max(merge_capacity,
    level-0 capacity); 64 rows of 104 windows keep level 0 below it."""
    path, reads = fastq
    n_unique = len(G.kmerize(25, reads)[0])
    assert n_unique > 64 * 104
    from zotpu_torch.workloads.accumulator import CapacityError
    with pytest.raises(CapacityError):
        TW.kmerize_paths([path], 25, batch_reads=64, max_len=128,
                         merge_capacity=n_unique - 1, device="cpu")
    keys, _ = TW.kmerize_paths([path], 25, batch_reads=64, max_len=128,
                               merge_capacity=n_unique, device="cpu")
    assert len(keys) == n_unique


def test_kmerize_spill_dir_not_yet_ported(fastq, tmp_path):
    """The name is from when ``spill_dir`` raised NotImplementedError: it
    is ported now, and a spill run equals golden (test_torch_spill.py holds
    it against the JAX package)."""
    keys, counts = TW.kmerize_paths([fastq[0]], 25, batch_reads=512,
                                    spill_dir=str(tmp_path), device="cpu")
    want_k, want_c = G.kmerize(25, fastq[1])
    assert np.array_equal(keys, want_k) and np.array_equal(counts, want_c)
    assert len(list(tmp_path.glob("run*.zkf"))) > 2


def test_stats_line_and_meta_have_exactly_the_jax_keys(fastq, tmp_path,
                                                       capsys):
    """The whole key set, in order, of the JSON line and of the container's
    meta["stats"], one device and sharded: ``second_rounds`` is an
    attribute of the port's Stats and stays out of as_dict()."""
    from zotpu.workloads import kmerize as JW
    assert list(TW.Stats().as_dict()) == list(JW.Stats().as_dict())
    assert TW.Stats().as_dict() == JW.Stats().as_dict()
    assert hasattr(TW.Stats(), "second_rounds")
    path = fastq[0]
    for shards in ([], ["--shards", "2"]):
        args = ["kmerize", "-k", "25", "--batch-reads", "1024", *shards]
        port, jx = str(tmp_path / "t.zkf"), str(tmp_path / "j.zkf")
        assert tcli.main([*args, "--device", "cpu", port, path]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert zcli.main([*args, jx, path]) == 0
        assert line == capsys.readouterr().out.strip().splitlines()[-1]
        assert list(json.loads(line)) == ["command", *JW.Stats().as_dict()]
        pm, jm = container.read(port).meta, container.read(jx).meta
        assert pm["stats"] == jm["stats"]
        assert list(pm["stats"]) == list(jm["stats"])
        assert pm["inputs"] == jm["inputs"] and list(pm) == list(jm)


def test_kmerize_host_flag_matches_jax(fastq, tmp_path, capsys, monkeypatch):
    """--host is the golden numpy path with its own stats; it needs no
    device, so it runs where --device cuda would exit 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, reads = fastq
    port, jx = str(tmp_path / "t.zkf"), str(tmp_path / "j.zkf")
    assert tcli.main(["kmerize", "-k", "25", "--host", port, path]) == 0
    line = capsys.readouterr().out
    assert zcli.main(["kmerize", "-k", "25", "--host", jx, path]) == 0
    assert line == capsys.readouterr().out
    assert json.loads(line)["batches"] == 0
    assert json.loads(line)["reads"] == len(reads)
    a, b = container.read(port), container.read(jx)
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(a.counts, b.counts)
    assert a.meta["stats"] == b.meta["stats"]


@pytest.mark.parametrize("flags,codec", [(["--compress"], "zlib"),
                                         (["--codec", "delta", "--compress"],
                                          "delta"), ([], "raw")])
def test_kmerize_compress_flag_matches_jax(fastq, tmp_path, capsys, flags,
                                           codec):
    """--compress is the alias of --codec zlib, and --codec wins over it."""
    path, _ = fastq
    args = ["kmerize", "-k", "25", "--batch-reads", "1024", *flags]
    port, jx = tmp_path / "t.zkf", tmp_path / "j.zkf"
    assert tcli.main([*args, "--device", "cpu", str(port), path]) == 0
    assert zcli.main([*args, str(jx), path]) == 0
    capsys.readouterr()
    assert container.read_header(str(port))["codec"] == codec
    assert container.read_header(str(jx))["codec"] == codec
    a, b = container.read(str(port)), container.read(str(jx))
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(a.counts, b.counts)
    # the same bytes apart from the tool's name in the meta
    assert abs(port.stat().st_size - jx.stat().st_size) <= len("_torch") + 8


def test_device_cuda_without_cuda_exits_1(fastq, tmp_path, capsys,
                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.zkf"
    assert tcli.main(["kmerize", "-k", "25", str(out), fastq[0]]) == 1
    err = capsys.readouterr().err
    assert "--device cuda" in err and "is_available() is false" in err
    assert not out.exists()


def test_port_imports_no_jax():
    """The conftest imports jax in-process, so check in a fresh one."""
    code = ("import sys; import zotpu_torch, zotpu_torch.cli, "
            "zotpu_torch.workloads.kmerize, zotpu_torch.kernels, "
            "zotpu_torch.workloads.pulldown, zotpu_torch.workloads.setops, "
            "zotpu_torch.workloads.spectrum, zotpu_torch.kernels.hist, "
            "zotpu_torch.stats; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_keys_round_trip(rng):
    hi = rng.integers(0, 1 << 30, 50).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 50, dtype=np.uint64).astype(np.uint32)
    cnt = rng.integers(0, 1 << 32, 50, dtype=np.uint64).astype(np.uint32)
    hi[-5:] = lo[-5:] = 0xFFFFFFFF
    keys, counts = K.from_hi_lo(hi, lo, cnt)
    assert torch.all(keys[-5:] == K.SENTINEL)
    assert torch.all(keys[:-5] < (1 << 62))
    h2, l2, c2 = K.to_hi_lo(keys, counts)
    assert np.array_equal(h2, hi) and np.array_equal(l2, lo)
    assert np.array_equal(c2, cnt)
    with pytest.raises(ValueError):
        K.from_hi_lo(np.array([1 << 31], np.uint32), np.array([0], np.uint32))
