"""The port's sharded kmerize and scan (zotpu_torch/dist/shuffle.py steps,
workloads/accumulator.ShardedAccumulator, workloads/kmerize and pulldown
``*_sharded``, the CLI's --shards) against the JAX package on the
8-fake-device CPU mesh and against golden: the pulldown step at D = 2
against JAX's Pallas tree in interpret mode (the kmerize step's
interpret-mode case is in test_torch_shuffle.py), the steps at D = 4 and
8 against JAX's XLA path.
Tolerance: exact equality of every slot's dense prefix [:n], of n, and of
the per-row hits."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_kernels import make_batch
from zotpu import cli as zcli
from zotpu import semantics as S
from zotpu.dist import mesh as JM
from zotpu.dist import shuffle as JS
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu.workloads import kmerize as JW
from zotpu.workloads import pulldown as JP
from zotpu.workloads.accumulator import ShardedAccumulator as JAcc
from zotpu_torch import cli as tcli
from zotpu_torch import keys as K
from zotpu_torch.dist import mesh as TM
from zotpu_torch.dist import shuffle as TS
from zotpu_torch.workloads import kmerize as TW
from zotpu_torch.workloads import pulldown as TP
from zotpu_torch.workloads.accumulator import CapacityError, ShardedAccumulator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slots(D, R, codes, lengths):
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    return [(c[d * R:(d + 1) * R], n[d * R:(d + 1) * R]) for d in range(D)]


def _port_step(D, k, R, L, codes, lengths, **kw):
    step, cap_out = TS.make_kmerize_step(TM.make_mesh(D, device="cpu"), k,
                                         R, L, **kw)
    out = step(_slots(D, R, codes, lengths))
    assert all(o[0].shape[0] <= cap_out for o in out)
    return out, step


def _assert_step_equal(out, jax_out, D):
    uhi, ulo, counts, n_unique, overflow, routed = (np.asarray(x)
                                                   for x in jax_out)
    uhi, ulo, counts = (x.reshape(D, -1) for x in (uhi, ulo, counts))
    for d, (keys, cnt, n, ovf, rt) in enumerate(out):
        nd = int(n_unique[d])
        assert int(n) == nd
        want = S.join_hi_lo(uhi[d, :nd], ulo[d, :nd])
        assert np.array_equal(keys[:nd].numpy().astype(np.uint64), want)
        assert np.array_equal(cnt[:nd].numpy(), counts[d, :nd])
        assert torch.all(keys[nd:] == K.SENTINEL) and torch.all(cnt[nd:] == 0)
        assert int(ovf) == int(overflow[d]) and int(rt) == int(routed[d])


def _gather(out, reorder):
    return TS.gather_global([o[0].numpy() for o in out],
                            [o[1].numpy() for o in out],
                            [int(o[2]) for o in out], reorder=reorder)


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("shard_hash", ["prefix", "mixed"])
def test_kmerize_step_matches_jax_and_golden(D, shard_hash):
    k, R, L = 15, 8, 60
    rng = np.random.default_rng(D)
    seqs, codes, lengths = make_batch(rng, D * R, L, alphabet="ACGTN")
    jstep, _ = JS.make_kmerize_step(JM.make_mesh(D), k, R, L,
                                    capacity_factor=8.0,
                                    shard_hash=shard_hash)
    out, _ = _port_step(D, k, R, L, codes, lengths, capacity_factor=8.0,
                        shard_hash=shard_hash)
    _assert_step_equal(out, jstep(codes, lengths), D)
    keys, cnts = _gather(out, shard_hash == "mixed")
    want_k, want_c = G.kmerize(k, seqs)
    assert np.array_equal(keys, want_k) and np.array_equal(cnts, want_c)


@pytest.mark.parametrize("D", [2, 4])
def test_kmerize_step_k31_mixed_embeds_or_falls_back(D):
    """k = 31: the owner embeds at D = 2 (30 + 1 bits) and takes the
    separate-mix fallback at D = 4 (torch.sort + K2 on the receive side)."""
    k, R, L = 31, 8, 64
    rng = np.random.default_rng(31 + D)
    seqs, codes, lengths = make_batch(rng, D * R, L, min_len=40)
    assert (TS._embed_bits(k, TM.shard_bits(D)) is None) == (D == 4)
    jstep, _ = JS.make_kmerize_step(JM.make_mesh(D), k, R, L,
                                    capacity_factor=8.0, shard_hash="mixed")
    out, _ = _port_step(D, k, R, L, codes, lengths, capacity_factor=8.0,
                        shard_hash="mixed")
    _assert_step_equal(out, jstep(codes, lengths), D)
    keys, cnts = _gather(out, True)
    want_k, want_c = G.kmerize(k, seqs)
    assert np.array_equal(keys, want_k) and np.array_equal(cnts, want_c)


@pytest.mark.parametrize("D,shard_hash", [(1, "prefix"), (2, "mixed"),
                                          (4, "mixed")])
def test_kmerize_step_second_round(D, shard_hash):
    """A capacity factor of 0.9 with full-length reads overflows the first
    round (at D = 1 only with force_second_round; the mixed hash keeps
    D > 1 balanced enough to fit the second round): the second-round
    subtree runs and the result stays equal to JAX's and golden; without
    the second round keys are lost and counted as overflow."""
    k, R, L = 21, 16, 80
    rng = np.random.default_rng(100 + D)
    seqs, codes, lengths = make_batch(rng, D * R, L, alphabet="ACGT",
                                      min_len=L)
    out, step = _port_step(D, k, R, L, codes, lengths, capacity_factor=0.9,
                           force_second_round=True, shard_hash=shard_hash)
    assert step.second_rounds == 1
    assert all(int(o[3]) == 0 for o in out)
    jstep, _ = JS.make_kmerize_step(JM.make_mesh(D), k, R, L,
                                    capacity_factor=0.9,
                                    force_second_round=True,
                                    shard_hash=shard_hash)
    _assert_step_equal(out, jstep(codes, lengths), D)
    keys, cnts = _gather(out, shard_hash == "mixed")
    want_k, want_c = G.kmerize(k, seqs)
    assert np.array_equal(keys, want_k) and np.array_equal(cnts, want_c)
    lost, off = _port_step(D, k, R, L, codes, lengths, capacity_factor=0.9,
                           second_round=False, shard_hash=shard_hash)
    assert sum(int(o[3]) for o in lost) > 0 and off.second_rounds == 0


def _scan_case(rng, k, D, R, L):
    src = "".join(rng.choice(list("ACGT"), size=400))
    panel_keys, _ = G.kmerize(k, [src])
    seqs = []
    for i in range(D * R):
        if i % 3 == 0:
            off = int(rng.integers(0, 400 - L))
            seqs.append(src[off:off + L])
        else:
            seqs.append("".join(rng.choice(list("ACGTN"), size=L)))
    codes = np.stack([G.encode(s) for s in seqs])
    return panel_keys, seqs, codes, np.full(D * R, L, np.int32)


@pytest.mark.parametrize("D,shard_hash,interpret,k", [
    (2, "prefix", True, 21), (4, "prefix", False, 21),
    (8, "mixed", False, 21), (4, "mixed", False, 31)])
def test_pulldown_step_matches_jax_and_golden(D, shard_hash, interpret, k):
    """Per-row hits of the port's step (K7 tree, K4 tagged, psum) against
    JAX's (its Pallas payload tree and stream join in interpret mode at
    D = 2, its XLA join otherwise) and golden. k = 31 at D = 4 cannot embed
    the mixed owner: the received probes go to K4 tagged unmerged."""
    R, L = 8, 90
    rng = np.random.default_rng(11 + D)
    panel_keys, seqs, codes, lengths = _scan_case(rng, k, D, R, L)
    phi, plo, cap = JS.partition_panel(panel_keys, k, D,
                                       shard_hash=shard_hash)
    jstep = JS.make_pulldown_step(JM.make_mesh(D), k, R, L, cap,
                                  capacity_factor=8.0,
                                  shard_hash=shard_hash, interpret=interpret)
    jhits, jovf = (np.asarray(x) for x in jstep(codes, lengths, phi, plo))
    rows, _ = TS.partition_panel(panel_keys, k, D, shard_hash=shard_hash)
    step = TS.make_pulldown_step(TM.make_mesh(D, device="cpu"), k, R, L,
                                 capacity_factor=8.0, shard_hash=shard_hash)
    hits, ovf = step(_slots(D, R, codes, lengths),
                     [torch.from_numpy(r) for r in rows])
    want = G.scan_panel(k, panel_keys, seqs)
    for d in range(D):
        assert np.array_equal(hits[d].numpy(), jhits.reshape(D, -1)[d])
        assert int(ovf[d]) == int(jovf[d]) == 0
    assert np.array_equal(hits[0].numpy(), want) and want.sum() > 0


def test_sharded_accumulator_matches_jax():
    """Per-slot LSM of dense runs (K3 plain) against the JAX
    ShardedAccumulator fed the same runs; a per-slot capacity below the
    final unique count raises CapacityError at result()."""
    rng = np.random.default_rng(5)
    D, cap = 4, 64
    runs = []
    for _ in range(5):
        slot = []
        for d in range(D):
            keys = np.unique(rng.integers(d * 1000, d * 1000 + 300, 40))
            k = np.full(cap, K.SENTINEL, np.int64)
            c = np.zeros(cap, np.int64)
            k[:keys.size] = keys
            c[:keys.size] = rng.integers(1, 1 << 31, keys.size)
            slot.append((k, c, keys.size))
        runs.append(slot)
    acc = ShardedAccumulator(["cpu"] * D, cap, max_cap=4096)
    jacc = JAcc(D, cap, max_cap=4096)
    for slot in runs:
        acc.add([(torch.from_numpy(k), torch.from_numpy(c),
                  torch.tensor(n)) for k, c, n in slot])
        hl = [K.to_hi_lo(torch.from_numpy(k)) for k, _, _ in slot]
        jacc.add(np.stack([h for h, _ in hl]), np.stack([l for _, l in hl]),
                 np.stack([c.astype(np.uint32) for _, c, _ in slot]),
                 np.array([n for _, _, n in slot], np.int32), dense=True)
    got = TS.gather_global(*acc.result())
    want = JS.gather_global(*jacc.result())
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    small = ShardedAccumulator(["cpu"] * D, cap, max_cap=D * 100)
    for slot in runs:
        small.add([(torch.from_numpy(k), torch.from_numpy(c),
                    torch.tensor(n)) for k, c, n in slot])
    with pytest.raises(CapacityError, match=r"shard \d"):
        small.result()


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    rng = np.random.default_rng(2024)
    genome = rng.choice(list("ACGT"), size=20000)
    seqs = []
    for _ in range(1500):
        n = int(rng.integers(30, 151))
        off = int(rng.integers(0, len(genome) - n))
        r = genome[off:off + n].copy()
        r[rng.random(n) < 0.01] = "N"
        seqs.append("".join(r))
    seqs.append("".join(genome[100:700]))         # halo-chunked record
    path = str(tmp_path_factory.mktemp("sharded") / "r.fastq")
    with open(path, "w") as f:
        f.write("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                        for i, s in enumerate(seqs)))
    panel, _ = G.kmerize(25, ["".join(genome[:3000])])
    return path, seqs, panel


@pytest.mark.parametrize("shard_hash", ["prefix", "mixed"])
def test_kmerize_paths_sharded_matches_jax(reads, shard_hash):
    path, seqs, _ = reads
    stats, jstats = TW.Stats(), JW.Stats()
    keys, counts = TW.kmerize_paths_sharded(
        [path], 25, 4, batch_reads=256, max_len=128, stats=stats,
        shard_hash=shard_hash, device="cpu")
    jk, jc = JW.kmerize_paths_sharded([path], 25, 4, batch_reads=256,
                                      max_len=128, stats=jstats,
                                      shard_hash=shard_hash)
    want_k, want_c = G.kmerize(25, seqs)
    assert np.array_equal(keys, want_k) and np.array_equal(counts, want_c)
    assert np.array_equal(keys, jk) and np.array_equal(counts, jc)
    for f in ("reads", "bases", "kmers", "batches", "unique", "n_chips",
              "routed_per_shard"):
        assert getattr(stats, f) == getattr(jstats, f), f
    assert stats.second_rounds == 0


def test_kmerize_paths_sharded_errors(reads, monkeypatch):
    path = reads[0]
    with pytest.raises(ValueError, match="all-to-all bucket overflow"):
        TW.kmerize_paths_sharded([path], 25, 4, batch_reads=256,
                                 max_len=128, capacity_factor=0.05,
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TW.kmerize_paths_sharded([path], 25, 2, spill_dir="x", device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"--shards 2 exceeds the 1 "):
        TW.kmerize_paths_sharded([path], 25, 2)
    with pytest.raises(ValueError, match=r"--shards 4 exceeds the 1 "):
        TP.pulldown_paths_sharded(reads[2], [path], 25, 4)


@pytest.mark.parametrize("shard_hash", ["prefix", "mixed"])
def test_pulldown_paths_sharded_matches_jax(reads, shard_hash):
    path, seqs, panel = reads
    got = TP.pulldown_paths_sharded(panel, [path, path], 25, 4,
                                    batch_reads=256, max_len=128,
                                    shard_hash=shard_hash, device="cpu")
    want = JP.pulldown_paths_sharded(panel, [path], 25, 4, batch_reads=256,
                                     max_len=128, shard_hash=shard_hash)
    assert got == want * 2
    assert got[0][2] == [int(h) for h in G.scan_panel(25, panel, seqs)]


def test_sharded_paths_on_distinct_device_slots(reads):
    """Slots on distinct devices ("cpu" and "cpu:0" differ as devices):
    the mesh exchanges buckets by copies per sender and receiver instead
    of a stack and transpose, and psum moves tensors between slots."""
    path, seqs, panel = reads
    slots = ["cpu", "cpu:0"] * 2
    assert not TM.make_mesh(devices=slots).shared
    for shard_hash in ("prefix", "mixed"):
        keys, counts = TW.kmerize_paths_sharded(
            [path], 25, 4, batch_reads=256, max_len=128,
            shard_hash=shard_hash, devices=slots)
        want_k, want_c = G.kmerize(25, seqs)
        assert np.array_equal(keys, want_k) and np.array_equal(counts,
                                                               want_c)
    got = TP.pulldown_paths_sharded(panel, [path], 25, 4, batch_reads=256,
                                    max_len=128, devices=slots)
    assert got[0][2] == [int(h) for h in G.scan_panel(25, panel, seqs)]


def _out(capsys):
    return capsys.readouterr().out


@pytest.mark.parametrize("shard_hash", ["prefix", "mixed"])
def test_cli_kmerize_shards_verify_equal(reads, tmp_path, capsys,
                                         shard_hash):
    """python -m zotpu_torch kmerize --device cpu --shards 4 against
    python -m zotpu kmerize --shards 4 and the single-device port."""
    path = reads[0]
    args = ["-k", "25", "--batch-reads", "256", "--max-len", "128"]
    t4, j4, t1 = (str(tmp_path / f) for f in ("t4.zkf", "j4.zkf", "t1.zkf"))
    assert tcli.main(["kmerize", *args, "--device", "cpu", "--shards", "4",
                      "--shard-hash", shard_hash, t4, path]) == 0
    stats = json.loads(_out(capsys).splitlines()[-1])
    assert zcli.main(["kmerize", *args, "--shards", "4", "--shard-hash",
                      shard_hash, j4, path]) == 0
    jstats = json.loads(_out(capsys).splitlines()[-1])
    assert tcli.main(["kmerize", *args, "--device", "cpu", t1, path]) == 0
    _out(capsys)
    assert stats["routed_per_shard"] == jstats["routed_per_shard"]
    assert stats["n_chips"] == 4 and stats["unique"] == jstats["unique"]
    for other in (j4, t1):
        assert zcli.main(["verify", t4, other]) == 0
        assert json.loads(_out(capsys))["equal"] is True
    assert container.read(t4).meta["tool"] == "zotpu_torch kmerize"


def test_cli_scan_shards_byte_equal(reads, tmp_path, capsys):
    path, _, panel = reads
    pz = str(tmp_path / "panel.zkf")
    container.write(pz, container.KmerSet(k=25, keys=panel))
    for mode in ("prefix", "mixed"):
        flags = ["--batch-reads", "256", "--max-len", "128", "--shards", "4",
                 "--shard-hash", mode, "--per-read"]
        assert tcli.main(["scan", *flags, "--device", "cpu", pz, path]) == 0
        got = _out(capsys)
        assert zcli.main(["scan", *flags, pz, path]) == 0
        assert got == _out(capsys)
        assert got.count("\n") > 1000


def test_cli_shards_errors(reads, tmp_path, capsys, monkeypatch):
    path = reads[0]
    out = str(tmp_path / "o.zkf")
    assert tcli.main(["kmerize", "-k", "25", "--device", "cpu", "--shards",
                      "3", out, path]) == 1
    assert "power of two" in capsys.readouterr().err
    for flags in (["--spill-dir", str(tmp_path)],
                  ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
                   "--process-id", "0"]):
        assert tcli.main(["kmerize", "-k", "25", "--device", "cpu",
                          "--shards", "2", *flags, out, path]) == 1
        assert "not yet ported" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tcli.main(["kmerize", "-k", "25", "--shards", "2", out,
                      path]) == 1
    assert ("--shards 2 exceeds the 1 available device(s)"
            in capsys.readouterr().err)
    assert not os.path.exists(out)


def test_port_imports_no_jax_anywhere():
    """No source of the port (nor chip_smoke.py) names jax in an import,
    and every module, the sharded ones included, imports in a fresh
    process without pulling jax in."""
    pat = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    srcs = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "zotpu_torch")):
        srcs += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(srcs) > 15
    for src in srcs:
        with open(src) as f:
            assert not pat.search(f.read()), src
    code = ("import sys; import zotpu_torch.cli, zotpu_torch.dist.mesh, "
            "zotpu_torch.dist.shuffle, zotpu_torch.workloads.kmerize, "
            "zotpu_torch.workloads.pulldown, zotpu_torch.kernels; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
