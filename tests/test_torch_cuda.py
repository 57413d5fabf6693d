"""zotpu_torch kernels on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA tensors, and the kmerize, scan, merge,
set-op, jaccard, spill/resume and spectrum paths on cuda against their CPU
(plain-version) results and golden, and the multi-controller runs (gloo on
one card, NCCL on distinct cards). These need a CUDA device and nvcc;
elsewhere they skip.
They import nothing of the JAX package, so they run on the card (which has
no JAX, hence no conftest) with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

K2, K6 and K3 with valid counts define their dense outputs up to n only
(the slots past it are left unwritten), so those are compared over [:n]."""

import json

import numpy as np
import pytest
import torch

from zotpu_torch import cli as tcli
from zotpu_torch.io import container, wire
from zotpu_torch.kernels import edge_cases as EC
from zotpu_torch.reference_impl import golden as G
from zotpu_torch.keys import SENTINEL
from zotpu_torch.kernels import join as TJ
from zotpu_torch.kernels import merge_fused as TM
from zotpu_torch.kernels import pack as TP
from zotpu_torch.kernels import sortdedup as TD
from zotpu_torch.workloads import pulldown as TPD

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _assert_dense_equal(got, want):
    """(keys, counts, n) of a kernel and of its plain version: n and the
    dense prefix [:n]."""
    n = int(want[2])
    assert int(got[2]) == n
    assert torch.equal(got[0][:n], want[0][:n])
    assert torch.equal(got[1][:n], want[1][:n])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("R,L,k", [(7, 32, 1), (65, 160, 25), (300, 96, 31)])
def test_pack_kernels_match_plain(dev, R, L, k):
    rng = np.random.default_rng(R + L + k)
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    codes[rng.random((R, L)) < 0.01] = 4
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    packed, mask = wire.pack_codes(codes)
    c, n = torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev)
    p, m = torch.from_numpy(packed).to(dev), torch.from_numpy(mask).to(dev)
    before = TP.pack_canonical_wire.launches
    want = TP.pack_canonical_plain(c, n, k)
    assert torch.equal(TP.pack_canonical(c, n, k), want)
    assert torch.equal(TP.pack_canonical_wire(p, m, n, k), want)
    assert TP.pack_canonical_wire.launches == before + 1


@pytest.mark.parametrize("n,space,frac", [
    (1, 5, 1.0), (5, 3, 0.0), (3000, 50, 0.7), (70000, 1 << 40, 1.0)])
def test_dedup_kernel_matches_plain(dev, n, space, frac):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, space, n))
    keys[int(n * frac):] = SENTINEL
    kd = torch.from_numpy(keys).to(dev)
    _assert_dense_equal(TD.dedup_compact(kd), TD.dedup_compact_plain(kd))


@pytest.mark.parametrize("n,space", [(4096, 1 << 40), (4097, 10),
                                     (70000, 3), (12288, 1)])
def test_dedup_kernel_tile_boundaries(dev, n, space):
    """K2 at its tile size (4096): a full tile, one key past it, segments
    that span many tiles (3 keys over 70000; one key over three tiles), with
    and without a sentinel tail that starts at a tile boundary."""
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, space, n))
    for tail in (0, 4096, 5):
        k = np.concatenate([keys, np.full(tail, SENTINEL, np.int64)])
        kd = torch.from_numpy(k).to(dev)
        _assert_dense_equal(TD.dedup_compact(kd), TD.dedup_compact_plain(kd))


@pytest.mark.parametrize("op", ["merge", "union", "intersect", "diff"])
@pytest.mark.parametrize("na,cap_a,nb,cap_b", [(0, 1, 0, 1), (5, 8, 0, 4),
                                               (500, 1024, 300, 512),
                                               (40000, 65536, 50000, 65536)])
def test_set_op_kernel_matches_plain(dev, op, na, cap_a, nb, cap_b):
    rng = np.random.default_rng(na + nb)

    def side(n, cap):
        k = np.unique(rng.integers(0, 1 << 17, n))[:cap]
        K = np.full(cap, SENTINEL, np.int64)
        C = np.zeros(cap, np.int64)
        K[:len(k)] = k
        C[:len(k)] = rng.integers(1, 1 << 32, len(k))
        return (torch.from_numpy(K).to(dev), torch.from_numpy(C).to(dev),
                torch.tensor(len(k), device=dev))

    A, B = side(na, cap_a), side(nb, cap_b)
    # without the valid counts every slot is defined (a sentinel tail)
    got = TM.set_op_fused(A[0], A[1], B[0], B[1], op)
    for g, w in zip(got, TM.set_op_plain(A[0], A[1], B[0], B[1], op)):
        assert torch.equal(g, w)
    kw = dict(n_a=A[2], n_b=B[2])
    _assert_dense_equal(TM.set_op_fused(A[0], A[1], B[0], B[1], op, **kw),
                        TM.set_op_plain(A[0], A[1], B[0], B[1], op, **kw))


_SET_OP_EDGE = EC.set_op_cases(seed=0)
_PACK_EDGE = EC.pack_cases(seed=0)


@pytest.mark.parametrize("op", ["merge", "intersect", "diff"])
@pytest.mark.parametrize("case", range(len(_SET_OP_EDGE)),
                         ids=[c[0] for c in _SET_OP_EDGE])
def test_set_op_kernel_edge_cases(dev, case, op):
    """K3 on the shapes of kernels/edge_cases.py at its own tile size."""
    _, a, b = _SET_OP_EDGE[case]
    ka, ca = (torch.from_numpy(x).to(dev) for x in a[:2])
    kb, cb = (torch.from_numpy(x).to(dev) for x in b[:2])
    na, nb = (torch.tensor(x[2], device=dev) for x in (a, b))
    before = TM.set_op_fused.launches
    got = TM.set_op_fused(ka, ca, kb, cb, op)
    assert TM.set_op_fused.launches == before + (len(a[0]) + len(b[0]) > 0)
    for g, w in zip(got, TM.set_op_plain(ka, ca, kb, cb, op)):
        assert torch.equal(g, w)
    _assert_dense_equal(TM.set_op_fused(ka, ca, kb, cb, op, n_a=na, n_b=nb),
                        TM.set_op_plain(ka, ca, kb, cb, op, n_a=na, n_b=nb))
    # one count given, one absent: still a full sentinel tail
    for kw in (dict(n_a=na), dict(n_b=nb)):
        for g, w in zip(TM.set_op_fused(ka, ca, kb, cb, op, **kw),
                        TM.set_op_plain(ka, ca, kb, cb, op, **kw)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("case", range(len(_PACK_EDGE)),
                         ids=[c[0] for c in _PACK_EDGE])
def test_pack_kernel_edge_cases(dev, case):
    """K1a and K1b on the shapes of kernels/edge_cases.py."""
    _, codes, lengths, k = _PACK_EDGE[case]
    packed, mask = wire.pack_codes(codes)
    c, n = torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev)
    want = TP.pack_canonical_plain(c, n, k)
    assert torch.equal(TP.pack_canonical(c, n, k), want)
    assert torch.equal(TP.pack_canonical_wire(
        torch.from_numpy(packed).to(dev), torch.from_numpy(mask).to(dev), n,
        k), want)


@pytest.mark.parametrize("R,L,k", [(1000, 150, 25), (40, 150, 31),
                                   (3, 4096, 25), (5000, 32, 4)])
def test_pack_u8_kernel_ragged_rows(dev, R, L, k):
    """K1b where 32 does not divide L, where one row is several batches of
    window groups, and where many short rows share a block."""
    rng = np.random.default_rng(R + L)
    codes = rng.integers(0, 5, size=(R, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    c, n = torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev)
    assert torch.equal(TP.pack_canonical(c, n, k),
                       TP.pack_canonical_plain(c, n, k))


@pytest.mark.parametrize("max_len", [160, 150])
def test_kmerize_cli_cuda_matches_golden(dev, tmp_path, max_len):
    rng = np.random.default_rng(max_len)
    genome = rng.choice(list("ACGTN"), p=[0.2495] * 4 + [0.002], size=30000)
    reads = ["".join(genome[o:o + 150]) for o in rng.integers(0, 29850, 2000)]
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    out = tmp_path / "o.zkf"
    assert tcli.main(["kmerize", "-k", "25", "--batch-reads", "256",
                      "--max-len", str(max_len), str(out), str(fq)]) == 0
    ks = container.read(str(out))
    want_k, want_c = G.kmerize(25, reads)
    assert np.array_equal(ks.keys, want_k)
    assert np.array_equal(ks.counts, want_c)


@pytest.mark.parametrize("n_panel", [0, 8, 70000])
@pytest.mark.parametrize("R,L,k", [(7, 32, 1), (65, 160, 25), (300, 96, 31)])
def test_join_kernel_matches_plain(dev, R, L, k, n_panel):
    """K4 against the sort-merge plain version on the pack kernel's output;
    the panel holds about half the batch's own windows, the rest random."""
    rng = np.random.default_rng(R + L + k + n_panel)
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    codes[rng.random((R, L)) < 0.05] = 4
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    probes = TP.pack_canonical(torch.from_numpy(codes).to(dev),
                               torch.from_numpy(lengths).to(dev), k)
    valid = probes[probes != SENTINEL].cpu().numpy().astype(np.uint64)
    pool = np.concatenate([
        rng.choice(valid, min(n_panel // 2, len(valid))),
        rng.integers(0, 1 << (2 * k), n_panel, dtype=np.uint64)])
    panel_keys = np.unique(pool)[:n_panel]
    m = L - k + 1
    for panel in (TPD.panel_to_device(panel_keys, device=dev),
                  torch.from_numpy(panel_keys.astype(np.int64)).to(dev)):
        before = TJ.row_hits_sorted_join.launches
        got = TJ.row_hits_sorted_join(panel, probes, R, m)
        assert TJ.row_hits_sorted_join.launches == before + 1
        assert torch.equal(got, TJ.row_hits_plain(panel, probes, R, m))


@pytest.mark.parametrize("max_len", [160, 150])
def test_scan_cli_cuda_matches_golden(dev, tmp_path, capsys, max_len):
    rng = np.random.default_rng(max_len + 1)
    genome = rng.choice(list("ACGTN"), p=[0.2495] * 4 + [0.002], size=30000)
    panel_k, _ = G.kmerize(25, ["".join(genome[:8000])])
    panel = tmp_path / "p.zkf"
    container.write(str(panel), container.KmerSet(k=25, keys=panel_k))
    samples, want = [], []
    for s in range(3):
        reads = ["".join(genome[o:o + 150])
                 for o in rng.integers(0, 29850, 700)]
        reads.append("".join(genome[500:900]))      # halo-chunked record
        fq = tmp_path / f"s{s}.fastq"
        fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                              for i, r in enumerate(reads)))
        samples.append(str(fq))
        want.append(G.scan_panel(25, panel_k, reads))
    capsys.readouterr()
    assert tcli.main(["scan", "--batch-reads", "256", "--max-len",
                      str(max_len), "--per-read", str(panel),
                      *samples]) == 0
    lines = capsys.readouterr().out.splitlines()
    for path, w in zip(samples, want):
        rows = [int(x.split("\t")[2]) for x in lines
                if x.startswith(path + "\t")]
        assert rows == [int(h) for h in w]
        assert w.sum() > 0


def _runs(rng, n_runs, run, space, frac_valid):
    """n_runs ascending int64 runs of ``run`` keys from [0, space), each
    with a SENTINEL tail past a random share of about frac_valid."""
    out = []
    for _ in range(n_runs):
        r = np.sort(rng.integers(0, space, run))
        r[int(rng.integers(0, run + 1) * frac_valid):] = SENTINEL
        out.append(r)
    return np.concatenate(out) if out else np.zeros(0, np.int64)


@pytest.mark.parametrize("pay", [False, True])
@pytest.mark.parametrize("n_runs,run,space,frac", [
    (2, 1, 5, 1.0), (8, 3, 4, 0.8), (4, 1000, 7, 1.0),
    (4, 3000, 1 << 40, 0.9), (2, 5000, 1 << 40, 0.0)])
def test_merge_runs_kernel_matches_plain(dev, pay, n_runs, run, space, frac):
    """K5 (keys only) and K7 (int64 payload): every pass of a tree and one
    unequal pair, against the stable-sort plain version. Equal-key
    segments longer than a block (a key space of 4-7 over 4000 keys) and
    all-sentinel runs included; A stays first on ties, so the payloads
    match exactly."""
    from zotpu_torch.kernels import merge_runs as MR
    rng = np.random.default_rng(n_runs * run + pay)
    keys = torch.from_numpy(_runs(rng, n_runs, run, space, frac)).to(dev)
    tags = (torch.from_numpy(rng.integers(0, 1 << 40, keys.shape[0])).to(dev)
            if pay else None)
    counter = MR.WITH_PAYLOAD if pay else MR.KEYS_ONLY
    r = run
    while r < keys.shape[0]:
        before = counter.launches
        got = MR.merge_runs_pass(keys, tags, r)
        want = MR.merge_plain(keys, tags, 2 * r, r)
        assert counter.launches == before + 1
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (not pay)
        if pay:
            assert torch.equal(got[1], want[1])
        keys, tags = got
        r *= 2
    tail = torch.from_numpy(_runs(rng, 1, run + 7, space, frac)).to(dev)
    ttag = None if tags is None else torch.arange(tail.shape[0], device=dev)
    pairs = [(keys, tags, tail, ttag), (tail, ttag, tail[:0], None),
             (tail[:0], None, tail, ttag)]
    for ka, ta, kb, tb in pairs:
        both = torch.cat([ka, kb])
        tboth = None if tags is None else torch.cat(
            [ta if ta is not None else tb[:0], tb if tb is not None
             else ta[:0]])
        got = MR.merge_runs_pair(both, tboth, ka.shape[0])
        want = MR.merge_plain(both, tboth, max(both.shape[0], 1),
                              ka.shape[0])
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("nA,nB,space,frac", [
    (1, 0, 3, 1.0), (4096, 0, 5, 1.0), (3000, 5000, 3, 1.0),
    (70000, 70000, 1 << 20, 0.7), (2048, 2048, 1 << 40, 0.0),
    (0, 5000, 9, 0.5)])
def test_merge_dedup_kernel_matches_plain(dev, nA, nB, space, frac):
    """K6 against merge + K2's plain version: raw keys with duplicates on
    both sides, segments spanning many blocks (3 keys over 8000), nB = 0
    (a single-run dedup), empty A, all-sentinel runs."""
    from zotpu_torch.kernels import merge_dedup as MD
    rng = np.random.default_rng(nA + nB)
    keys = np.concatenate([_runs(rng, 1, nA, space, frac) if nA else
                           np.zeros(0, np.int64),
                           _runs(rng, 1, nB, space, frac) if nB else
                           np.zeros(0, np.int64)])
    kd = torch.from_numpy(keys).to(dev)
    before = MD.merge_dedup_pair.launches
    got = MD.merge_dedup_pair(kd, nA)
    assert MD.merge_dedup_pair.launches == before + 1
    _assert_dense_equal(got, MD.merge_dedup_plain(kd, nA))
    if nA == nB:
        _assert_dense_equal(MD.merge_dedup_pass(kd, nA), got)


MERGE_CASES = EC.merge_runs_cases()
DEDUP_CASES = EC.merge_dedup_cases()


@pytest.mark.parametrize("pay", [False, True], ids=["K5", "K7"])
@pytest.mark.parametrize("name", [c[0] for c in MERGE_CASES])
def test_merge_runs_kernel_edge_cases(dev, name, pay):
    """K5 / K7 on the receive tree's edge shapes at the kernel's tile
    (edge_cases.merge_runs_cases) against the plain version, exact: keys
    and, A first on ties, the payload of every row, sentinel rows too."""
    from zotpu_torch.kernels import merge_runs as MR
    _, keys, tags, kind, arg = next(c for c in MERGE_CASES if c[0] == name)
    k = torch.from_numpy(keys).to(dev)
    t = torch.from_numpy(tags).to(dev) if pay else None
    fn = MR.merge_runs_pass if kind == "pass" else MR.merge_runs_pair
    pair_len, a_len = ((2 * arg, arg) if kind == "pass"
                       else (max(len(keys), 1), arg))
    got, want = fn(k, t, arg), MR.merge_plain(k, t, pair_len, a_len)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (not pay)
    if pay:
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", [c[0] for c in DEDUP_CASES])
def test_merge_dedup_kernel_edge_cases(dev, name):
    """K6 on the receive tree's edge shapes (one key over many tiles, ties
    across every boundary, an empty or all-sentinel side, n_out 0) against
    the plain version: n_out and the dense prefix, exact."""
    from zotpu_torch.kernels import merge_dedup as MD
    _, keys, n_a = next(c for c in DEDUP_CASES if c[0] == name)
    k = torch.from_numpy(keys).to(dev)
    _assert_dense_equal(MD.merge_dedup_pair(k, n_a),
                        MD.merge_dedup_plain(k, n_a))


@pytest.mark.parametrize("n,n_rows,n_panel", [(1, 1, 8), (5000, 37, 0),
                                              (200000, 4096, 70000)])
def test_row_hits_tagged_kernel_matches_plain(dev, n, n_rows, n_panel):
    """K4's tagged entry against the sort-merge plain version: any row
    population, sentinel probes with tag 0, tags past n_rows ignored."""
    rng = np.random.default_rng(n + n_rows)
    pool = rng.integers(0, 1 << 20, n)
    panel_keys = np.unique(np.concatenate(
        [rng.choice(pool, n_panel // 2), rng.integers(0, 1 << 20, n_panel)]
    ))[:n_panel] if n_panel else np.zeros(0, np.int64)
    probes = pool.copy()
    tags = rng.integers(0, n_rows + 2, n)
    sent = rng.random(n) < 0.2
    probes[sent], tags[sent] = SENTINEL, 0
    order = np.argsort(probes, kind="stable")
    panel = TPD.panel_to_device(panel_keys.astype(np.uint64), device=dev)
    p = torch.from_numpy(probes[order]).to(dev)
    t = torch.from_numpy(tags[order]).to(dev)
    before = TJ.row_hits_tagged.launches
    got = TJ.row_hits_tagged(panel, p, t, n_rows)
    assert TJ.row_hits_tagged.launches == before + 1
    assert torch.equal(got, TJ.row_hits_tagged_plain(panel, p, t, n_rows))


@pytest.mark.parametrize("shard_hash", ["prefix", "mixed"])
def test_sharded_kmerize_and_scan_on_card_slots(dev, tmp_path, shard_hash):
    """Sharded kmerize and scan with 4 slots on one card against golden;
    the receive tree ran K5 and K6, the accumulator K3, the scan K7 and
    K4's tagged entry. A capacity factor below 1 takes the overflow
    round and stays exact."""
    from zotpu_torch import kernels
    from zotpu_torch.workloads import kmerize as TW
    rng = np.random.default_rng(7)
    genome = rng.choice(list("ACGT"), size=30000)
    reads = ["".join(genome[o:o + 150]) for o in rng.integers(0, 29850, 3000)]
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    want_k, want_c = G.kmerize(25, reads)
    slots = [dev] * 4
    # prefix owners of canonical keys are skewed toward slot 0, so the
    # overflow round needs less slack there than under the mixed hash
    for cf, second in ((4.0, False),
                       (1.5 if shard_hash == "prefix" else 0.9, True)):
        kernels.reset_launches()
        stats = TW.Stats()
        keys, counts = TW.kmerize_paths_sharded(
            [str(fq)], 25, 4, batch_reads=1024, max_len=160, stats=stats,
            capacity_factor=cf, shard_hash=shard_hash, devices=slots)
        run = kernels.launches()
        assert np.array_equal(keys, want_k) and np.array_equal(counts,
                                                               want_c)
        assert run["merge_runs"] > 0 and run["merge_dedup"] > 0
        assert run["set_op_fused"] > 0
        assert (stats.second_rounds > 0) == second
    panel_k, _ = G.kmerize(25, ["".join(genome[:8000])])
    kernels.reset_launches()
    res = TPD.pulldown_paths_sharded(panel_k, [str(fq)], 25, 4,
                                     batch_reads=1024, max_len=160,
                                     shard_hash=shard_hash, devices=slots)
    run = kernels.launches()
    assert res[0][2] == [int(h) for h in G.scan_panel(25, panel_k, reads)]
    assert run["merge_runs_payload"] > 0 and run["join_row_hits_tagged"] > 0


def test_sharded_cli_on_distinct_cards(dev, tmp_path, capsys):
    """kmerize and scan --shards 4 on cuda:0..3 (four cards: the mesh
    copies buckets between cards and every kernel launches on its slot's
    card) against the single-card run; skips with fewer than 4 cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    rng = np.random.default_rng(4)
    genome = rng.choice(list("ACGT"), size=30000)
    reads = ["".join(genome[o:o + 150]) for o in rng.integers(0, 29850, 3000)]
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    panel_k, _ = G.kmerize(25, ["".join(genome[:8000])])
    pz = tmp_path / "p.zkf"
    container.write(str(pz), container.KmerSet(k=25, keys=panel_k))
    flags = ["--batch-reads", "1024", "--max-len", "160"]
    outs = {}
    for shards in ("1", "4"):
        for mode in ("prefix", "mixed"):
            out = tmp_path / f"k{shards}{mode}.zkf"
            assert tcli.main(["kmerize", "-k", "25", *flags, "--shards",
                              shards, "--shard-hash", mode, str(out),
                              str(fq)]) == 0
            ks = container.read(str(out))
            outs[shards, mode] = (ks.keys, ks.counts)
            capsys.readouterr()
            assert tcli.main(["scan", *flags, "--shards", shards,
                              "--shard-hash", mode, "--per-read", str(pz),
                              str(fq)]) == 0
            outs[shards, mode, "scan"] = capsys.readouterr().out
    want_k, want_c = G.kmerize(25, reads)
    for key, got in outs.items():
        if len(key) == 2:
            assert np.array_equal(got[0], want_k), key
            assert np.array_equal(got[1], want_c), key
        else:
            assert got == outs["1", "prefix", "scan"], key


# ----- multi-controller runs (torch.distributed)


def _multiproc():
    """tests/test_torch_multiproc_mesh.py (``spawn``, ``free_port`` and the
    CLI worker), loaded from its path: the card's run has no conftest, and
    a ``tests`` package installed there would shadow this directory's."""
    import importlib.util
    import os
    name = "test_torch_multiproc_mesh"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _multi_fixture(tmp_path, n_files=3):
    rng = np.random.default_rng(12)
    genome = rng.choice(list("ACGT"), size=30000)
    paths, reads = [], []
    for j in range(n_files):
        rs = ["".join(genome[o:o + 150])
              for o in rng.integers(0, 29850, max(1500 - 400 * j, 300))]
        path = tmp_path / f"r{j}.fastq"
        path.write_text("".join(f"@r{j}_{i}\n{r}\n+\n{'I' * len(r)}\n"
                                for i, r in enumerate(rs)))
        paths.append(str(path))
        reads += rs
    panel_k, _ = G.kmerize(25, ["".join(genome[:8000])])
    pz = tmp_path / "p.zkf"
    container.write(str(pz), container.KmerSet(k=25, keys=panel_k))
    return paths, reads, str(pz)


def test_multi_controller_gloo_on_one_card(dev, tmp_path, capsys):
    """Two processes with 2 slots each on this card (gloo: NCCL refuses
    two ranks on one card): kmerize (prefix, mixed) and scan --per-read
    equal the single-process port over 4 slots on the card and golden, and
    every process launched K1a, K5, K6, K3 (kmerize) and K7, K4 tagged
    (scan)."""
    run_cli_commands = _multiproc().run_cli_commands
    paths, reads, pz = _multi_fixture(tmp_path)
    flags = ["--batch-reads", 1024, "--max-len", 160, "--shards", 4]
    cmds = [["kmerize", "-k", 25, *flags, "--shard-hash", mode,
             tmp_path / f"m_{mode}.zkf", *paths]
            for mode in ("prefix", "mixed")]
    cmds.append(["scan", *flags, "--per-read", pz, *paths])
    res = run_cli_commands(tmp_path, cmds, device="cuda", backend="gloo",
                           info=True)
    want_k, want_c = G.kmerize(25, reads)
    for j, mode in enumerate(("prefix", "mixed")):
        ks = container.read(str(tmp_path / f"m_{mode}.zkf"))
        assert np.array_equal(ks.keys, want_k)
        assert np.array_equal(ks.counts, want_c)
        for rc, _, info in res[j]:
            assert rc == 0 and info["sent_bytes"] > 0
            for name in ("pack_canonical_wire", "merge_runs", "merge_dedup",
                         "set_op_fused"):
                assert info["launches"][name] > 0, (mode, name)
    capsys.readouterr()
    assert tcli.main([str(a) for a in ["scan", *flags[:4], "--per-read", pz,
                                       *paths]]) == 0
    single = capsys.readouterr().out.splitlines()
    (rc0, out0, info0), (rc1, out1, info1) = res[2]
    assert rc0 == rc1 == 0
    rows = out0.splitlines() + out1.splitlines()
    assert sorted(rows) == sorted(single)
    assert [x for x in out0.splitlines() if x.startswith("{")] == [
        x for x in single if x.startswith("{")]
    for info in (info0, info1):
        assert info["launches"]["merge_runs_payload"] > 0
        assert info["launches"]["join_row_hits_tagged"] > 0


def test_multi_controller_nccl_on_distinct_cards(dev, tmp_path, capsys):
    """The CLI itself, one process per card on NCCL (P = 2 or 4 cards):
    kmerize and scan equal the single-card run. Skips with fewer than 2
    cards."""
    mp = _multiproc()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 CUDA devices")
    P = 4 if n >= 4 else 2
    paths, reads, pz = _multi_fixture(tmp_path, n_files=P + 1)
    flags = ["--batch-reads", 1024, "--max-len", 160]
    outs = {}
    for cmd in (["kmerize", "-k", 25, *flags, tmp_path / "n.zkf", *paths],
                ["scan", *flags, "--per-read", pz, *paths]):
        port = mp.free_port()
        res = mp.spawn([["-m", "zotpu_torch", *cmd, "--coordinator",
                      f"127.0.0.1:{port}", "--num-processes", P,
                      "--process-id", pid] for pid in range(P)])
        for rc, out in res:
            assert rc == 0, out
        outs[cmd[0]] = [out for _, out in res]
    ks = container.read(str(tmp_path / "n.zkf"))
    want_k, want_c = G.kmerize(25, reads)
    assert np.array_equal(ks.keys, want_k) and np.array_equal(ks.counts,
                                                              want_c)
    capsys.readouterr()
    assert tcli.main([str(a) for a in ["scan", *flags, "--per-read", pz,
                                       *paths]]) == 0
    single = capsys.readouterr().out.splitlines()
    rows = [x for out in outs["scan"] for x in out.splitlines()
            if x.startswith("{") or x.startswith(str(tmp_path))]
    assert sorted(rows) == sorted(single)


# ----- the entry points (zotpu_torch/entry.py)


# the kernels one dry run launches: K1a (wire step), K1b (mixed step and
# pulldown), K5 and K6 (receive tree), K3 (level merge, set ops), K7 and
# K4 tagged (pulldown)
DRYRUN_KERNELS = ("pack_canonical_wire", "pack_canonical", "merge_runs",
                  "merge_dedup", "set_op_fused", "merge_runs_payload",
                  "join_row_hits_tagged")


def _dryrun_equal(got, want):
    for key in ("keys", "counts", "row_hits"):
        assert np.array_equal(got[key], want[key]), key
    for key in ("union", "cards", "overflow", "slot_bytes"):
        assert got[key] == want[key], key


def test_entry_step_on_card(dev):
    """``entry()``'s step on the card (K1b, torch.sort, K2) against the
    same step on the CPU (the plain versions)."""
    from zotpu_torch import entry as E
    from zotpu_torch import kernels
    step, args = E.entry()
    assert all(a.is_cuda for a in args)
    kernels.reset_launches()
    got = step(*args)
    run = kernels.launches()
    want = step(*(a.cpu() for a in args))
    _assert_dense_equal(tuple(t.cpu() for t in got), want)
    assert run["pack_canonical"] == 1 and run["dedup_compact"] == 1


def test_entry_dryrun_on_card_slots(dev):
    """``dryrun_multichip`` over 4 slots on this card: equal to golden and
    to the same call on 4 CPU slots, through every kernel of the path."""
    from zotpu_torch import entry as E
    from zotpu_torch import kernels
    kernels.reset_launches()
    got = E.dryrun_multichip(4, devices=[dev] * 4)
    run = kernels.launches()
    assert all(run[name] > 0 for name in DRYRUN_KERNELS), run
    want = E.dryrun_multichip(4, devices=["cpu"] * 4)
    _dryrun_equal(got, want)
    codes, _ = E.dry_inputs(4)
    gk, gc = G.kmerize(E.DRY_K, list(codes))
    assert np.array_equal(got["keys"], gk)
    assert np.array_equal(got["counts"], gc * 2)


def test_entry_dryrun_on_distinct_cards(dev):
    """``dryrun_multichip(4)`` over cuda:0..3 (the all-to-all copies rows
    between cards) equals the run over 4 slots of one card; skips with
    fewer than 4 cards."""
    from zotpu_torch import entry as E
    from zotpu_torch import kernels
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    kernels.reset_launches()
    got = E.dryrun_multichip(4)
    run = kernels.launches()
    assert got["devices"] == [f"cuda:{i}" for i in range(4)]
    assert all(run[name] > 0 for name in DRYRUN_KERNELS), run
    _dryrun_equal(got, E.dryrun_multichip(4, devices=["cuda:0"] * 4))


# ----- set algebra, merge, jaccard, spill/resume and spectrum on the card


def _random_set(rng, n, k=25):
    keys = np.unique(rng.integers(0, 1 << (2 * k), n, dtype=np.uint64))
    return keys, rng.integers(1, 300, len(keys)).astype(np.uint32)


def _overlapping_sets(seed, na, nb):
    rng = np.random.default_rng(seed)
    a, b = _random_set(rng, na), _random_set(rng, nb)
    keys = np.unique(np.concatenate([b[0], a[0][::3]]))
    return a, (keys, rng.integers(1, 300, len(keys)).astype(np.uint32))


_GOLD = {"merge": lambda a, b: G.merge([a, b]), "union": G.union,
         "intersect": G.intersect, "diff": G.difference}


@pytest.mark.parametrize("op", ["merge", "union", "intersect", "diff"])
@pytest.mark.parametrize("na,nb", [(0, 0), (1, 0), (5000, 7), (200000,
                                                                150000)])
def test_set_op_workload_on_card_matches_plain_and_golden(dev, op, na, nb):
    """workloads/setops.set_op on the card (one K3 launch) against the same
    function on the CPU (K3's plain version) and golden."""
    from zotpu_torch.workloads import setops as WS
    a, b = _overlapping_sets(na + nb, na, nb)
    before = TM.set_op_fused.launches
    got = WS.set_op(a, b, op, device=dev)
    assert TM.set_op_fused.launches == before + (na + nb > 0)
    for want in (WS.set_op(a, b, op, device="cpu"), _GOLD[op](a, b)):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("n_runs", [2, 5, 8])
def test_merge_tree_and_jaccard_on_card(dev, n_runs):
    from zotpu_torch.workloads import setops as WS
    rng = np.random.default_rng(n_runs)
    base = _random_set(rng, 300000)[0]
    runs = []
    for _ in range(n_runs):
        keys = np.sort(rng.choice(base, 60000, replace=False))
        runs.append((keys, rng.integers(1, 1 << 32, len(keys),
                                        dtype=np.uint64).astype(np.uint32)))
    before = TM.set_op_fused.launches
    got = WS.merge_tree_device(runs, device=dev)
    assert TM.set_op_fused.launches == before + n_runs - 1
    want = G.merge(runs)                    # some counts saturate
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert int(got[1].max()) == 0xFFFFFFFF
    before = TM.set_op_fused.launches
    cards = WS.jaccard(runs[0][0], runs[1][0], device=dev)
    assert TM.set_op_fused.launches == before + 1
    assert cards == WS.jaccard(runs[0][0], runs[1][0], device="cpu")
    assert cards["intersect"] == len(np.intersect1d(runs[0][0], runs[1][0]))


@pytest.mark.parametrize("op", ["union", "intersect", "diff"])
@pytest.mark.parametrize("skew", [False, True])
def test_sharded_set_ops_on_card_slots(dev, tmp_path, op, skew):
    """set_op_sharded, jaccard_sharded and set_op_sharded_stream with 4
    slots on one card against the single-device result; with skew every
    key sits in the first slot and three slots get empty slices."""
    from zotpu_torch.workloads import setops as WS
    a, b = _overlapping_sets(int(skew), 120000, 90000)
    if skew:
        a, b = ((s[0] >> np.uint64(3), s[1]) for s in (a, b))
    slots = [dev] * 4
    want = WS.set_op(a, b, op, device=dev)
    before = TM.set_op_fused.launches
    keys, counts, cards = WS.set_op_sharded(a, b, op, 25, 4, devices=slots)
    assert TM.set_op_fused.launches == before + (1 if skew else 4)
    assert np.array_equal(keys, want[0]) and np.array_equal(counts, want[1])
    assert cards == WS.set_op_sharded(a, b, op, 25, 4, device="cpu")[2]
    cache = {}
    for _ in range(2):
        assert WS.jaccard_sharded(a[0], b[0], 25, 4, cache=cache,
                                  devices=slots) == WS.jaccard(
            a[0], b[0], device="cpu")
    assert len(cache) == 2
    pa, pb = str(tmp_path / "a.zkf"), str(tmp_path / "b.zkf")
    container.write(pa, container.KmerSet(k=25, keys=a[0], counts=a[1]))
    container.write(pb, container.KmerSet(k=25, keys=b[0], counts=b[1]))
    k, keys, counts, scards = WS.set_op_sharded_stream(
        pa, pb, op, 4, chunk=10007, devices=slots)
    assert k == 25 and scards == cards
    assert np.array_equal(keys, want[0]) and np.array_equal(counts, want[1])


def test_set_algebra_cli_on_card(dev, tmp_path, capsys, monkeypatch):
    """merge (through the accumulator, several chunks and levels), the set
    ops (one device, --shards 4 is covered above through devices=), and
    jaccard through the CLI on cuda against golden."""
    from zotpu_torch import kernels
    monkeypatch.setenv("ZOTPU_MERGE_CHUNK", "20000")
    rng = np.random.default_rng(11)
    sets = [_random_set(rng, 90000) for _ in range(2)]
    sets.append((sets[0][0][::2].copy(), sets[1][1][:len(sets[0][0][::2])]))
    paths = []
    for i, (keys, counts) in enumerate(sets):
        paths.append(str(tmp_path / f"s{i}.zkf"))
        container.write(paths[-1], container.KmerSet(k=25, keys=keys,
                                                     counts=counts))
    kernels.reset_launches()
    out = str(tmp_path / "m.zkf")
    assert tcli.main(["merge", out, *paths]) == 0
    assert kernels.launches()["set_op_fused"] >= 10
    got, want = container.read(out), G.merge(sets)
    assert np.array_equal(got.keys, want[0])
    assert np.array_equal(got.counts, want[1])
    for op, gold in (("union", G.union), ("intersect", G.intersect),
                     ("diff", G.difference)):
        out = str(tmp_path / f"{op}.zkf")
        assert tcli.main([op, out, paths[0], paths[2]]) == 0
        got, want = container.read(out), gold(sets[0], sets[2])
        assert np.array_equal(got.keys, want[0])
        assert np.array_equal(got.counts, want[1])
    capsys.readouterr()
    assert tcli.main(["jaccard", paths[0], paths[2]]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["intersect"] == len(sets[2][0]) and line["union"] == len(
        sets[0][0])


@pytest.mark.parametrize("shards", [1, 4])
def test_spill_and_resume_on_card(dev, tmp_path, monkeypatch, shards):
    """kmerize --spill-dir on the card, crashed and resumed, against the
    accumulator run and golden; with the threshold lowered the final merge
    is the K3 merge tree."""
    from zotpu_torch.workloads import kmerize as TW
    rng = np.random.default_rng(21)
    genome = rng.choice(list("ACGT"), size=30000)
    reads = ["".join(genome[o:o + 150]) for o in rng.integers(0, 29850, 3000)]
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    monkeypatch.setattr(TW, "DEVICE_MERGE_THRESHOLD", 1000)
    common = dict(batch_reads=512, max_len=160)

    def run(**kw):
        if shards > 1:
            return TW.kmerize_paths_sharded([str(fq)], 25, shards,
                                            devices=[dev] * shards,
                                            **common, **kw)
        return TW.kmerize_paths([str(fq)], 25, device=dev, **common, **kw)

    want = G.kmerize(25, reads)
    spill = tmp_path / "spill"
    spill.mkdir()
    with pytest.raises(TW.Interrupted):
        run(spill_dir=str(spill), fail_after_batches=2)
    assert len(list(spill.glob("*.zkf"))) == 2
    before = TM.set_op_fused.launches
    got = run(spill_dir=str(spill), resume=True)
    assert TM.set_op_fused.launches == before + len(
        list(spill.glob("*.zkf"))) - 1
    for out in (got, run()):
        assert np.array_equal(out[0], want[0])
        assert np.array_equal(out[1], want[1])


@pytest.mark.parametrize("max_count", [1, 1024, 70000])
def test_spectrum_on_card_matches_cpu_and_golden(dev, max_count):
    from zotpu_torch.kernels import hist as TH
    from zotpu_torch.workloads import spectrum as WSp
    rng = np.random.default_rng(max_count)
    counts = rng.poisson(25, 500000).astype(np.uint32)
    counts[::9] = rng.integers(0, 200000, len(counts[::9]))
    c = torch.from_numpy(counts.astype(np.int64))
    got = TH.spectrum(c.to(dev), max_count=max_count)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), TH.spectrum(c, max_count=max_count))
    gold = G.spectrum(counts, max_count=max_count)
    gold[0] = 0
    assert np.array_equal(got.cpu().numpy(), gold)
    fit = WSp.spectrum_with_cutoff(counts, device=dev)
    cpu = WSp.spectrum_with_cutoff(counts, device="cpu")
    assert np.array_equal(fit.pop("hist"), cpu.pop("hist")) and fit == cpu


def test_selftest_on_card_slots(dev):
    """The self-test over 4 slots on one card: every check, the D >= 2
    ones and both forced second rounds included, byte-equal to golden,
    through the CUDA kernels."""
    from zotpu_torch import kernels
    from zotpu_torch.selftest import run_selftest
    lines = []
    kernels.reset_launches()
    assert run_selftest(k=15, verbose_print=lines.append,
                        devices=[dev] * 4) == 0
    run = kernels.launches()
    summary = json.loads(lines[-1])
    assert summary["ok"] is True and summary["failed"] == 0
    assert summary["checks"] == 13 and "partial" not in summary
    assert summary["device"] == str(dev)
    assert all(n > 0 for name, n in run.items() if name != "pack_canonical")


def test_bench_workloads_on_card_match_cpu(dev, capsys):
    """Each of the 12 bench workloads at a tiny size on the card: every
    record names the card, every workload but the host-only parse
    launches kernels, the counts that do not depend on time equal the
    same call on the CPU, and the scan and its shard model count the same
    hits."""
    from types import SimpleNamespace

    from zotpu_torch.bench import harness

    def records(device, workload):
        assert harness.run(SimpleNamespace(
            workload=workload, device=device, bases=1 << 16, k=15,
            repeats=1, setops_n=1 << 12, scan_reads=1 << 8,
            scan_panel=1 << 10)) == 0
        return [json.loads(line)
                for line in capsys.readouterr().out.splitlines()]

    card = torch.cuda.get_device_name(dev)
    hits = {}
    for workload in harness.WORKLOADS:
        on_card, on_cpu = records(dev, workload), records("cpu", workload)
        assert on_card and all(r["device"] == card for r in on_card)
        assert all(bool(r["launches"]) == (workload != "parse")
                   for r in on_card), (workload, on_card[0]["launches"])
        cpu_rows = {r.get("devices"): r for r in on_cpu}
        for r in on_card:
            want = cpu_rows.get(r.get("devices"))
            if want is None:        # scaling rows beyond the CPU's one slot
                continue
            for key in harness.COUNT_KEYS:
                assert r.get(key) == want.get(key), (workload, key)
        if workload in ("scan", "scan-shard-model"):
            hits[workload] = on_card[0]["total_hits"]
    assert hits["scan"] == hits["scan-shard-model"] > 0
