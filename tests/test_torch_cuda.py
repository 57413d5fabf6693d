"""zotpu_torch kernels on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA tensors, and the kmerize and scan CLIs on
cuda against golden. These need a CUDA device and nvcc; elsewhere they skip.
They import nothing of the JAX package, so they run on the card (which has
no JAX, hence no conftest) with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

K2, K6 and K3 with valid counts define their dense outputs up to n only
(the slots past it are left unwritten), so those are compared over [:n]."""

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
