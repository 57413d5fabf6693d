"""zotpu_torch kernels on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA tensors, and the kmerize and scan CLIs on
cuda against golden. These need a CUDA device and nvcc; elsewhere they skip.
Run them on the card (which has no JAX, hence no conftest) with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from zotpu.io import container, wire
from zotpu.reference_impl import golden as G
from zotpu_torch import cli as tcli
from zotpu_torch.keys import SENTINEL
from zotpu_torch.kernels import join as TJ
from zotpu_torch.kernels import merge_fused as TM
from zotpu_torch.kernels import pack as TP
from zotpu_torch.kernels import sortdedup as TD
from zotpu_torch.workloads import pulldown as TPD

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


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
    for g, w in zip(TD.dedup_compact(kd), TD.dedup_compact_plain(kd)):
        assert torch.equal(g, w)


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
    for kw in ({}, dict(n_a=A[2], n_b=B[2])):
        got = TM.set_op_fused(A[0], A[1], B[0], B[1], op, **kw)
        want = TM.set_op_plain(A[0], A[1], B[0], B[1], op, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


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
