"""zotpu_torch membership join (K4) on the CPU, i.e. its plain sort-merge
version, against the JAX package: ``row_hits_sorted_join`` on JAX-CPU (the
XLA path), the Pallas join kernel in interpret mode followed by
``_rowsum_by_idx`` (as tests/test_join.py runs it), and
``golden.scan_panel``. All comparisons are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zotpu import semantics as S
from zotpu.kernels import join as J
from zotpu.reference_impl import golden as G
from zotpu.workloads import pulldown as JPD
from zotpu_torch.kernels import join as TJ
from zotpu_torch.keys import SENTINEL
from zotpu_torch.workloads import pulldown as TPD

torch.set_num_threads(1)

SENT_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _probes_torch(q):
    """u64 probe keys with the all-ones sentinel -> the port's int64 form."""
    return torch.from_numpy(np.where(q == SENT_U64, np.uint64(SENTINEL), q)
                            .astype(np.int64))


def _port(panel_keys, q, n_rows, m):
    panel = TPD.panel_to_device(panel_keys, device="cpu")
    return TJ.row_hits_sorted_join(panel, _probes_torch(q), n_rows,
                                   m).numpy()


def _jax_xla(panel_keys, q, n_rows, m):
    phi, plo = JPD.panel_to_device(panel_keys)
    qhi, qlo = S.split_hi_lo(q)
    return np.asarray(J.row_hits_sorted_join(phi, plo, jnp.asarray(qhi),
                                             jnp.asarray(qlo), n_rows, m))


def _jax_pallas(panel_keys, q, n_rows, m):
    """The TPU path of join.row_hits_sorted_join with the kernel in
    interpret mode and the dense row sum (exact whatever the hit rate)."""
    phi, plo = JPD.panel_to_device(panel_keys)
    qhi, qlo = S.split_hi_lo(q)
    phi_s, plo_s = J._transform_keys(phi, plo, is_probe=False)
    qhi_s, qlo_s = J._transform_keys(jnp.asarray(qhi), jnp.asarray(qlo),
                                     is_probe=True)
    tag = jnp.repeat(jnp.arange(n_rows, dtype=jnp.uint32), m)
    qhi_s, qlo_s, tag = jax.lax.sort((qhi_s, qlo_s, tag), num_keys=2,
                                     is_stable=True)
    bkey, _, _ = J._join_pallas_star(phi_s, plo_s, qhi_s, qlo_s, tag,
                                     n_rows, interpret=True)
    return np.asarray(J._rowsum_by_idx(bkey, n_rows, m))


def _oracle(panel_keys, q, n_rows, m):
    hit = np.isin(q, np.asarray(panel_keys, np.uint64)) & (q != SENT_U64)
    return hit.reshape(n_rows, m).sum(axis=1).astype(np.int32)


def _case(name, rng):
    """(panel keys u64 sorted unique, probes u64 in window order, n_rows,
    m_per_row) for each probe mix."""
    if name == "sentinel40":          # 40% invalid windows, scattered
        n_rows, m = 64, 512
        panel = np.unique(rng.integers(0, 1 << 40, 9000).astype(np.uint64))
        q = rng.integers(0, 1 << 40, n_rows * m).astype(np.uint64)
        q[::5] = panel[rng.integers(0, len(panel), len(q[::5]))]
        q[rng.random(len(q)) < 0.4] = SENT_U64
    elif name == "all_hits":          # every window hits: the TPU truncates
        n_rows, m = 128, 256
        panel = np.unique(rng.integers(0, 1 << 50, 3000).astype(np.uint64))
        q = panel[rng.integers(0, len(panel), n_rows * m)]
    elif name == "dup_one_key":       # one key repeated in every window
        n_rows, m = 24, 40
        panel = np.unique(rng.integers(0, 1 << 30, 500).astype(np.uint64))
        q = np.full(n_rows * m, panel[17], np.uint64)
        q[:5 * m] = np.uint64(1 << 31)            # rows 0-4: a missing key
        q[5 * m::3] = SENT_U64
    elif name == "empty_panel":
        n_rows, m = 16, 30
        panel = np.empty(0, np.uint64)
        q = rng.integers(0, 1 << 20, n_rows * m).astype(np.uint64)
        q[::4] = SENT_U64
    elif name == "k31_extremes":      # raw keys next to the sentinel
        n_rows, m = 33, 20
        top = np.asarray([(1 << 62) - 2, (1 << 62) - 1], np.uint64)
        panel = np.unique(np.concatenate([
            rng.integers(0, 1 << 62, 400, dtype=np.uint64), top]))
        q = rng.integers(0, 1 << 62, n_rows * m, dtype=np.uint64)
        q[::3] = top[rng.integers(0, 2, len(q[::3]))]
        q[1::7] = panel[rng.integers(0, len(panel), len(q[1::7]))]
        q[2::5] = SENT_U64
    elif name == "k31_top_probes_only":   # the top keys miss the panel
        n_rows, m = 10, 16
        panel = np.unique(rng.integers(0, 1 << 62, 100, dtype=np.uint64))
        q = np.full(n_rows * m, (1 << 62) - 1, np.uint64)
        q[::2] = np.uint64((1 << 62) - 2)
        q[::3] = SENT_U64
    else:
        raise AssertionError(name)
    return panel, q, n_rows, m


CASES = ["sentinel40", "all_hits", "dup_one_key", "empty_panel",
         "k31_extremes", "k31_top_probes_only"]


@pytest.mark.parametrize("name", CASES)
def test_join_matches_jax_xla_and_oracle(name):
    rng = np.random.default_rng(CASES.index(name))
    panel, q, n_rows, m = _case(name, rng)
    got = _port(panel, q, n_rows, m)
    assert got.dtype == np.int32 and got.shape == (n_rows,)
    assert np.array_equal(got, _oracle(panel, q, n_rows, m))
    assert np.array_equal(got, _jax_xla(panel, q, n_rows, m))
    if name == "all_hits":
        assert np.array_equal(got, np.full(n_rows, m))


@pytest.mark.parametrize("name", ["sentinel40", "all_hits"])
def test_join_matches_jax_pallas_interpret(name):
    """32,768 probes each: one TILE_E tile of the TPU kernel."""
    rng = np.random.default_rng(CASES.index(name))
    panel, q, n_rows, m = _case(name, rng)
    assert n_rows * m == 1 << 15
    assert np.array_equal(_port(panel, q, n_rows, m),
                          _jax_pallas(panel, q, n_rows, m))


def test_join_probe_order_does_not_matter():
    """Sentinel-heavy probes tied the TPU network (tests/test_join.py:86);
    permuting windows within each row leaves every row's count."""
    rng = np.random.default_rng(5)
    panel, q, n_rows, m = _case("sentinel40", rng)
    perm = np.argsort(rng.random((n_rows, m)), axis=1)
    q2 = np.take_along_axis(q.reshape(n_rows, m), perm, axis=1).reshape(-1)
    assert np.array_equal(_port(panel, q, n_rows, m),
                          _port(panel, q2, n_rows, m))


def test_panel_padding_does_not_matter():
    rng = np.random.default_rng(6)
    panel, q, n_rows, m = _case("k31_extremes", rng)
    probes = _probes_torch(q)
    want = _oracle(panel, q, n_rows, m)
    for cap in (len(panel), len(panel) + 1, 4096):
        p = torch.full((cap,), SENTINEL, dtype=torch.int64)
        p[:len(panel)] = torch.from_numpy(panel.astype(np.int64))
        assert np.array_equal(
            TJ.row_hits_sorted_join(p, probes, n_rows, m).numpy(), want)
    empty = torch.empty(0, dtype=torch.int64)
    assert not TJ.row_hits_sorted_join(empty, probes, n_rows, m).any()


@pytest.mark.parametrize("k,n_reads,read_len", [(21, 37, 120), (11, 8, 50),
                                                (31, 20, 96)])
def test_scan_batch_matches_golden_and_jax(k, n_reads, read_len):
    """Reads (panel substrings, random, N-laden, ragged) through the port's
    pack + join against golden.scan_panel and the JAX scan_batch."""
    rng = np.random.default_rng(k + n_reads)
    src = "".join(rng.choice(list("ACGT"), size=500))
    panel, _ = G.kmerize(k, [src])
    seqs = []
    for i in range(n_reads):
        n = int(rng.integers(k - 3, read_len + 1))
        if i % 3 == 0:
            off = int(rng.integers(0, 500 - n))
            seqs.append(src[off:off + n])
        else:
            seqs.append("".join(rng.choice(list("ACGTN"), size=n)))
    codes = np.full((n_reads, read_len), S.INVALID_CODE, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = G.encode(s)
    lengths = np.asarray([len(s) for s in seqs], np.int32)
    got = TPD.scan_batch(torch.from_numpy(codes), torch.from_numpy(lengths),
                         TPD.panel_to_device(panel, device="cpu"), k).numpy()
    assert np.array_equal(got, G.scan_panel(k, panel, seqs))
    phi, plo = JPD.panel_to_device(panel)
    assert np.array_equal(got, np.asarray(JPD.scan_batch(
        jnp.asarray(codes), jnp.asarray(lengths), phi, plo, k)))


def test_join_errors():
    panel = TPD.panel_to_device(np.arange(5, dtype=np.uint64),
                                device="cpu")
    probes = torch.zeros(12, dtype=torch.int64)
    with pytest.raises(ValueError, match="query length 12 != 5 x 2"):
        TJ.row_hits_sorted_join(panel, probes, 5, 2)
    with pytest.raises(ValueError, match="query length"):
        J.row_hits_sorted_join(np.zeros(8, np.uint32), np.zeros(8, np.uint32),
                               np.zeros(12, np.uint32),
                               np.zeros(12, np.uint32), 5, 2)
    with pytest.raises(ValueError, match="2\\^30"):
        TJ.row_hits_sorted_join(panel, probes[:0], 1 << 30, 0)
    with pytest.raises(ValueError, match="int64"):
        TJ.row_hits_sorted_join(panel.to(torch.int32), probes, 6, 2)
    with pytest.raises(ValueError, match="contiguous"):
        TJ.row_hits_sorted_join(panel, torch.zeros(24, dtype=torch.int64)[::2],
                                6, 2)
