"""The port's sharded routing layer (zotpu_torch/dist/mesh.py and
dist/shuffle.py) against the JAX package's on the 8-fake-device CPU mesh:
``_route`` inside ``shard_map`` at D = 4 (received buffers, overflow, the
second round under skew, landed counts), the mixed-hash helpers, the
owner function, ``partition_panel``, ``gather_global``, the receive
trees' plain versions against a sort, and the kmerize step at D = 2
against JAX's Pallas receive tree in interpret mode. Tolerance: exact
equality."""

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tests.test_kernels import make_batch
from tests.test_torch_sharded import _assert_step_equal, _gather, _port_step
from zotpu import semantics as S
from zotpu.dist import mesh as JM
from zotpu.dist import shuffle as JS
from zotpu.reference_impl import golden as G
from zotpu_torch import keys as K
from zotpu_torch.dist import mesh as TM
from zotpu_torch.dist import shuffle as TS
from zotpu_torch.kernels.sortdedup import dedup_compact_plain

torch.set_num_threads(1)

SENT_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _u64(t):
    """Port int64 keys -> JAX-layout u64 (SENTINEL -> all ones)."""
    hi, lo = K.to_hi_lo(t)
    return S.join_hi_lo(hi, lo)


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu", "cpu:0"]])
def test_mesh_all_to_all_and_psum(devices):
    """The tiled all_to_all layout, on one device (stack + transpose) and
    on distinct devices (a copy per sender and receiver)."""
    mesh = TM.make_mesh(devices=devices)
    D, C = mesh.size, 3
    sends = [torch.arange(D * C).reshape(D, C) + 100 * i for i in range(D)]
    recv = mesh.all_to_all(sends)
    for j in range(D):
        want = torch.cat([sends[i][j] for i in range(D)])
        assert torch.equal(recv[j], want)
    total = mesh.psum([torch.full((2,), i + 1) for i in range(D)])
    assert all(torch.equal(t, torch.full((2,), D * (D + 1) // 2))
               for t in total)
    assert mesh.shared == (len(set(devices)) == 1)


def test_make_mesh_errors(monkeypatch):
    assert TM.make_mesh(4, device="cpu").size == 4
    assert TM.shard_bits(8) == JM.shard_bits(8) == 3
    for bad in (3, 6):
        with pytest.raises(ValueError, match="power of two"):
            TM.make_mesh(bad, device="cpu")
        with pytest.raises(ValueError, match="power of two"):
            TM.shard_bits(bad)
    with pytest.raises(ValueError, match="power of two"):
        TM.make_mesh(devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 device"):
        TM.make_mesh(2, device="cuda")


def test_routing_mix32_matches_semantics(rng):
    """The int64 form (multiplies split so no product leaves the signed
    range) against semantics.routing_mix32 on numpy u32 words."""
    edge = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint32)
    hi = np.concatenate([np.repeat(edge, edge.size), rng.integers(
        0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)])
    lo = np.concatenate([np.tile(edge, edge.size), rng.integers(
        0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)])
    got = TS.routing_mix32(torch.from_numpy(hi.astype(np.int64)),
                           torch.from_numpy(lo.astype(np.int64)))
    assert np.array_equal(got.numpy(), S.routing_mix32(hi, lo).astype(
        np.int64))


def test_embed_bits_and_owner_of_match_jax(rng):
    import jax.numpy as jnp
    for k in range(1, 32):
        for p in range(0, 14):
            assert TS._embed_bits(k, p) == JS._embed_bits(k, p), (k, p)
    for k, p in ((1, 1), (16, 3), (25, 2), (31, 3), (12, 0)):
        keys = np.concatenate([rng.integers(0, 1 << (2 * k), 300,
                                            dtype=np.uint64), [SENT_U64]])
        hi, lo = S.split_hi_lo(keys)
        want = JS._owner_of(jnp.asarray(hi), jnp.asarray(lo), k, p, 1 << p)
        got = TS._owner_of(K.from_hi_lo(hi, lo), k, p, 1 << p)
        assert np.array_equal(got.numpy(), np.asarray(want)), (k, p)


@pytest.mark.parametrize("k,D", [(25, 8), (11, 4), (16, 2), (31, 2),
                                 (31, 4)])
def test_mixed_owner_sort_and_strip_match_jax(rng, k, D):
    """Embedded form (the owner at bit 32 + max(2k - 32, 0) of the int64
    key, the JAX hi-word position) and, for k = 31 at D = 4, the
    separate-mix fallback: same order, owners and payloads; stripping
    restores the keys. k = 31 at D = 2 embeds with 30 + 1 = 31 bits and
    stays below SENTINEL for the largest canonical key."""
    import jax.numpy as jnp
    p = TM.shard_bits(D)
    top = (1 << (2 * k)) - 2        # largest key that is not all-T
    keys = np.unique(np.concatenate([
        rng.integers(0, 1 << (2 * k), 600, dtype=np.uint64),
        np.array([0, top], np.uint64)]))
    keys = rng.permutation(np.concatenate([keys, np.full(9, SENT_U64)]))
    tags = np.where(keys == SENT_U64, 0, np.arange(keys.size)).astype(
        np.uint32)
    hi, lo = S.split_hi_lo(keys)
    jh, jl, jown, (jtag,), jemb = JS._mixed_owner_sort(
        jnp.asarray(hi), jnp.asarray(lo), k, p, D,
        payload=(jnp.asarray(tags),))
    ek, own, tag, emb = TS._mixed_owner_sort(
        K.from_hi_lo(hi, lo), k, p, D,
        payload=torch.from_numpy(tags.astype(np.int64)))
    assert emb == jemb == (k != 31 or D == 2)
    assert np.array_equal(_u64(ek), S.join_hi_lo(np.asarray(jh),
                                                 np.asarray(jl)))
    assert torch.all(ek[:-9] < K.SENTINEL)
    assert np.array_equal(own.numpy(), np.asarray(jown))
    assert np.array_equal(tag.numpy(), np.asarray(jtag))
    js = JS._strip_owner(jh, jl, k, p)
    stripped = TS._strip_owner(ek, k, p)
    assert np.array_equal(_u64(stripped), S.join_hi_lo(np.asarray(js),
                                                       np.asarray(jl)))
    assert sorted(_u64(stripped).tolist()) == sorted(keys.tolist())


def _jax_route(keys_u64, k, D, cap, cap2, tags):
    mesh = JM.make_mesh(D)

    def body(h, l, t):
        (rh, rl, rt), ovf, need2, landed = JS._route(
            h, l, k, D, cap, payload=(t,), capacity2=cap2)
        return rh[None], rl[None], rt[None], ovf[None], need2[None], \
            landed[None]

    fn = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P(JM.AXIS),) * 3,
        out_specs=(P(JM.AXIS, None),) * 3 + (P(JM.AXIS),) * 2
        + (P(JM.AXIS, None),), check_vma=False))
    hi, lo = S.split_hi_lo(keys_u64)
    return [np.asarray(x) for x in fn(hi, lo, tags.astype(np.uint32))]


@pytest.mark.parametrize("case", ["balanced", "skew", "overflow"])
def test_route_matches_jax_shard_map(rng, case):
    """_route at D = 4, k = 25 against JAX's inside shard_map: each slot's
    received keys and payloads, overflow, the second-round flag and the
    landed counts. 'skew' sends 70% of each slot's keys to slot 0, so
    the second round runs and overflow stays 0; 'overflow' also exceeds
    capacity + capacity2."""
    k, D, m = 25, 4, 400
    space = 1 << (2 * k)
    cap = {"balanced": 200, "skew": 240, "overflow": 60}[case]
    cap2 = (cap + 3) // 4
    slots = []
    for d in range(D):
        if case == "balanced":
            x = rng.integers(0, space, m, dtype=np.uint64)
        else:
            hot = rng.random(m) < 0.6
            x = np.where(hot, rng.integers(0, space >> 2, m, dtype=np.uint64),
                         rng.integers(0, space, m, dtype=np.uint64))
        x = np.sort(x)
        x[m - int(rng.integers(0, 40)):] = SENT_U64
        slots.append(x)
    tags = [np.where(x == SENT_U64, 0, 1000 * d + np.arange(m))
            for d, x in enumerate(slots)]
    jh, jl, jt, jovf, jneed2, jlanded = _jax_route(
        np.concatenate(slots), k, D, cap, cap2, np.concatenate(tags))
    mesh = TM.make_mesh(D, device="cpu")
    r = TS._route(mesh, [K.from_hi_lo(*S.split_hi_lo(x)) for x in slots],
                  k, cap, payload=[torch.from_numpy(t) for t in tags],
                  capacity2=cap2)
    assert r.need2 == bool(jneed2[0]) == (case != "balanced")
    for d in range(D):
        got = _u64(r.keys[d])
        n = got.size
        assert n == D * (cap + cap2 if r.need2 else cap)
        want = S.join_hi_lo(jh[d], jl[d])
        assert np.array_equal(got, want[:n])
        assert np.all(want[n:] == SENT_U64)
        assert np.array_equal(r.pay[d].numpy(), jt[d][:n].astype(np.int64))
        assert int(r.overflow[d]) == int(jovf[d])
        assert np.array_equal(r.landed[d].numpy(), jlanded[d])
    assert (sum(int(o) for o in r.overflow) > 0) == (case == "overflow")


@pytest.mark.parametrize("D,cap,cap2", [(1, 64, 0), (1, 64, 16),
                                        (2, 50, 13), (4, 33, 0),
                                        (4, 20, 5)])
@pytest.mark.parametrize("dedup", [False, True])
def test_merge_received_runs_plain_matches_sort(rng, D, cap, cap2, dedup):
    """The port's receive trees on ascending runs of any capacity (no tile
    rounding) == a sort of the whole buffer (then K2's plain dedup); the
    payload tree keeps every (key, tag) pair."""
    runs = []
    for c in [cap] * D + [cap2] * D:
        r = np.sort(rng.integers(0, 40, c))
        r[int(rng.integers(0, c + 1)):] = K.SENTINEL
        runs.append(r)
    buf = torch.from_numpy(np.concatenate(runs))
    want = torch.sort(buf).values
    got = TS.merge_received_runs(buf, D, cap, cap2, dedup=dedup)
    if dedup:
        for g, w in zip(got, dedup_compact_plain(want)):
            assert torch.equal(g, w)
    else:
        assert torch.equal(got, want)
    tags = torch.arange(buf.shape[0])
    qk, qt = TS.merge_received_runs_tag(buf, tags, D, cap, cap2)
    assert torch.equal(qk, want) and torch.equal(buf[qt], qk)
    assert torch.equal(torch.sort(qt).values, tags)


def test_kmerize_step_matches_jax_interpret():
    """D = 2: JAX's step takes the Pallas receive tree with its fused dense
    dedup (interpret mode); the port's takes K5 and K6's plain versions."""
    k, D, R, L = 17, 2, 8, 70
    rng = np.random.default_rng(29)
    seqs, codes, lengths = make_batch(rng, D * R, L, min_len=L)
    jstep, _ = JS.make_kmerize_step(JM.make_mesh(D), k, R, L,
                                    capacity_factor=6.0, interpret=True)
    out, _ = _port_step(D, k, R, L, codes, lengths, capacity_factor=6.0)
    _assert_step_equal(out, jstep(codes, lengths), D)
    keys, cnts = _gather(out, False)
    want_k, want_c = G.kmerize(k, seqs)
    assert np.array_equal(keys, want_k) and np.array_equal(cnts, want_c)


@pytest.mark.parametrize("shard_hash", ["prefix", "mixed"])
def test_partition_panel_and_gather_global_match_jax(rng, shard_hash):
    k, D = 21, 4
    panel = np.unique(rng.integers(0, 1 << (2 * k), 3000, dtype=np.uint64))
    phi, plo, jcap = JS.partition_panel(panel, k, D, shard_hash=shard_hash)
    rows, cap = TS.partition_panel(panel, k, D, shard_hash=shard_hash)
    assert cap == jcap
    for d in range(D):
        assert np.array_equal(_u64(torch.from_numpy(rows[d])),
                              S.join_hi_lo(phi[d], plo[d]))
        valid = rows[d][rows[d] != K.SENTINEL]
        assert np.all(np.diff(valid) > 0)
    with pytest.raises(ValueError, match="exceeds capacity"):
        TS.partition_panel(panel, k, D, panel_cap=8, shard_hash=shard_hash)
    # gather the rows back: per-slot dense prefixes with counts
    n = (rows != K.SENTINEL).sum(axis=1)
    counts = rng.integers(1, 1 << 32, rows.shape, dtype=np.uint64).astype(
        np.int64)
    reorder = shard_hash == "mixed"
    gk, gc = TS.gather_global(list(rows), list(counts), list(n),
                              reorder=reorder)
    wk, wc = JS.gather_global(phi, plo, counts.astype(np.uint32), n,
                              reorder=reorder)
    assert np.array_equal(gk, wk) and np.array_equal(gc, wc)
    assert np.array_equal(gk, panel)
