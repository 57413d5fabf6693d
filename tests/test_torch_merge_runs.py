"""The receive-tree kernels' plain versions (zotpu_torch/kernels/
merge_runs.py: K5 and K7; merge_dedup.py: K6) and K4's tagged entry
(kernels/join.py row_hits_tagged) against the JAX package's Pallas kernels
in interpret mode at TILE_E, against its XLA join formulation, and against
numpy. The JAX side gets its alternating-direction layout (odd runs stored
descending), the port the ascending layout, both built from the same runs.
Tolerance: exact equality of the dense prefix [:n] and of n."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zotpu import semantics as S
from zotpu.kernels.sort_pallas import TILE_E
from zotpu_torch import keys as K
from zotpu_torch.kernels import edge_cases as EC
from zotpu_torch.kernels import join as TJ
from zotpu_torch.kernels import merge_dedup as MD
from zotpu_torch.kernels import merge_runs as MR

torch.set_num_threads(1)

SENT_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _run(rng, n_valid, cap, space):
    """An ascending u64 run of cap keys from [0, space), n_valid of them
    valid and the rest the JAX sentinel."""
    key = np.sort(rng.integers(0, space, cap, dtype=np.uint64))
    key[n_valid:] = SENT_U64
    return key


def _jax_alt(runs):
    """(hi, lo) jnp arrays of the runs, odd runs reversed (descending)."""
    alt = np.concatenate([r if i % 2 == 0 else r[::-1]
                          for i, r in enumerate(runs)])
    hi, lo = S.split_hi_lo(alt)
    return jnp.asarray(hi), jnp.asarray(lo)


def _port(runs):
    return K.from_hi_lo(*S.split_hi_lo(np.concatenate(runs)))


def _from_jax(hi, lo, cnt=None):
    return K.from_hi_lo(np.asarray(hi), np.asarray(lo),
                        None if cnt is None else np.asarray(cnt))


def test_merge_received_runs_tree_matches_jax_interpret(rng):
    """K5: the JAX receive tree at D = 2, cap = cap2 = TILE_E
    (tree_merge_pass_alt for each round's level, then tree_merge_pair_alt)
    against the port's tree of plain K5 passes and pair."""
    from zotpu.dist.shuffle import merge_received_runs as jax_tree
    from zotpu_torch.dist.shuffle import merge_received_runs

    D, cap, cap2 = 2, TILE_E, TILE_E
    first = [_run(rng, int(rng.integers(0, cap + 1)), cap, 1 << 50)
             for _ in range(D)]
    second = [_run(rng, int(rng.integers(0, cap2 // 4)), cap2, 1 << 50)
              for _ in range(D)]
    ahi, alo = _jax_alt(first)
    bhi, blo = _jax_alt(second)
    gh, gl = jax_tree(jnp.concatenate([ahi, bhi]), jnp.concatenate([alo, blo]),
                      D, cap, cap2, interpret=True)
    got = merge_received_runs(_port(first + second), D, cap, cap2)
    assert torch.equal(got, _from_jax(gh, gl))
    assert torch.equal(got, torch.sort(_port(first + second)).values)


def _dedup_case(rng, cap):
    # a small key space: many duplicates, segments longer than any block
    return [_run(rng, int(rng.integers(cap // 2, cap + 1)), cap, 512)
            for _ in range(2)]


def _assert_dense_equal(got, want_k, want_c, want_n):
    n = int(want_n)
    assert int(got[2]) == n
    assert torch.equal(got[0][:n], want_k[:n])
    assert torch.equal(got[1][:n], want_c[:n])
    assert torch.all(got[0][n:] == K.SENTINEL) and torch.all(got[1][n:] == 0)


def test_merge_dedup_pass_matches_jax_interpret(rng):
    """K6 pass: one pair of equal runs of TILE_E, A ascending and B stored
    descending on the JAX side, merged with the dense dedup fused."""
    from zotpu.kernels.dedup_pallas import merged_dedup_compact_pass
    runs = _dedup_case(rng, TILE_E)
    hi, lo = _jax_alt(runs)
    jh, jl, jc, jn = merged_dedup_compact_pass(hi, lo, TILE_E, interpret=True)
    jk, jcnt = _from_jax(jh, jl, jc)
    _assert_dense_equal(MD.merge_dedup_pass(_port(runs), TILE_E), jk, jcnt,
                        np.asarray(jn))


def test_merge_dedup_pair_empty_b_matches_jax_interpret(rng):
    """K6 pair with nB = 0: a single-run dedup (the D = 1 receive path)."""
    from zotpu.kernels.dedup_pallas import merged_dedup_compact_pair
    run = _dedup_case(rng, TILE_E)[:1]
    hi, lo = _jax_alt(run)
    jh, jl, jc, jn = merged_dedup_compact_pair(hi, lo, nA=TILE_E,
                                               interpret=True)
    jk, jcnt = _from_jax(jh, jl, jc)
    got = MD.merge_dedup_pair(_port(run), TILE_E)
    assert got[0].shape[0] == TILE_E          # capacity = input length
    _assert_dense_equal(got, jk, jcnt, np.asarray(jn))


def test_merge_received_runs_tag_matches_jax_interpret(rng):
    """K7: the JAX payload tree at D = 2, cap = cap2 = TILE_E
    (stream_merge_pass_pallas per round, then stream_merge_pair_pallas) with
    a row-id payload against the port's plain K7 passes and pair. Keys are
    equal everywhere; (key, tag) of the valid rows is equal as a multiset
    (the JAX network may reorder tags within an equal-key segment)."""
    from zotpu.dist.shuffle import merge_received_runs_tag as jax_tree
    from zotpu_torch.dist.shuffle import merge_received_runs_tag

    D, cap, cap2 = 2, TILE_E, TILE_E
    # a 2**14 key space, so equal keys with different tags meet across runs
    runs = [_run(rng, int(rng.integers(0, c + 1)), c, 1 << 14)
            for c in (cap, cap, cap2, cap2)]
    tags = [np.where(r == SENT_U64, 0, rng.integers(0, 1 << 20, r.size))
            .astype(np.uint32) for r in runs]
    hi, lo = S.split_hi_lo(np.concatenate(runs))
    gh, gl, gt = jax_tree(jnp.asarray(hi), jnp.asarray(lo),
                          jnp.asarray(np.concatenate(tags)), D, cap, cap2,
                          interpret=True)
    keys, tag = merge_received_runs_tag(
        _port(runs), torch.from_numpy(np.concatenate(tags).astype(np.int64)),
        D, cap, cap2)
    jk = _from_jax(gh, gl)
    assert torch.equal(keys, jk)
    valid = int((keys != K.SENTINEL).sum())
    got = np.stack([keys[:valid].numpy(), tag[:valid].numpy()])
    want = np.stack([jk[:valid].numpy(),
                     np.asarray(gt)[:valid].astype(np.int64)])
    assert np.array_equal(got[:, np.lexsort(got[::-1])],
                          want[:, np.lexsort(want[::-1])])


@pytest.mark.parametrize("n_runs,run,space", [(2, 1, 3), (4, 5, 4),
                                              (8, 64, 1 << 40), (2, 300, 7)])
def test_merge_runs_plain_contract(rng, n_runs, run, space):
    """Pass and pair: sorted output, the payload riding with its key, and
    A first on equal keys."""
    runs = [np.sort(rng.integers(0, space, run)) for _ in range(n_runs)]
    keys = torch.from_numpy(np.concatenate(runs))
    tags = torch.arange(keys.shape[0])
    out, t = MR.merge_runs_pass(keys, tags, run)
    assert out.shape == keys.shape and t.shape == tags.shape
    assert torch.equal(out, keys[t])
    for p in range(n_runs // 2):
        seg = slice(2 * p * run, 2 * (p + 1) * run)
        assert torch.equal(out[seg], torch.sort(keys[seg]).values)
        # B's tags exceed A's: within an equal-key segment the tags rise
        # iff A comes first and each side keeps its input order
        ts, same = t[seg], out[seg][1:] == out[seg][:-1]
        assert torch.all((ts[1:] > ts[:-1]) | ~same)
    keys_only, none = MR.merge_runs_pass(keys, None, run)
    assert none is None and torch.equal(keys_only, out)
    pair = keys[:2 * run]            # A = [:run] and B, each sorted
    for a in (0, run, 2 * run):
        src = pair if a == run else torch.sort(pair).values
        got, _ = MR.merge_runs_pair(src, None, a)
        assert torch.equal(got, torch.sort(src).values)


def test_merge_runs_checks_arguments():
    keys = torch.arange(12)
    with pytest.raises(ValueError, match="multiple of 2"):
        MR.merge_runs_pass(keys, None, 5)
    with pytest.raises(ValueError, match="outside"):
        MR.merge_runs_pair(keys, None, 13)
    with pytest.raises(ValueError, match="int64"):
        MR.merge_runs_pass(keys.to(torch.int32), None, 3)
    with pytest.raises(ValueError, match="payload"):
        MR.merge_runs_pass(keys, torch.arange(11), 3)
    with pytest.raises(ValueError, match="one pair"):
        MD.merge_dedup_pass(keys, 3)
    empty = torch.zeros(0, dtype=torch.int64)
    assert MR.merge_runs_pair(empty, empty, 0)[0].shape == (0,)
    got = MD.merge_dedup_pair(empty, 0)
    assert got[0].shape == (0,) and int(got[2]) == 0


@pytest.mark.parametrize("nA,nB,space", [(1, 0, 3), (500, 0, 2),
                                         (300, 700, 3), (0, 64, 9),
                                         (2000, 1000, 1 << 40)])
def test_merge_dedup_plain_matches_numpy(rng, nA, nB, space):
    """K6's plain version: numpy's unique counts of the valid keys, with a
    sentinel tail on both sides; one key repeated hundreds of times."""
    a = np.sort(rng.integers(0, space, nA))
    b = np.sort(rng.integers(0, space, nB))
    a[int(nA * 0.8):] = K.SENTINEL
    b[int(nB * 0.9):] = K.SENTINEL
    keys = np.concatenate([a, b])
    uk, uc = np.unique(keys[keys != K.SENTINEL], return_counts=True)
    ukeys, counts, n = MD.merge_dedup_pair(torch.from_numpy(keys), nA)
    assert int(n) == len(uk) and ukeys.shape[0] == nA + nB
    assert np.array_equal(ukeys[:len(uk)].numpy(), uk)
    assert np.array_equal(counts[:len(uk)].numpy(), uc)


# The receive tree's edge shapes (kernels/edge_cases.py) at a small tile:
# the plain versions do not know the tile, the shapes keep their form.
EDGE_TILE = 256
MERGE_CASES = EC.merge_runs_cases(tile=EDGE_TILE)
DEDUP_CASES = EC.merge_dedup_cases(tile=EDGE_TILE)


def _case(cases, name):
    return next(c for c in cases if c[0] == name)


def _merge_case(keys, tags, kind, arg):
    """The wrapper call an edge case names, and its (pair_len, a_len)."""
    fn = MR.merge_runs_pass if kind == "pass" else MR.merge_runs_pair
    out = fn(torch.from_numpy(keys), None if tags is None
             else torch.from_numpy(tags), arg)
    return out, (2 * arg, arg) if kind == "pass" else (max(len(keys), 1), arg)


@pytest.mark.parametrize("pay", [False, True], ids=["K5", "K7"])
@pytest.mark.parametrize("name", [c[0] for c in MERGE_CASES])
def test_merge_runs_edge_cases_match_numpy(name, pay):
    """K5 / K7 plain version on every edge shape against numpy's stable
    argsort of each pair: keys, and the payload in A-first order."""
    _, keys, tags, kind, arg = _case(MERGE_CASES, name)
    (got_k, got_t), (pair_len, _) = _merge_case(keys, tags if pay else None,
                                                kind, arg)
    order = np.concatenate(
        [i + np.argsort(keys[i:i + pair_len], kind="stable")
         for i in range(0, len(keys), pair_len)])
    assert np.array_equal(got_k.numpy(), keys[order])
    if pay:
        assert np.array_equal(got_t.numpy(), tags[order])
    else:
        assert got_t is None


@pytest.mark.parametrize("name", [c[0] for c in DEDUP_CASES])
def test_merge_dedup_edge_cases_match_numpy(name):
    """K6 plain version on every edge shape against numpy's unique counts
    of the valid keys; a sentinel / zero tail past n_out."""
    _, keys, nA = _case(DEDUP_CASES, name)
    uk, uc = np.unique(keys[keys != K.SENTINEL], return_counts=True)
    got = MD.merge_dedup_pair(torch.from_numpy(keys), nA)
    assert got[0].shape[0] == len(keys)
    _assert_dense_equal(got, torch.from_numpy(uk), torch.from_numpy(uc),
                        len(uk))


def _jax_pair(keys, nA, descending_b):
    """An edge case's pair as the JAX kernels take it: (hi, lo) of A and B,
    each padded with sentinels to a multiple of TILE_E (the merge of the
    valid keys is the same), B stored descending where the kernel's tree
    convention says so; and the padded nA."""
    sides = []
    for side in (keys[:nA], keys[nA:]):
        cap = max(-(-len(side) // TILE_E), 1) * TILE_E
        u = np.full(cap, SENT_U64, np.uint64)
        valid = side[side != K.SENTINEL]
        u[:len(valid)] = valid.astype(np.uint64)
        sides.append(u)
    a, b = sides
    hi, lo = S.split_hi_lo(np.concatenate([a, b[::-1] if descending_b
                                           else b]))
    return jnp.asarray(hi), jnp.asarray(lo), len(a)


@pytest.mark.parametrize("name", ["ties_of_six", "one_key_over_many_tiles",
                                  "a_wholly_above_b"])
def test_merge_runs_edge_cases_match_jax_interpret(name):
    """K5 and K7 plain versions against tree_merge_pair_alt and
    stream_merge_pair_pallas (interpret mode) on a subset of the edge
    shapes. Keys are equal over the valid prefix; (key, tag) is equal as a
    multiset (the JAX network may reorder tags within an equal-key
    segment)."""
    from zotpu.kernels.sort_pallas import (stream_merge_pair_pallas,
                                           tree_merge_pair_alt)
    _, keys, tags, kind, arg = _case(MERGE_CASES, name)
    assert kind == "pair"
    (got_k, got_t), _ = _merge_case(keys, tags, kind, arg)
    valid = int((keys != K.SENTINEL).sum())
    hi, lo, nA = _jax_pair(keys, arg, descending_b=True)
    jk = _from_jax(*tree_merge_pair_alt(hi, lo, nA, interpret=True))
    assert torch.equal(got_k[:valid], jk[:valid])
    assert torch.all(jk[valid:] == K.SENTINEL)
    # the payload rides beside its key: pad the tags as the keys were padded
    hi, lo, nA = _jax_pair(keys, arg, descending_b=False)
    jt = np.zeros(hi.shape[0], np.uint32)
    for src, dst in ((slice(0, arg), 0), (slice(arg, None), nA)):
        ok = keys[src] != K.SENTINEL
        jt[dst:dst + int(ok.sum())] = tags[src][ok]
    gh, gl, gt = stream_merge_pair_pallas(hi, lo, jnp.asarray(jt), nA,
                                          interpret=True)
    jk = _from_jax(gh, gl)
    assert torch.equal(got_k[:valid], jk[:valid])
    got = np.stack([got_k[:valid].numpy(), got_t[:valid].numpy()])
    want = np.stack([jk[:valid].numpy(),
                     np.asarray(gt)[:valid].astype(np.int64)])
    assert np.array_equal(got[:, np.lexsort(got[::-1])],
                          want[:, np.lexsort(want[::-1])])


@pytest.mark.parametrize("name", ["ties_straddle_every_boundary",
                                  "one_key_over_many_tiles",
                                  "valid_prefix_ends_on_a_tile_boundary",
                                  "all_sentinels"])
def test_merge_dedup_edge_cases_match_jax_interpret(name):
    """K6 plain version against merged_dedup_compact_pair (interpret mode)
    on a subset of the edge shapes: n_out and the dense prefix."""
    from zotpu.kernels.dedup_pallas import merged_dedup_compact_pair
    _, keys, nA = _case(DEDUP_CASES, name)
    hi, lo, jnA = _jax_pair(keys, nA, descending_b=True)
    jh, jl, jc, jn = merged_dedup_compact_pair(hi, lo, nA=jnA, interpret=True)
    jk, jcnt = _from_jax(jh, jl, jc)
    got = MD.merge_dedup_pair(torch.from_numpy(keys), nA)
    n = int(np.asarray(jn))
    assert int(got[2]) == n
    assert torch.equal(got[0][:n], jk[:n]) and torch.equal(got[1][:n], jcnt[:n])


def _jax_rowsum(panel_u64, probes_u64, tags, n_rows):
    """The JAX package's XLA formulation of the sharded pulldown's join:
    key* transform, a 3-key sort (key*, tag) of [panel | probes],
    _hits_from_merged_star, then _rowsum_by_key."""
    from zotpu.kernels.join import (_hits_from_merged_star, _rowsum_by_key,
                                    _transform_keys)
    phi, plo = (jnp.asarray(x) for x in S.split_hi_lo(panel_u64))
    qhi, qlo = (jnp.asarray(x) for x in S.split_hi_lo(probes_u64))
    ph, pl = _transform_keys(phi, plo, is_probe=False)
    qh, ql = _transform_keys(qhi, qlo, is_probe=True)
    tag = jnp.concatenate([jnp.full(panel_u64.size, n_rows, jnp.uint32),
                           jnp.asarray(tags.astype(np.uint32))])
    h, l, t = jax.lax.sort((jnp.concatenate([ph, qh]),
                            jnp.concatenate([pl, ql]), tag), num_keys=3)
    _, bkey = _hits_from_merged_star(h, l, t, n_rows)
    return np.asarray(_rowsum_by_key(bkey, n_rows))


@pytest.mark.parametrize("k,n_rows,n_panel", [(25, 64, 300), (11, 5, 0),
                                              (31, 40, 200)])
def test_row_hits_tagged_plain_matches_jax_and_isin(rng, k, n_rows,
                                                    n_panel):
    """K4's tagged entry (plain) against the JAX join formulation and an
    isin oracle: rows of any population, sentinel probes tagged 0, tags
    past n_rows ignored; k=31 includes the keys 2**62 - 1 and 2**62 - 2."""
    space = 1 << (2 * k)
    pool = rng.integers(0, min(space, 1 << 16), 3000).astype(np.uint64)
    if k == 31:
        pool[:4] = [space - 1, space - 2, space - 1, 0]
    panel = np.unique(np.concatenate([rng.choice(pool, n_panel // 2),
                                      pool[:2] if k == 31 else pool[:0],
                                      rng.integers(0, space, n_panel,
                                                   dtype=np.uint64)]))
    panel = panel[:n_panel] if n_panel else panel[:0]
    tags = rng.integers(0, n_rows + 3, pool.size)
    sent = rng.random(pool.size) < 0.25
    sent[:4] = False
    tags[sent] = 0
    order = np.argsort(pool, kind="stable")
    pool, tags, sent = pool[order], tags[order], sent[order]
    probes = K.from_hi_lo(*S.split_hi_lo(np.where(sent, SENT_U64, pool)))
    got = TJ.row_hits_tagged(K.from_hi_lo(*S.split_hi_lo(panel)), probes,
                             torch.from_numpy(tags), n_rows)
    hit = np.isin(pool, panel) & ~sent & (tags < n_rows)
    want = np.bincount(tags[hit], minlength=n_rows)[:n_rows]
    assert np.array_equal(got.numpy(), want)
    jprobes = np.where(sent, SENT_U64, pool)
    assert np.array_equal(got.numpy(), _jax_rowsum(panel, jprobes,
                                                   np.minimum(tags, n_rows),
                                                   n_rows))
    assert got.dtype == torch.int32
