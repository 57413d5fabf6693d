"""Where the port's sharding differs from the JAX package's: the sentinel's
owner slot when 2k - log2(D) = 32 (k=17 at D=4, k=18 at D=16).

The reference's prefix owner (``zotpu.dist.shuffle._owner_of``) takes
``hi >> (shift - 32)`` as int32 when the owner bits start at bit 32 or
above. At shift 32 that is ``hi >> 0``: a sentinel's hi word 0xFFFFFFFF
becomes -1, and ``jnp.minimum(own, n_shards - 1)`` leaves it there, so
the sentinels no longer sort to the last owner and ``python -m zotpu
kmerize --shards 4 -k 17`` stops with a bucket overflow. At every other
shift the sentinel clamps to the last slot. The port's ``_owner_of``
shifts int64 keys and clamps, so the sentinel goes to the last slot at
every k, and the port's sharded kmerize at k=17 over 4 slots equals
golden. The mixed owner does not meet the edge in either package: both
clamp the sentinel's owner to the last slot before any signed cast.
``zotpu/`` is the reference and is not edited; the port keeps its
behaviour (as for the zero-count ``intersect``, test_torch_setops.py).
Tolerance: exact equality."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zotpu import cli as zcli
from zotpu import semantics as S
from zotpu.dist import shuffle as JS
from zotpu.io import container
from zotpu.reference_impl import golden as G
from zotpu_torch import cli as tcli
from zotpu_torch import keys as K
from zotpu_torch.dist import shuffle as TS

torch.set_num_threads(1)

# (k, log2 D): 2k - p = 32 at the first two; the others take either branch
# of the reference's shift
EDGE = [(17, 2), (18, 4)]
CLEAR = [(19, 2), (18, 3), (16, 1), (15, 2)]


def _keys_and_sentinel(k, seed=0):
    """Sorted random 2k-bit keys with both extremes, then one sentinel,
    as the reference's (hi, lo) u32 words and the port's int64 keys."""
    rng = np.random.default_rng(seed)
    keys = np.sort(np.concatenate([
        rng.integers(0, 1 << (2 * k), 64, dtype=np.uint64),
        np.array([0, (1 << (2 * k)) - 1], np.uint64)]))
    hi, lo = S.split_hi_lo(keys)
    hi = np.append(hi, np.uint32(0xFFFFFFFF))
    lo = np.append(lo, np.uint32(0xFFFFFFFF))
    return hi, lo, K.from_hi_lo(hi, lo)


@pytest.mark.parametrize("k,p", EDGE + CLEAR)
def test_prefix_owner_of_the_sentinel(k, p):
    """The reference gives the sentinel owner -1 at 2k - p = 32 and the
    last slot elsewhere; the port gives the last slot everywhere; both
    agree on every real key."""
    D = 1 << p
    hi, lo, keys = _keys_and_sentinel(k)
    ref = np.asarray(JS._owner_of(jnp.asarray(hi), jnp.asarray(lo), k, p, D))
    port = TS._owner_of(keys, k, p, D).numpy()
    assert np.array_equal(ref[:-1], port[:-1])
    assert ref[:-1].min() == 0 and ref[:-1].max() == D - 1
    assert port[-1] == D - 1
    assert ref[-1] == (-1 if 2 * k - p == 32 else D - 1)


@pytest.mark.parametrize("k,p", EDGE + CLEAR)
def test_mixed_owner_meets_no_edge(k, p):
    """``_embed_bits`` places the mixed owner at bit max(2k - 32, 0) of the
    hi word in both packages; after the owner sort both give the same
    embedded keys and owners, and the sentinel's owner is the last slot,
    at the prefix owner's edge too."""
    D = 1 << p
    hi, lo, keys = _keys_and_sentinel(k, seed=k + p)
    eb = JS._embed_bits(k, p)
    assert TS._embed_bits(k, p) == eb is not None
    khi, klo, ref_owner, _, embedded = JS._mixed_owner_sort(
        jnp.asarray(hi), jnp.asarray(lo), k, p, D)
    ekeys, owner, _, port_embedded = TS._mixed_owner_sort(keys, k, p, D)
    assert embedded and port_embedded
    assert torch.equal(ekeys, K.from_hi_lo(np.asarray(khi), np.asarray(klo)))
    assert np.array_equal(owner.numpy(), np.asarray(ref_owner))
    assert ekeys[-1] == K.SENTINEL and owner[-1] == D - 1
    assert int(np.asarray(ref_owner).min()) >= 0


@pytest.fixture(scope="module")
def reads_fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("k17")
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), size=20000))
    reads = [genome[o:o + 100] for o in rng.integers(0, 19900, 400)]
    reads[7] = reads[7][:50] + "N" + reads[7][51:]
    path = d / "r.fastq"
    path.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                            for i, r in enumerate(reads)))
    return d, reads, str(path)


FLAGS = ["-k", "17", "--batch-reads", "256", "--max-len", "128"]


def _run(main, argv):
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    return rc, buf.getvalue() + err.getvalue()


def test_port_kmerize_shards4_k17_equals_golden_and_one_device(reads_fastq):
    """The port's ``kmerize --shards 4 -k 17`` over 4 CPU slots, prefix
    and mixed owner, equals golden and the port's one-device run."""
    d, reads, fq = reads_fastq
    want_k, want_c = G.kmerize(17, reads)
    outs = {}
    for name, extra in (("one", []), ("prefix", ["--shards", 4]),
                        ("mixed", ["--shards", 4, "--shard-hash", "mixed"])):
        out = d / f"t_{name}.zkf"
        rc, text = _run(tcli.main, ["kmerize", *FLAGS, "--device", "cpu",
                                    *extra, out, fq])
        assert rc == 0, text
        ks = container.read(str(out))
        outs[name] = ks
        assert np.array_equal(ks.keys, want_k), name
        assert np.array_equal(ks.counts, want_c), name
    for name in ("prefix", "mixed"):
        assert np.array_equal(outs[name].keys, outs["one"].keys)
        assert np.array_equal(outs[name].counts, outs["one"].counts)


def test_reference_kmerize_shards4_k17_overflows_where_mixed_runs(
        reads_fastq):
    """The reference's symptom of the -1 owner on the same file: ``python
    -m zotpu kmerize --shards 4 -k 17`` exits 1 with a bucket overflow,
    while its mixed owner runs and equals golden (and so the port)."""
    d, reads, fq = reads_fastq
    rc, text = _run(zcli.main, ["kmerize", *FLAGS, "--shards", 4,
                                d / "j_prefix.zkf", fq])
    assert rc == 1 and "bucket overflow" in text
    rc, text = _run(zcli.main, ["kmerize", *FLAGS, "--shards", 4,
                                "--shard-hash", "mixed", d / "j_mixed.zkf",
                                fq])
    assert rc == 0, text
    ks = container.read(str(d / "j_mixed.zkf"))
    want_k, want_c = G.kmerize(17, reads)
    assert np.array_equal(ks.keys, want_k)
    assert np.array_equal(ks.counts, want_c)
