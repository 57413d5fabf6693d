"""The port's entry points (zotpu_torch/entry.py) against the repository's
``__graft_entry__.py`` on the CPU: ``entry``'s step against the JAX
``entry()`` step on the same ``default_rng(0)`` reads, and
``dryrun_multichip`` over CPU slots against golden and the JAX package's
prefix step on 4 of the 8 fake CPU devices; the JAX dry run itself runs
once in this file too, so both dry runs are seen to pass on one tree.
Tolerance: exact equality of the dense valid prefix [:n] and of n (never
the padded capacities), of the global keys and counts, and of the
cardinalities."""

import math

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from zotpu.dist import mesh as JM
from zotpu.dist import shuffle as JS
from zotpu.io import wire as JW
from zotpu.reference_impl import golden as G
from zotpu_torch import entry as E
from zotpu_torch import keys as K
from zotpu_torch.dist import mesh as TM

torch.set_num_threads(1)


def test_entry_arguments_equal_the_jax_entry_arguments():
    _, (codes, lengths) = E.entry(device="cpu")
    _, (jcodes, jlengths) = GE.entry()
    assert codes.device.type == "cpu" and codes.dtype == torch.uint8
    assert np.array_equal(codes.numpy(), jcodes)
    assert lengths.dtype == torch.int32
    assert np.array_equal(lengths.numpy(), jlengths)


def test_entry_step_equals_the_jax_entry_step_and_golden():
    """Pack (K1b's plain version), torch.sort and K2's plain version
    against the JAX step (XLA pack, lax.sort, dedup_count_sorted)."""
    step, args = E.entry(device="cpu")
    keys, counts, n = step(*args)
    jstep, jargs = GE.entry()
    uhi, ulo, jcounts, jn = (np.asarray(x) for x in jax.jit(jstep)(*jargs))
    jn = int(jn)
    assert int(n) == jn > 0
    want_k, want_c = K.from_hi_lo(uhi[:jn], ulo[:jn], jcounts[:jn])
    assert torch.equal(keys[:jn], want_k)
    assert torch.equal(counts[:jn], want_c)
    codes, _ = E.entry_inputs()
    gk, gc = G.kmerize(E.ENTRY_K, list(codes))
    assert np.array_equal(keys[:jn].numpy().astype(np.uint64), gk)
    assert np.array_equal(counts[:jn].numpy(), gc.astype(np.int64))


def _jax_prefix_step(D):
    """The JAX package's wire-packed prefix step over D fake CPU devices
    on the dry run's reads -> the global (keys, counts)."""
    codes, lengths = E.dry_inputs(D)
    step, _ = JS.make_kmerize_step(JM.make_mesh(D), E.DRY_K,
                                   E.DRY_READS_PER_SLOT, E.DRY_LEN,
                                   capacity_factor=E.DRY_CAPACITY_FACTOR,
                                   compact=True, wire=True)
    packed, mask = JW.pack_codes(codes)
    uhi, ulo, counts, n, overflow, _ = (np.asarray(x) for x in
                                        step(packed, mask, lengths))
    assert int(overflow.sum()) == 0
    return JS.gather_global(uhi.reshape(D, -1), ulo.reshape(D, -1),
                            counts.reshape(D, -1), n)


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_dryrun_on_cpu_slots_equals_golden_and_the_jax_step(D):
    """The accumulator saw the step's batch twice, so its counts are twice
    golden's and twice the JAX step's."""
    r = E.dryrun_multichip(D, devices=["cpu"] * D)
    codes, _ = E.dry_inputs(D)
    gk, gc = G.kmerize(E.DRY_K, list(codes))
    assert r["devices"] == ["cpu"] * D
    assert np.array_equal(r["keys"], gk)
    assert np.array_equal(r["counts"], gc * 2)
    jk, jc = _jax_prefix_step(D)
    assert np.array_equal(r["keys"], jk)
    assert np.array_equal(r["counts"], jc * 2)
    assert r["union"] == len(gk)
    assert r["cards"] == {"a": len(gk), "b": len(gk[::2]),
                          "intersect": len(gk[::2]), "union": len(gk),
                          "jaccard": len(gk[::2]) / len(gk)}
    assert r["overflow"] == {"prefix": 0, "mixed": 0, "pulldown": 0}
    panel, _ = G.kmerize(E.DRY_K, [E.DRY_PANEL_SEQ, codes[0]])
    want_hits = G.scan_panel(E.DRY_K, panel, list(codes))
    assert np.array_equal(r["row_hits"], want_hits) and want_hits.sum() > 0
    # one process: nothing crosses a process; the slots exchanged the
    # rows of four all-to-alls (prefix keys, mixed keys, probe keys and
    # their row ids), (D - 1) / D of each slot's (D, cap) int64 buffer
    cap = math.ceil(E.DRY_READS_PER_SLOT * (E.DRY_LEN - E.DRY_K + 1)
                    * E.DRY_CAPACITY_FACTOR / D)
    assert r["sent_bytes"] == 0
    assert r["slot_bytes"] == 4 * D * (D - 1) * cap * 8
    assert set(r["wall"]) == {"prefix_s", "mixed_s", "pulldown_s",
                              "set_op_s", "total_s"}


def test_the_jax_dry_run_passes_on_the_same_tree():
    """``__graft_entry__.dryrun_multichip(4)`` on the fake CPU devices
    (its interpret-mode block included), beside the port's."""
    assert GE.dryrun_multichip(4) is None
    assert E.dryrun_multichip(4, devices=["cpu"] * 4)["union"] > 0


def test_no_card_raises_with_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()
    with pytest.raises(ValueError, match="only 0 device"):
        E.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.dryrun_multichip(4, devices=["cuda:0"] * 4)


@pytest.mark.parametrize("n,devices", [(3, ["cpu"] * 3), (2, ["cpu"] * 4)])
def test_bad_slot_counts_raise(n, devices):
    with pytest.raises(ValueError):
        E.dryrun_multichip(n, devices=devices)


def _wrong_union(set_op):
    def wrapped(a, b, op, device):
        keys, counts = set_op(a, b, op, device=device)
        return keys, counts + 1
    return wrapped


def _one_add(add):
    def wrapped(self, runs):
        if getattr(self, "_added", False):
            return
        self._added = True
        add(self, runs)
    return wrapped


@pytest.mark.parametrize("fault,what", [
    ("set_op", "sharded union equals the one-device union"),
    ("accumulator", "counts are twice the single step's")])
def test_a_failed_check_raises(monkeypatch, fault, what):
    """A check raises DryRunError (not assert, which -O strips)."""
    if fault == "set_op":
        monkeypatch.setattr(E.setops, "set_op",
                            _wrong_union(E.setops.set_op))
    else:
        monkeypatch.setattr(E.ShardedAccumulator, "add",
                            _one_add(E.ShardedAccumulator.add))
    with pytest.raises(E.DryRunError, match=what):
        E.dryrun_multichip(4, devices=["cpu"] * 4)


def test_slot_bytes_count_only_rows_to_other_slots():
    """Mesh.all_to_all adds (D - 1) / D of the send buffers to
    ``slot_bytes`` and nothing to ``sent_bytes`` in one process."""
    mesh = TM.make_mesh(devices=["cpu"] * 4)
    before = TM.slot_bytes(), TM.sent_bytes()
    sends = [torch.arange(4 * 5, dtype=torch.int64).reshape(4, 5) + 100 * i
             for i in range(4)]
    recv = mesh.all_to_all(sends)
    assert torch.equal(recv[1], torch.cat([s[1] for s in sends]))
    assert TM.slot_bytes() - before[0] == 4 * 3 * 5 * 8
    assert TM.sent_bytes() == before[1]
