"""Spans and counters of the sharded kmerize (``kmerize_paths_sharded``,
``dist/shuffle._route``, ``dist/mesh.Mesh.all_to_all``, K5 and K6) on the
CPU, over 4 slots on one device and on distinct devices: which spans a
run opens under ``torch.profiler``, that the counters equal the same
numbers taken from the mesh's byte count, ``Stats`` and the receive
tree's own calls, and that nothing is recorded while no profiler runs."""

import collections
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zotpu_torch import metrics
from zotpu_torch.dist import mesh as TM
from zotpu_torch.dist import shuffle as TS
from zotpu_torch.workloads import kmerize as TW

torch.set_num_threads(1)

K, BATCH, MAX_LEN, D = 21, 64, 64, 4
R = BATCH // D                      # rows a slot takes of each batch
FORMS = {"shared": ["cpu"] * D, "distinct": ["cpu", "cpu:0"] * (D // 2)}
# 4.0 is the entry's default (no second round); at 1.25 the first base's
# skew in canonical keys sends most batches into the second round
FACTORS = {"default": 4.0, "second_round": 1.25}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """Two FASTQ files of 150 and 130 reads, 40-64 bases, of one seeded
    genome: 6 batches of 64 rows."""
    rng = np.random.default_rng(18)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    d = tmp_path_factory.mktemp("shard_spans")
    out = []
    for f in range(2):
        path = d / f"s{f}.fastq"
        with open(path, "w") as fh:
            for i in range(150 - 20 * f):
                n = int(rng.integers(40, MAX_LEN + 1))
                off = int(rng.integers(0, len(genome) - n))
                fh.write(f"@r{f}.{i}\n{genome[off:off + n]}\n+\n{'I' * n}\n")
        out.append(str(path))
    return out


def _spy_tree(monkeypatch):
    """Record the receive tree's calls as ``shuffle`` makes them: the
    slots of each K5 pass, and the unique keys out of each K6 call."""
    k5, k6 = [], []

    def k5_spy(keys, pay, run, _f=TS.merge_runs_pass):
        k5.append(keys.shape[0])
        return _f(keys, pay, run)

    def k6_spy(f):
        def spy(keys, arg):
            out = f(keys, arg)
            k6.append(int(out[2]))
            return out
        return spy

    monkeypatch.setattr(TS, "merge_runs_pass", k5_spy)
    monkeypatch.setattr(TS, "merge_dedup_pass", k6_spy(TS.merge_dedup_pass))
    monkeypatch.setattr(TS, "merge_dedup_pair", k6_spy(TS.merge_dedup_pair))
    return k5, k6


def _profiled_run(paths, slots, factor):
    """kmerize_paths_sharded under the profiler from fresh counters:
    (keys, stats, span counts, counters, the mesh's slot bytes)."""
    metrics.reset_counters()
    TM.reset_sent_bytes()
    stats = TW.Stats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        keys, _ = TW.kmerize_paths_sharded(
            paths, K, D, batch_reads=BATCH, max_len=MAX_LEN, stats=stats,
            capacity_factor=factor, devices=slots)
    spans = collections.Counter(
        e.name[len(metrics.SPAN_PREFIX):] for e in prof.events()
        if e.name.startswith(metrics.SPAN_PREFIX))
    return keys, stats, spans, metrics.counters(), TM.slot_bytes()


@pytest.fixture(scope="module",
                params=[(f, c) for f in FORMS for c in FACTORS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def traced(request, paths):
    form, factor = request.param
    with pytest.MonkeyPatch.context() as mp:
        k5, k6 = _spy_tree(mp)
        keys, stats, spans, got, slot_bytes = _profiled_run(
            paths, FORMS[form], FACTORS[factor])
    return dict(keys=keys, stats=stats, spans=spans, got=got,
                slot_bytes=slot_bytes, k5=k5, k6=k6, factor=factor)


def _capacities(factor):
    cap = math.ceil(R * (MAX_LEN - K + 1) * FACTORS[factor] / D)
    return cap, (cap + 3) // 4


def test_the_sharded_run_opens_its_spans(traced, paths):
    stats, spans = traced["stats"], traced["spans"]
    b = stats.batches
    assert b == 6
    assert spans["step"] == spans["route_sync"] == spans["merge"] == b
    assert spans["upload"] == b * D     # each slot's; no wait on the CPU
    assert spans["result"] == 1
    want, _ = TW.kmerize_paths(paths, K, batch_reads=BATCH, max_len=MAX_LEN,
                               device="cpu")
    assert np.array_equal(traced["keys"], want)


def test_exchange_counters(traced):
    """``exchange.bytes`` is the mesh's slot bytes, by its arithmetic;
    ``exchange.valid_keys`` the routed total of ``Stats``."""
    stats, got = traced["stats"], traced["got"]
    cap, cap2 = _capacities(traced["factor"])
    rounds = stats.second_rounds
    assert (rounds == 0) == (traced["factor"] == "default")
    to_others = D * D * 8 * (D - 1) // D
    assert got["exchange.bytes"] == traced["slot_bytes"] == to_others * (
        stats.batches * cap + rounds * cap2)
    assert got["exchange.valid_keys"] == sum(stats.routed_per_shard) > 0


def test_tree_counters_match_the_tree(traced):
    """K5's slots: one pass over the first round's D runs a slot, or two
    passes over each round's runs where the second round ran; K6 takes
    every key the slot received and writes its unique keys."""
    stats, got = traced["stats"], traced["got"]
    cap, cap2 = _capacities(traced["factor"])
    rounds = stats.second_rounds
    per_slot = ((stats.batches - rounds) * D * cap
                + rounds * 2 * D * (cap + cap2))
    assert got["tree.k5_slots"] == sum(traced["k5"]) == D * per_slot
    assert len(traced["k6"]) == D * stats.batches
    assert got["tree.k6_keys_out"] == sum(traced["k6"])
    assert got["tree.k6_keys_in"] == sum(stats.routed_per_shard)
    assert got["tree.k6_keys_in"] >= got["tree.k6_keys_out"] > 0


@pytest.mark.parametrize("form", FORMS)
def test_nothing_is_recorded_without_a_profiler(paths, monkeypatch, form):
    opened = []
    monkeypatch.setattr(metrics, "_Range", opened.append)
    assert not torch._C._autograd._profiler_enabled()
    metrics.reset_counters()
    TW.kmerize_paths_sharded(paths, K, D, batch_reads=BATCH,
                             max_len=MAX_LEN, devices=FORMS[form])
    assert opened == []
    assert {name: v for name, v in metrics.counters().items()
            if not name.startswith("load.")} == {}


def test_device_counters_sum_every_element():
    """A counted tensor of several elements (a sender's ``landed``) is
    summed whole, beside 0-d ones."""
    metrics.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        metrics.count_device("x", torch.tensor([3, 4, 5]))
        metrics.count_device("x", torch.tensor(6))
    assert metrics.counters() == {"x": 18}
    metrics.reset_counters()


def test_alloc_mark_leaves_out_what_is_not_a_card():
    with profile(activities=[ProfilerActivity.CPU]):
        assert metrics.alloc_mark(*FORMS["distinct"]) is None
        assert metrics.alloc_mark() is None
