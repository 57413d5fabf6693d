"""CPU tests of the four-card cell ``kmerize.ecoli30x.shard4``
(``jobs/kmerize_sharded.py``) and its readers, at the harness's tiny size
on four CPU slots of distinct devices ("cpu" and "cpu:0" differ as
devices, so the mesh exchanges by copies, as between cards).

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import program, run  # noqa: E402

CELL = "kmerize.ecoli30x.shard4"
SLOTS = [torch.device(d) for d in ("cpu", "cpu:0") * 2]
TINY = {"genome_bp": 20000, "coverage": 3, "batch_reads": 64}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]
NEW = ("alltoall_bytes_per_base", "exchange_gb_per_s", "tree_roofline",
       "route_sync_share")
# nothing to read without a card: copies between cards, kernels' device
# time, CUDA's allocators
DEVICE_ONLY = ("exchange_gb_per_s", "tree_roofline", "device_idle_share",
               "device_peak_gib", "merge_roofline", "h2d_gb_per_s",
               "allocs_per_job")


def reader(name):
    return run.load_module(os.path.join(run.HERE, "metrics", name + ".py"))


def run_cell(capsys, trace=0, seed=2147483951):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", str(trace)], root=ROOT, devices=SLOTS,
                  cfg_patch=TINY)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


def test_the_cell_is_declared_as_the_one_card_run_over_four():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 4
    got = run.load_cell(CELL)
    one = run.load_cell("kmerize.ecoli30x.16files")
    assert (got.cfg["shards"], got.cfg["shard_hash"],
            got.cfg["capacity_factor"]) == (4, "prefix", 4.0)
    same = {k: v for k, v in got.cfg.items() if k in one.cfg and k not in (
        "name", "source", "deployment", "guarantees", "shards")}
    assert same == {k: one.cfg[k] for k in same} and len(same) > 12
    assert got.traffic == {"job": "kmerize_sharded", "files": 16}
    assert got.job.LIMITS == one.job.LIMITS


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_on_four_slots_equals_the_reference(capsys, trace):
    rc, res = run_cell(capsys, trace=trace)
    assert rc == 0
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] == 0 for c in res["compared"].values())
    assert list(res) == KEYS[:-1] + (["breakdown"] if trace else []) + KEYS[-1:]
    assert res["device"]["count"] == 4
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
            if CELL in m.get("workloads", [CELL])}
    got = set(res["metrics"])
    if not trace:
        assert got == want == {"bases_per_s", "setup_s"}
        return
    assert set(NEW) <= want
    assert got == want - set(DEVICE_ONLY)
    m = {n: v["value"] for n, v in res["metrics"].items()}
    assert m["alltoall_bytes_per_base"] > 0
    assert 0 < m["route_sync_share"] < 1


def test_byte_functions_give_the_kernel_table():
    tree = reader("tree_roofline")
    assert tree.k5_bytes(8_912_896) == 142_606_336
    assert tree.k6_bytes(3_605_244, 1_951_675, 1) == 60_068_760
    a2a = reader("alltoall_bytes_per_base")
    assert a2a.batch_bytes(4, 2_228_224) == 213_909_504
    # a 16-file run: 16 batches of 928,330 reads of 150 bases
    assert round(16 * a2a.batch_bytes(4, 2_228_224) / 139_249_500, 2) == 24.58


def test_device_readers_on_a_four_card_trace(monkeypatch):
    """The exchange's and the tree's readers over a made-up trace of two
    cards: the program's counts over the copies' and kernels' seconds."""
    monkeypatch.setattr(program, "counters", lambda: {
        "exchange.bytes": 6_000_000_000, "tree.k5_slots": 2 * 8_912_896,
        "tree.k6_keys_in": 2 * 3_605_244, "tree.k6_keys_out": 2 * 1_951_675})
    from benchmark import devtrace
    t = devtrace.Trace.__new__(devtrace.Trace)
    t.lo, t.hi, t.indices, t.host = 0, 1e6, [0, 1], []
    t.device = [(0, 0, 50_000, "Memcpy PtoP (Device -> Device)"),
                (1, 0, 50_000, "Memcpy PtoP (Device -> Device)"),
                (0, 60_000, 70_000, "Memcpy DtoD (Device -> Device)"),
                (0, 100_000, 100_005, "merge_runs_partition_kernel"),
                (0, 100_005, 100_060, "void (anonymous namespace)::"
                 "merge_runs_kernel<false>(long long const*)"),
                (1, 100_000, 100_065, "merge_runs_kernel<false>"),
                (0, 200_000, 200_010, "merge_dedup_partition_kernel"),
                (0, 200_010, 200_050, "merge_dedup_kernel"),
                (0, 200_050, 200_055, "dedup_close_kernel"),
                (1, 200_000, 200_055, "merge_dedup_kernel")]
    ctx = SimpleNamespace(trace=t, device_kind="NVIDIA H100 80GB HBM3",
                          window=SimpleNamespace(bases=300_000_000))
    assert reader("exchange_gb_per_s").read(ctx) == pytest.approx(60.0)
    assert reader("alltoall_bytes_per_base").read(ctx) == pytest.approx(20.0)
    assert reader("tree_roofline").read(ctx) == pytest.approx(
        100 * 2 * (142_606_336 + 60_068_760) / 3.35e12 / 235e-6)
    ctx.device_kind = "a card with no listed peak"
    assert reader("tree_roofline").read(ctx) is None


def test_a_program_without_the_new_counters_reads_nothing(capsys,
                                                          monkeypatch):
    """The parent's program has neither the spans nor the counters of the
    route, the exchange and the tree: their readers return None and the
    run goes on."""
    from zotpu_torch import metrics
    monkeypatch.setattr(metrics, "_Range",
                        lambda name: contextlib.nullcontext())
    monkeypatch.delattr(metrics, "counters")
    rc, res = run_cell(capsys, trace=1)
    assert rc == 0 and res["correct"]
    assert not set(res["metrics"]) & set(NEW)
    assert "container_s_share" in res["metrics"]


def _half_windows(fn):
    """``shuffle._pack`` with half of every slot's windows left out."""
    from zotpu_torch.keys import SENTINEL

    def half(inputs, *a, **kw):
        keys = fn(inputs, *a, **kw).clone()
        keys.view(inputs[0].shape[0], -1)[1::2] = SENTINEL
        return keys
    return half


@pytest.mark.parametrize("fault", ["rows_left_out", "all_to_all_skipped"])
def test_a_broken_route_is_not_correct(capsys, monkeypatch, fault):
    from zotpu_torch.dist import mesh, shuffle
    if fault == "rows_left_out":
        monkeypatch.setattr(shuffle, "_pack", _half_windows(shuffle._pack))
    else:   # each slot keeps its own buckets
        monkeypatch.setattr(mesh.Mesh, "all_to_all",
                            lambda self, sends: [s.reshape(-1)
                                                 for s in sends])
    rc, res = run_cell(capsys)
    assert rc == 0
    assert res["correct"] is False and res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["compared"].values())
