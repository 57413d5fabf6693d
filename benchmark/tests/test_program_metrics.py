"""CPU tests of the readers of what the program records of itself (its
spans and counters, ``benchmark/program.py``), at tiny sizes with the
program's plain PyTorch versions.

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

CELLS = ("kmerize.ecoli30x.1file", "scan.ecoli30x.16samples",
         "kmerize.ecoli30x.16files")
TINY = {"genome_bp": 20000, "coverage": 3, "batch_reads": 64,
        "panel_bp": 20000}
NEW = ("parse_wait_share", "result_s_share", "aggregate_s_share",
       "h2d_gb_per_s", "dedup_roofline", "merge_roofline", "allocs_per_job",
       "lib_load_s")
# nothing to read without a card: device time, or CUDA's allocators
DEVICE_ONLY = ("h2d_gb_per_s", "dedup_roofline", "merge_roofline",
               "allocs_per_job")


def reader(name):
    return run.load_module(os.path.join(run.HERE, "metrics", name + ".py"))


def traced_run(capsys, cell, monkeypatch):
    """A traced run of ``cell`` in a process whose parser library loads
    anew (its load is what ``lib_load_s`` reads)."""
    from zotpu_torch.io import native
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    rc = run.main(["--workload", cell, "--seed", "2147483951", "--seconds",
                   "0.3", "--trace", "1"], root=ROOT,
                  devices=[torch.device("cpu")], cfg_patch=TINY)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reports_the_program_metrics(capsys, monkeypatch,
                                                      cell):
    res = traced_run(capsys, cell, monkeypatch)
    assert res["correct"]
    got = {n: m["value"] for n, m in res["metrics"].items()}
    tail = "aggregate_s_share" if cell.startswith("scan") else "result_s_share"
    for name in ("parse_wait_share", tail):
        assert 0 < got[name] < 1
    assert got["lib_load_s"] > 0
    assert not set(got) & set(DEVICE_ONLY)
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    listed = {m["name"] for m in spec["per_layer"]
              if cell in m.get("workloads", [cell])}
    assert set(got) & set(NEW) == listed & set(NEW) - set(DEVICE_ONLY)


def test_a_program_without_spans_or_counters_reads_nothing(capsys,
                                                           monkeypatch):
    """The parent's program has neither: each new reader returns None
    and the run goes on."""
    from zotpu_torch import metrics
    monkeypatch.setattr(metrics, "_Range",
                        lambda name: contextlib.nullcontext())
    monkeypatch.delattr(metrics, "counters")
    res = traced_run(capsys, CELLS[0], monkeypatch)
    assert res["correct"] and not set(res["metrics"]) & set(NEW)
    assert "container_s_share" in res["metrics"]


def test_device_readers_on_a_card_trace(monkeypatch):
    """The device-time readers over a made-up card trace: the program's
    counts over the kernels' and copies' seconds."""
    monkeypatch.setattr(program, "counters", lambda: {
        "h2d.bytes": 4_000_000_000, "dedup.keys_in": 8_912_896,
        "dedup.keys_out": 4_460_289, "merge.keys_in": 4_460_289 + 4_456_199,
        "merge.keys_out": 5_936_042, "alloc.device": 6, "alloc.host": 3})
    from benchmark import devtrace
    t = devtrace.Trace.__new__(devtrace.Trace)
    t.lo, t.hi, t.indices, t.host = 0, 1e6, [0], []
    t.device = [(0, 0, 50_000, "Memcpy HtoD (Pinned -> Device)"),
                (0, 60_000, 110_000, "Memcpy HtoD (Pageable -> Device)"),
                (0, 200_000, 200_080, "void (anonymous namespace)::"
                 "dedup_kernel(long long const*, long long)"),
                (0, 200_080, 200_100, "dedup_close_kernel"),
                (0, 300_000, 300_025, "setop_partition_kernel"),
                (0, 300_025, 300_200, "void (anonymous namespace)::"
                 "setop_kernel<0>(long long const*)")]
    ctx = SimpleNamespace(trace=t, device_kind="NVIDIA H100 80GB HBM3",
                          window=SimpleNamespace(jobs=[{}, {}, {}]))
    assert reader("h2d_gb_per_s").read(ctx) == pytest.approx(40.0)
    assert reader("dedup_roofline").read(ctx) == pytest.approx(
        100 * 142_667_800 / 3.35e12 / 100e-6)
    assert reader("merge_roofline").read(ctx) == pytest.approx(
        100 * 237_640_504 / 3.35e12 / 200e-6)
    assert reader("allocs_per_job").read(ctx) == 3.0
    ctx.device_kind = "a card with no listed peak"
    assert reader("dedup_roofline").read(ctx) is None


@pytest.mark.parametrize("counters, want", [
    ({"load.s": 12.5, "load.build_s": 12.0}, 0.5),
    ({"load.s": 0.25, "load.build_s": 0.0}, 0.25),
    ({"h2d.bytes": 8}, None), ({}, None), (None, None)])
def test_lib_load_s_leaves_the_compile_out(monkeypatch, counters, want):
    monkeypatch.setattr(program, "counters", lambda: counters)
    assert reader("lib_load_s").read(None) == want


def test_byte_functions_give_the_kernel_table():
    assert reader("dedup_roofline").launch_bytes(
        8_912_896, 4_460_289, 1) == 142_667_800
    assert reader("merge_roofline").launch_bytes(
        4_460_289 + 4_456_199, 5_936_042, 1) == 237_640_504


def test_span_share_clips_to_the_window():
    t = SimpleNamespace(lo=100.0, hi=300.0, host=[
        (50.0, 150.0, "zotpu.parse_wait"), (200.0, 220.0, "zotpu.parse_wait"),
        (290.0, 400.0, "zotpu.parse_wait"), (150.0, 200.0, "zotpu.step"),
        (100.0, 300.0, "bench.kmerize")])
    ctx = SimpleNamespace(trace=t)
    assert program.span_share(ctx, "parse_wait") == pytest.approx(80 / 200)
    assert program.span_share(ctx, "step") == pytest.approx(0.25)
    assert program.span_share(ctx, "result") is None
    assert program.span_share(SimpleNamespace(trace=None), "step") is None
