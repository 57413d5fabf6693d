"""CPU tests of the set-op cell ``setops.ecoli30x.8v8samples``
(``jobs/setops.py``), its plain reference (``setops_reference.py``) and
its readers (``metrics/set_read_s_share.py``, ``metrics/setop_roofline.py``),
at the harness's tiny size with the program's plain PyTorch versions.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import control, program, run, setops_reference  # noqa: E402

CELL = "setops.ecoli30x.8v8samples"
TINY = {"genome_bp": 20000, "coverage": 3}
# large enough that keys of A and of B share their low 32 bits
MEDIUM = {"genome_bp": 200000, "coverage": 10}
NEW = ("set_read_s_share", "setop_roofline")
# nothing to read without a card: device time, CUDA's allocators
DEVICE_ONLY = ("setop_roofline", "h2d_gb_per_s", "device_idle_share",
               "device_peak_gib", "allocs_per_job")


def reader(name):
    return run.load_module(os.path.join(run.HERE, "metrics", name + ".py"))


def run_cell(capsys, trace=0, seed=2147483951):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", str(trace)], root=ROOT,
                  devices=[torch.device("cpu")], cfg_patch=TINY)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


def test_the_cell_is_the_30x_run_split_in_two_groups():
    got = run.load_cell(CELL)
    one = run.load_cell("kmerize.ecoli30x.16files")
    recipe = ("genome_bp", "read_len", "coverage", "sub_rate", "n_rate",
              "reads", "bases", "k", "codec")
    assert {k: got.cfg[k] for k in recipe} == {k: one.cfg[k] for k in recipe}
    assert got.cfg["groups"] == {"A": list(range(8)),
                                 "B": list(range(8, 16))}
    assert got.cfg["reduced"] == []
    assert got.traffic == {"job": "setops", "files": 16,
                           "ops": list(got.job.OPS)}
    assert set(got.job.LIMITS.values()) == {0}
    assert got.cell["chips"] == 1


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_equals_the_reference(capsys, trace):
    rc, res = run_cell(capsys, trace=trace)
    assert rc == 0
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["compared"] == {n: {"value": 0, "limit": 0} for n in
                               ("header_off", "keys_off", "counts_off",
                                "cards_off")}
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
            if CELL in m.get("workloads", [CELL])}
    got = set(res["metrics"])
    if not trace:
        assert got == want == {"bases_per_s", "setup_s"}
        return
    assert set(NEW) <= want
    assert got == want - set(DEVICE_ONLY) == {
        "set_read_s_share", "container_s_share", "lib_load_s"}
    assert 0 < res["metrics"]["set_read_s_share"]["value"] < 1


def test_the_reference_against_numpy():
    rng = np.random.default_rng(8)
    a = np.unique(rng.integers(0, 5000, 3000, dtype=np.uint64))
    b = np.unique(np.concatenate([a[::4], rng.integers(
        0, 5000, 1000, dtype=np.uint64)]))
    ca = rng.integers(1, 9, len(a)).astype(np.uint32)
    cb = rng.integers(1, 9, len(b)).astype(np.uint32)
    ca[::5] = cb[-3:] = 0xFFFFFFFF
    got = setops_reference.set_ops((a, ca), (b, cb), "cpu")
    ka, kb = dict(zip(a.tolist(), ca.tolist())), dict(zip(b.tolist(),
                                                          cb.tolist()))

    def want(keys, count):
        keys = sorted(keys)
        return (np.array(keys, np.uint64),
                np.array([min(count(k), 0xFFFFFFFF) for k in keys],
                         np.uint32))

    both = lambda k: ka.get(k, 0) + kb.get(k, 0)      # noqa: E731
    for op, (keys, count) in {
            "union": (ka.keys() | kb.keys(), both),
            "intersect": (ka.keys() & kb.keys(), both),
            "diff": (ka.keys() - kb.keys(), ka.get)}.items():
        w = want(keys, count)
        assert got[op][0].dtype == np.uint64 and got[op][1].dtype == np.uint32
        assert np.array_equal(got[op][0], w[0]), op
        assert np.array_equal(got[op][1], w[1]), op
    assert (got["union"][1] == 0xFFFFFFFF).sum() > 0
    n_int = len(ka.keys() & kb.keys())
    assert got["cards"] == {"a": len(a), "b": len(b), "intersect": n_int,
                            "union": len(ka.keys() | kb.keys())}
    empty = (np.empty(0, np.uint64), np.empty(0, np.uint32))
    got = setops_reference.set_ops((a, ca), empty, "cpu")
    assert np.array_equal(got["diff"][0], a) and len(got["intersect"][0]) == 0
    assert got["cards"] == {"a": len(a), "b": 0, "intersect": 0,
                            "union": len(a)}


def _fault(monkeypatch, fault):
    """Break one of the job's commands underneath the harness."""
    from zotpu_torch.workloads import setops as W
    real = W.set_op

    def set_op(a, b, op, device="cuda"):
        if fault == "intersect_as_union" and op == "intersect":
            op = "union"
        keys, counts = real(a, b, op, device=device)
        if fault == "count_altered" and op == "union":
            counts = counts.copy()
            counts[len(counts) // 2] += 1
        if fault == "diff_key_dropped" and op == "diff":
            keys, counts = keys[1:], counts[1:]
        return keys, counts
    monkeypatch.setattr(W, "set_op", set_op)


@pytest.mark.parametrize("fault", ["intersect_as_union", "count_altered",
                                   "diff_key_dropped"])
def test_a_broken_command_is_not_correct(capsys, monkeypatch, fault):
    _fault(monkeypatch, fault)
    rc, res = run_cell(capsys)
    assert rc == 0
    assert res["correct"] is False and res["failed"] >= 1
    off = {n: c["value"] for n, c in res["compared"].items()}
    assert off["header_off"] == off["cards_off"] == 0
    assert (off["keys_off"] > 0) == (fault != "count_altered")
    assert (off["counts_off"] > 0) == (fault == "count_altered")


def test_control_is_not_correct(capsys):
    """The reference with keys held in 32 bits, in the program's place,
    fails the cell's comparison on every seed."""
    assert control.main(["--workload", CELL, "--seeds", "5", "6",
                         "--device", "cpu"], cfg_patch=MEDIUM) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for line in lines:
        got = json.loads(line)
        assert got["control_correct"] is False
        assert got["control"]["keys_off"] > 0


def test_a_program_without_the_entries_stops_before_set_up(monkeypatch):
    """A program without ``set_op_paths`` cannot run the cell: the job
    stops where it is made, before the sets are counted, and the run
    exits non-zero (through the exception) without a result line."""
    from zotpu_torch.workloads import setops as W
    monkeypatch.delattr(W, "set_op_paths")
    with pytest.raises(ImportError, match="set_op_paths"):
        run.main(["--workload", CELL, "--seed", "1", "--seconds", "0.1"],
                 root=ROOT, devices=[torch.device("cpu")], cfg_patch=TINY)


def test_byte_function_gives_the_kernel_table():
    """K3 at 2^24 + 2^24 disjoint keys (PERF.md's kernel table)."""
    roof = reader("setop_roofline")
    n = 1 << 24
    assert roof.launch_bytes("union", 2 * n, 2 * n, 1) == 1_073_741_848
    assert roof.launch_bytes("intersect", 2 * n, 0, 1) == 268_435_480
    assert roof.launch_bytes("diff", 2 * n, n, 1) == 671_088_664
    assert roof.launch_bytes("jaccard", 2 * n, 0, 1) == 268_435_480


def _trace(host=(), device=()):
    from benchmark import devtrace
    t = devtrace.Trace.__new__(devtrace.Trace)
    t.lo, t.hi, t.indices = 0, 1_000_000, [0]
    t.host, t.device = list(host), list(device)
    return t


def test_readers_on_made_up_counters(monkeypatch):
    counts = {"setop.union.keys_in": 2 * (1 << 24),
              "setop.union.keys_out": 2 * (1 << 24),
              "setop.intersect.keys_in": 2 * (1 << 24),
              "setop.intersect.keys_out": 0,
              "setop.diff.keys_in": 2 * (1 << 24),
              "setop.diff.keys_out": 1 << 24,
              "merge.keys_in": 123}
    monkeypatch.setattr(program, "counters", lambda: counts)
    t = _trace(
        host=[(0, 250_000, "zotpu.set_read"), (500_000, 600_000,
                                                "zotpu.set_read"),
              (900_000, 1_200_000, "zotpu.set_read"),
              (0, 1_000_000, "zotpu.upload")],
        device=[(0, 10, 20, "setop_partition_kernel"),
                (0, 20, 600, "void (anonymous namespace)::setop_kernel<0>"
                 "(long long const*)"),
                (0, 700, 1_090, "setop_kernel<1>"),
                (0, 1_100, 1_550, "setop_kernel<2>"),
                (0, 2_000, 2_100, "dedup_kernel")])
    ctx = SimpleNamespace(trace=t, device_kind="NVIDIA H100 80GB HBM3")
    assert reader("set_read_s_share").read(ctx) == pytest.approx(0.45)
    want = 1_073_741_848 + 268_435_480 + 671_088_664
    assert reader("setop_roofline").read(ctx) == pytest.approx(
        100 * want / 3.35e12 / 1_430e-6)
    ctx.device_kind = "a card with no listed peak"
    assert reader("setop_roofline").read(ctx) is None


def test_readers_without_the_program_counters_read_nothing(monkeypatch):
    ctx = SimpleNamespace(trace=_trace(host=[(0, 10, "zotpu.upload")]),
                          device_kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(program, "counters", lambda: None)
    assert reader("setop_roofline").read(ctx) is None
    monkeypatch.setattr(program, "counters", lambda: {"merge.keys_in": 9,
                                                      "h2d.bytes": 8})
    assert reader("setop_roofline").read(ctx) is None
    assert reader("set_read_s_share").read(ctx) is None
    assert reader("set_read_s_share").read(
        SimpleNamespace(trace=None)) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card, capsys):
    """At the cell's own size on the card, the 32-bit control is not
    correct on three seeds."""
    assert control.main(["--workload", CELL, "--seeds", "2147483905",
                         "2147483906", "2147483907"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert all(json.loads(x)["control_correct"] is False for x in lines)


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    import subprocess
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "2147483999", "--seconds", "3", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0
    assert set(NEW) <= set(res["metrics"])
    assert 0 < res["metrics"]["setop_roofline"]["value"] < 100
