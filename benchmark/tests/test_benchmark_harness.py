"""CPU tests of the benchmark harness, at tiny sizes with the program's
plain PyTorch versions.

    python -m pytest benchmark/tests -q

They drive ``benchmark/run.py``'s ``main`` in process with ``devices=[cpu]``
(which skips its look for cards) and a shrunken configuration.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import control, reference, run  # noqa: E402

# the cells of BENCHMARK.json
CELLS = ("kmerize.ecoli30x.1file", "scan.ecoli30x.16samples",
         "kmerize.ecoli30x.16files")
TINY = {"genome_bp": 20000, "coverage": 3, "batch_reads": 64,
        "panel_bp": 20000}
# large enough that the 32-bit control meets error k-mers of the genome's
MEDIUM = {"genome_bp": 200000, "coverage": 10, "panel_bp": 200000}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def run_cell(capsys, cell, root=ROOT, trace=0, seconds=0.3, seed=7):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  devices=[torch.device("cpu")], cfg_patch=TINY)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.mark.parametrize("cell", CELLS)
def test_port_equals_reference(capsys, cell):
    rc, res = run_cell(capsys, cell, seed=3_000_000_019)
    assert rc == 0
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] == 0 for c in res["compared"].values())


def test_reference_against_numpy_windows():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (5, 40)).astype(np.uint8)
    codes[1, 7] = 4
    k = 9
    got = reference.canonical_windows(torch.from_numpy(codes), k).numpy()
    for r in range(codes.shape[0]):
        for i in range(40 - k + 1):
            w = codes[r, i:i + k].astype(np.int64)
            if (w > 3).any():
                assert got[r, i] == -1
                continue
            fwd = int("".join(map(str, w)), 4)
            rc = int("".join(map(str, 3 - w[::-1])), 4)
            assert got[r, i] == min(fwd, rc)


def test_byte_functions():
    pack = run.load_module(os.path.join(run.HERE, "metrics",
                                        "pack_roofline.py"))
    join = run.load_module(os.path.join(run.HERE, "metrics",
                                        "join_roofline.py"))
    sort = run.load_module(os.path.join(run.HERE, "metrics",
                                        "sort_roofline.py"))
    assert pack.launch_bytes(65536, 160, 25) == 75_497_472
    assert join.launch_bytes(65536, 160, 25, 2_048_552) == 88_342_528
    assert join.padded(2_048_552) == 1 << 21 and join.padded(3) == 8
    assert sort.sort_bytes(65536, 160, 25) == 142_606_336


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(capsys, trace):
    rc, res = run_cell(capsys, CELLS[0], trace=trace)
    assert rc == 0
    assert list(res) == KEYS[:-1] + (["breakdown"] if trace else []) + KEYS[-1:]
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["device"]) == dev | ({"busy_s", "window_s"} if trace
                                        else set())
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    want = [m["name"] for m in spec["per_layer" if trace else "end_to_end"]
            if CELLS[0] in m.get("workloads", [CELLS[0]])]
    # device metrics have nothing to read on the CPU
    assert set(res["metrics"]) <= set(want)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_new_files_are_found(tmp_path, capsys):
    """A configuration, a traffic mix and a metric added as files, and
    named in BENCHMARK.json, make a new cell with the new metric."""
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(tmp_path / "benchmark/configs/ecoli_k12_30x_k25.json"))
    cfg.update(name="tiny_new", k=21)
    (tmp_path / "benchmark/configs/tiny_new.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/kmerize_4files.json").write_text(
        json.dumps({"job": "kmerize", "files": 4}))
    (tmp_path / "benchmark/metrics/jobs_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx.window.jobs)\n")
    spec["configs"].append({"name": "tiny_new", "source": "x",
                            "file": "benchmark/configs/tiny_new.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new.cell", "config": "tiny_new",
                              "traffic": "kmerize_4files", "chips": 1,
                              "why": "x"})
    spec["end_to_end"].append({"name": "jobs_in_window", "unit": "1",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    got = run.load_cell("new.cell", root=str(tmp_path))
    assert got.cfg["k"] == 21 and got.traffic["files"] == 4
    assert [m["name"] for m in got.end_to_end][-1] == "jobs_in_window"
    rc, res = run_cell(capsys, "new.cell", str(tmp_path))
    assert rc == 0 and res["correct"]
    assert res["metrics"]["jobs_in_window"]["value"] == res["attempted"]
    old = run.load_cell(CELLS[0], root=str(tmp_path))
    assert "jobs_in_window" not in [m["name"] for m in old.end_to_end]


def test_forbidden_module_stops_the_run(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "zotpu_like", sys)   # not "zotpu"
    rc, res = run_cell(capsys, CELLS[0])
    assert rc == 0 and res["correct"]
    monkeypatch.setitem(sys.modules, "zotpu.semantics", sys)
    rc, res = run_cell(capsys, CELLS[0])
    assert rc == 3 and res is None


@pytest.mark.parametrize("cell", CELLS[1:])
def test_a_cell_run_loads_no_jax(cell):
    """A whole run in a fresh process: no module whose top-level name is
    jax, jaxlib, flax or zotpu is loaded (run.main exits 3 if one is)."""
    code = ("import sys, torch; sys.path.insert(0, %r); "
            "from benchmark import run; "
            "rc = run.main(['--workload', %r, '--seed', '5', '--seconds', "
            "'0.2'], root=%r, devices=[torch.device('cpu')], "
            "cfg_patch=%r); "
            "bad = {m.split('.')[0] for m in sys.modules} & run.FORBIDDEN; "
            "print('RC', rc, sorted(bad))" % (ROOT, cell, ROOT, TINY))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "RC 0 []"


def test_run_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def _half_sentinel(fn):
    """``fn`` (a pack of R rows) with every other row's windows left out."""
    from zotpu_torch.keys import SENTINEL

    def half(inputs, *a, **kw):
        keys = fn(inputs, *a, **kw).clone()
        rows = inputs[0] if isinstance(inputs, tuple) else inputs
        keys.view(rows.shape[0], -1)[1::2] = SENTINEL
        return keys
    return half


def _fault(monkeypatch, cell, fault):
    """Break the timed path of ``cell`` underneath the harness."""
    from zotpu_torch.workloads import accumulator, kmerize, pulldown
    scan = cell.startswith("scan")
    if fault == "state_unchanged":
        cls = (pulldown.RecordAggregator if scan else
               accumulator.DeviceAccumulator)
        monkeypatch.setattr(cls, "add", lambda self, *a: None)
    elif fault == "half_batch":
        if scan:
            def hits(*a, _f=pulldown.scan_batch_wire):
                h = _f(*a).clone()
                h[1::2] = 0
                return h
            monkeypatch.setattr(pulldown, "scan_batch_wire", hits)
        else:
            monkeypatch.setattr(kmerize, "pack_canonical_wire",
                                _half_sentinel(kmerize.pack_canonical_wire))
    elif fault == "answer_altered":
        if scan:
            def add(self, row_hits, record_ids,
                    _f=pulldown.RecordAggregator.add):
                row_hits = row_hits.copy()
                row_hits[0] += 1
                _f(self, row_hits, record_ids)
            monkeypatch.setattr(pulldown.RecordAggregator, "add", add)
        else:
            def dedup(keys, _f=kmerize.kmer_sort_dedup):
                k, c, n = _f(keys)
                return k, c + (torch.arange(c.shape[0]) == 0), n
            monkeypatch.setattr(kmerize, "kmer_sort_dedup", dedup)


FAULTS = [(c, f) for c in CELLS for f in
          ("state_unchanged", "half_batch", "answer_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(capsys, monkeypatch, cell,
                                            fault):
    _fault(monkeypatch, cell, fault)
    rc, res = run_cell(capsys, cell)
    assert rc == 0
    assert res["correct"] is False and res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["compared"].values()) \
        or res["failed"] > len([1 for c in res["compared"].values()
                                if c["value"] > c["limit"]])


@pytest.mark.parametrize("cell", CELLS[:2])
def test_control_is_not_correct(capsys, cell):
    """The reference with keys held in 32 bits, in the program's place,
    fails the cell's comparison on every seed."""
    assert control.main(["--workload", cell, "--seeds", "5", "6",
                         "--device", "cpu"], cfg_patch=MEDIUM) == 0
    for line in capsys.readouterr().out.strip().splitlines():
        assert json.loads(line)["control_correct"] is False


def test_repeated_outputs_are_kept_and_judged_once(capsys, monkeypatch):
    """Jobs that write the same container share its chunks; a job whose
    output differs keeps its own and is judged on it."""
    from benchmark.jobs import kmerize as J
    first = J.Sink()
    for b in (b"ZKF1", b"hdr", b"keys"):
        first.write(bytes(b))
    again, other = J.Sink(first.chunks), J.Sink(first.chunks)
    for b in (b"ZKF1", b"hdr", b"keys"):
        again.write(bytes(b))
    for b in (b"ZKF1", b"hdr", b"KEYS"):
        other.write(bytes(b))
    assert all(a is b for a, b in zip(again.chunks, first.chunks))
    assert other.chunks[:2] == first.chunks[:2]
    assert other.chunks[2] is not first.chunks[2]
    judged = []
    job = J.Job.__new__(J.Job)
    monkeypatch.setattr(job, "_judge", lambda buf, *w: judged.append(buf)
                        or {"header_off": int(buf.endswith(b"KEYS"))},
                        raising=False)
    got = job.compare([first.chunks, again.chunks, other.chunks], (0, 0))
    assert judged == [b"ZKF1hdrkeys", b"ZKF1hdrKEYS"]
    assert [r["header_off"] for r in got] == [0, 0, 1]


def test_trace_splits_cards_and_names_gaps():
    from benchmark import devtrace
    t = devtrace.Trace.__new__(devtrace.Trace)
    t.lo, t.hi, t.indices = 0, 100, [0, 1]
    t.device = [(0, 10, 20, "void (anonymous namespace)::setop_kernel<2>"
                 "(long long const*)"), (0, 60, 70, "pack_wire_kernel"),
                (1, 0, 100, "Memcpy HtoD ")]
    t.busy_us = {0: devtrace._union([(10, 20), (15, 18), (60, 70)]),
                 1: [[0, 100]]}
    t.host = [(0, 50, "bench.kmerize"), (45, 50, "bench.container"),
              (55, 100, "bench.kmerize"), (30, 40, "aten::to"),
              (32, 35, "cudaMalloc"), (75, 80, "aten::sort")]
    assert (t.busy_s(0), t.busy_s(1)) == (2e-05, 1e-04)
    assert t.kernels(lambda n: n == "setop_kernel") == (1, 1e-05)
    gaps = t.idle_gaps()
    assert dict(gaps) == pytest.approx({
        "kmerize: python": 5.5e-05, "kmerize: aten::to": 1e-05,
        "container: python": 5e-06, "between jobs: python": 5e-06,
        "kmerize: aten::sort": 5e-06})
