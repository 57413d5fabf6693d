#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell is looked up in ``BENCHMARK.json``;
its configuration, traffic mix, job and metrics are files found by name
under ``benchmark/`` (see ``benchmark/__init__.py``).

One run: make the inputs from the seed on the first card, run one job to
warm every shape the cell uses (set-up ends here: ``setup_s``), then run
jobs one after another, a closed loop of one client, until a job ends
``--seconds`` or more after the first began: that is the window. With
``--trace 1`` the window runs under ``torch.profiler`` and the line holds
the cell's per-layer metrics; with ``--trace 0`` its end-to-end metrics.
After the window: the device's memory peak, the metrics, then the plain
reference (``benchmark/reference.py``) and the comparison of every job's
output with it, which decides ``correct``.

Exits 2 without a result where there is no CUDA device or fewer than the
cell's cards, or where the program (``zotpu_torch``) is not there; exits 3
without a result where a module of JAX or of the JAX package ``zotpu`` is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "zotpu"})
SPAN = "bench."
# a job whose answer never came (it raised): judged as an empty output
FAILED = {"bases": 0, "batches": 0, "output": []}


def load_module(path: str):
    """The Python file at ``path`` as a module (names may hold dots)."""
    name = "benchmark_file_" + os.path.basename(path)[:-3].replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """A cell of ``root/BENCHMARK.json`` with its configuration, traffic,
    job module and metrics, each found by its name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    cell = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic,
        job=load_module(os.path.join(bench, "jobs", traffic["job"] + ".py")),
        end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]),
        metrics_dir=os.path.join(bench, "metrics"))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_window(job, kind: str, seconds: float, trace: bool, devices):
    """Jobs in a closed loop until one ends ``seconds`` or more after the
    first began. Returns the window's record."""
    import torch
    spans = []

    @contextlib.contextmanager
    def span(name):
        t = time.perf_counter()
        with (torch.profiler.record_function(SPAN + name) if trace
              else contextlib.nullcontext()):
            yield
        spans.append((name, t, time.perf_counter()))

    acts = [torch.profiler.ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    jobs, error = [], None
    prof = (torch.profiler.profile(activities=acts) if trace
            else contextlib.nullcontext())
    with prof:
        with span("window"):
            cpu0 = os.times()
            t0 = time.perf_counter()
            while True:
                t = time.perf_counter()
                try:
                    with span(kind):
                        rec = job.run(span)
                except Exception:
                    error = traceback.format_exc()
                    rec = dict(FAILED)
                rec.update(start=t, end=time.perf_counter())
                jobs.append(rec)
                if error or rec["end"] - t0 >= seconds:
                    break
            t1 = time.perf_counter()
            cpu1 = os.times()
    return SimpleNamespace(
        jobs=jobs, error=error, window_s=t1 - t0,
        cpu_s=(cpu1.user + cpu1.system) - (cpu0.user + cpu0.system),
        bases=sum(r["bases"] for r in jobs),
        batches=sum(r["batches"] for r in jobs),
        spans=[s for s in spans if s[0] != "window"],
        prof=prof if trace else None)


def main(argv=None, *, root: str = ROOT, devices=None,
         cfg_patch: dict | None = None) -> int:
    """One run. ``devices`` and ``cfg_patch`` are for the tests: they skip
    the look for cards and shrink the configuration."""
    args = parse_args(argv)
    spec = load_cell(args.workload, root)
    if not os.path.isfile(os.path.join(ROOT, "zotpu_torch", "__init__.py")):
        say("error: the program (zotpu_torch) is not in this checkout")
        return 2
    import torch
    if devices is None:
        chips = spec.cell["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            say(f"error: the cell needs {chips} CUDA device(s); "
                f"is_available() is {torch.cuda.is_available()}, "
                f"device_count() is {torch.cuda.device_count()}")
            return 2
        devices = [torch.device("cuda", i) for i in range(chips)]
    from benchmark import devtrace, fixture
    from zotpu_torch.io import native
    on_cuda = devices[0].type == "cuda"
    cfg = {**spec.cfg, **(cfg_patch or {})}
    with tempfile.TemporaryDirectory(prefix="zotpu-bench-") as tmp:
        inputs = fixture.make_inputs(cfg, spec.traffic, args.seed,
                                     devices[0], tmp)
        job = spec.job.Job(cfg, inputs, devices)
        try:
            job.run(lambda name: contextlib.nullcontext())  # the warm-up
            warm_error = None
        except Exception:
            warm_error = traceback.format_exc()
        for d in devices if on_cuda else ():
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.perf_counter() - T0
        say(f"set-up {setup_s:.3f} s; FASTQ parser: {native.backend()}; "
            f"{inputs.bases} bases in {len(inputs.paths)} file(s)")
        if warm_error is None:
            win = run_window(job, spec.traffic["job"], args.seconds,
                             bool(args.trace), devices)
        else:                  # no window: the warm-up's answer is judged
            win = SimpleNamespace(
                jobs=[dict(FAILED)], error=warm_error, window_s=0.0,
                cpu_s=0.0, bases=0, batches=0, spans=[], prof=None)
        peaks = [torch.cuda.max_memory_allocated(d) if on_cuda else 0
                 for d in devices]
        trace = (devtrace.Trace(win.prof, devices) if win.prof is not None
                 else None)
        # what a metric's reader gets (benchmark/metrics/<name>.py)
        ctx = SimpleNamespace(
            cfg=cfg, job=job, setup_s=setup_s, window=win, trace=trace,
            peak_bytes=peaks,
            device_kind=(torch.cuda.get_device_name(devices[0]) if on_cuda
                         else "cpu"))
        metrics = {}
        for m in (spec.per_layer if args.trace else spec.end_to_end):
            reader = load_module(os.path.join(spec.metrics_dir,
                                              m["name"] + ".py"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if trace is not None:
            say(f"longest host operations (s): {trace.longest_host_ops()}")
        if win.error:
            say(f"a job raised:\n{win.error}")
        if on_cuda:
            torch.cuda.empty_cache()
        want = job.expected(devices[0])
        readings = job.compare([r["output"] for r in win.jobs], want)
    limits = spec.job.LIMITS
    worst = {n: max([r[n] for r in readings] or [0]) for n in limits}
    bad = sum(any(r[n] > limits[n] for n in limits) for r in readings)
    correct = win.error is None and bad == 0
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        say(f"error: modules of JAX or the JAX package are loaded: {found}")
        return 3
    device = {"platform": "gpu" if on_cuda else "cpu",
              "kind": ctx.device_kind, "count": len(devices),
              "memory_peak_bytes": max(peaks)}
    result = {"correct": correct, "attempted": len(win.jobs),
              "failed": bad,
              "metrics": metrics, "device": device}
    if trace is not None:
        busy = [trace.busy_s(i) for i in trace.indices]
        device["busy_s"] = sum(busy) / len(busy) if busy else 0.0
        device["window_s"] = win.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["compared"] = {n: {"value": worst[n], "limit": limits[n]}
                          for n in limits}
    say(f"{len(win.jobs)} job(s) in {win.window_s:.3f} s; correct: "
        f"{correct}")
    for n in limits:
        say(f"compared {n}: {worst[n]} (limit {limits[n]})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
