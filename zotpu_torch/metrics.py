"""Structured metrics / logging / observability.

Port of zotpu/metrics.py. Per-stage counters (reads, bases, k-mers emitted,
k-mers routed per shard, dedup ratio) logged as JSONL per host -- these
feed the BASELINE metrics (k-mers/s/chip, bases/s, routing skew). Also
wraps a ``torch.profiler`` trace around a workload step.

Spans and counters inside the program, for whoever runs a
``torch.profiler`` over it (``profiled``, the benchmark's traced runs):

- ``span(name)`` is a range ``zotpu.<name>`` in the profiler's trace, on
  the profiler's clock (the one the device events are on). Spans are
  recorded on the thread that opens them; a profiler that does not trace
  every thread sees only those of the thread that started it, so the
  workloads open them on the thread that drives the jobs.
- ``count(name, n)`` adds a host number; ``count_device(name, t)`` keeps a
  device tensor, with no host sync and no device work; ``counters()``
  sums them all, every element of each (one sync a device).

Both record only while a profiler is enabled, and cost one flag check
otherwise. ``count_load`` is the exception: a library loads once a
process, in set-up, before any profiler starts, so its seconds are
always kept.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time

import torch

#: Whether a profiler is enabled, the one check a span or counter makes
#: (about 0.1 us); a caller that must compute a count tests it first.
tracing = torch._C._autograd._profiler_enabled
# A range with no GPU-side annotation: a span is host time, and the device
# timeline keeps only the device's own work. The class is private to torch
# (there in 2.11 and 2.13; tests/test_torch_spans.py checks it); without it
# a span is a record_function range, which adds a device event of its name.
_Range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)
_NO_SPAN = contextlib.nullcontext()
SPAN_PREFIX = "zotpu."

_lock = threading.Lock()
_host: dict[str, float] = {}
_device: dict[str, list[torch.Tensor]] = {}


class MetricsLogger:
    """JSONL event logger; one file per host (or stderr)."""

    def __init__(self, path: str | None = None, host_id: int = 0):
        self.host_id = host_id
        self._fh = open(path, "a") if path else None

    def log(self, event: str, **fields) -> dict:
        rec = {"ts": time.time(), "host": self.host_id, "event": event, **fields}
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print(line, file=sys.stderr)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def span(name: str):
    """A context manager: the range ``zotpu.<name>`` while a profiler is
    enabled, else nothing."""
    return _Range(SPAN_PREFIX + name) if tracing() else _NO_SPAN


def count(name: str, n) -> None:
    """Add the host number ``n`` to counter ``name`` while a profiler is
    enabled."""
    if tracing():
        with _lock:
            _host[name] = _host.get(name, 0) + n


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the elements of the integer tensor ``t`` to counter ``name``
    while a profiler is enabled: it is kept, and ``counters()`` sums it,
    so the device does no work and the host does not wait for it here."""
    if tracing():
        with _lock:
            _device.setdefault(name, []).append(t)


def count_load(seconds: float, build_s: float) -> None:
    """A library's first load: its seconds, the build's included, to
    ``load.s``; the compiler's seconds to ``load.build_s`` (a checkout
    that holds the build compiles nothing). Always kept."""
    with _lock:
        _host["load.s"] = _host.get("load.s", 0.0) + seconds
        _host["load.build_s"] = _host.get("load.build_s", 0.0) + build_s


def counters() -> dict:
    """Every counter: {name: value}, a device counter summed over its
    devices."""
    with _lock:
        out = dict(_host)
        device = [(name, list(ts)) for name, ts in _device.items()]
    by_dev: dict = {}
    for name, ts in device:
        for t in ts:
            by_dev.setdefault(t.device, {}).setdefault(name, []).append(
                t.reshape(-1))
    for groups in by_dev.values():
        sums = torch.stack([torch.cat(g).sum() for g in groups.values()])
        for name, v in zip(groups, sums.tolist()):
            out[name] = out.get(name, 0) + v
    return out


def reset_counters() -> None:
    """Drop every counter, ``load.*`` included."""
    with _lock:
        _host.clear()
        _device.clear()


def _alloc_calls(devices) -> tuple[int, int]:
    return (sum(torch.cuda.memory_stats(d)["num_device_alloc"]
                for d in devices),
            torch.cuda.host_memory_stats()["num_host_alloc"])


def alloc_mark(*devices):
    """The allocators' calls into CUDA so far (``cudaMalloc`` summed over
    the distinct CUDA devices among ``devices``, pinned ``cudaHostAlloc``
    once, from any thread), while a profiler is enabled and one of
    ``devices`` is a CUDA device; else None."""
    cuda = list(dict.fromkeys(d for d in map(torch.device, devices)
                              if d.type == "cuda"))
    if tracing() and cuda:
        return cuda, _alloc_calls(cuda)
    return None


def count_allocs(mark) -> None:
    """Add the calls since ``alloc_mark`` to ``alloc.device`` and
    ``alloc.host``."""
    if mark is not None:
        devices, (d0, h0) = mark
        d1, h1 = _alloc_calls(devices)
        count("alloc.device", d1 - d0)
        count("alloc.host", h1 - h0)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiled(trace_dir: str | None, device=None):
    """torch.profiler trace around a workload step, written as a Chrome
    trace to ``trace_dir/trace.json`` (Perfetto or chrome://tracing).

    The CPU activity is always recorded, the CUDA activity when ``device``
    is a CUDA device. There it is required: a profiler that cannot trace
    the card, or a trace of a CUDA run that holds no device event, raises
    instead of writing a host-only trace."""
    if not trace_dir:
        yield
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_cuda = device is not None and torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU]
    if on_cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("--trace on cuda: this torch.profiler cannot "
                               "record CUDA activity")
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    # one cycle; acc_events keeps torch from warning that a later cycle
    # would clear this one's events
    with profile(activities=acts, acc_events=True) as prof:
        yield
        if on_cuda:
            torch.cuda.synchronize(device)
    if on_cuda and not any(e.device_type == DeviceType.CUDA
                           for e in prof.events()):
        raise RuntimeError("--trace on cuda: the profiler recorded no "
                           "device event")
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


def kmerize_stage_metrics(stats, wall_seconds: float, n_chips: int = 1) -> dict:
    """Derive the BASELINE headline numbers from kmerize Stats."""
    out = {
        "bases_per_s": stats.bases / wall_seconds if wall_seconds else 0.0,
        "kmers_per_s_per_chip": (stats.kmers / wall_seconds / n_chips
                                 if wall_seconds else 0.0),
        "dedup_ratio": stats.unique / stats.kmers if stats.kmers else 0.0,
        "reads": stats.reads, "bases": stats.bases,
        "kmers": stats.kmers, "unique": stats.unique,
        "n_chips": n_chips,
    }
    routed = getattr(stats, "routed_per_shard", None)
    if routed:
        mean = sum(routed) / len(routed)
        out["routed_per_shard"] = routed
        out["routing_skew"] = max(routed) / mean if mean else 0.0
    return out
