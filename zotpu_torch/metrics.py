"""Structured metrics / logging / observability.

Port of zotpu/metrics.py. Per-stage counters (reads, bases, k-mers emitted,
k-mers routed per shard, dedup ratio) logged as JSONL per host -- these
feed the BASELINE metrics (k-mers/s/chip, bases/s, routing skew). Also
wraps a ``torch.profiler`` trace around a workload step.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


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


@contextlib.contextmanager
def timed(logger: MetricsLogger | None, event: str, **fields):
    """Wall-clock a stage; caller must synchronize inside for device work."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.log(event, seconds=dt, **fields)


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
    import torch
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
