"""What a ``torch.profiler`` trace of the window says: each card's busy
time, device time by kernel, and the idle gaps by what the host did.

``busy`` is a copy of ``chip_smoke.device_timeline`` (the union of a
card's kernel and copy intervals), split by device index: the original
merges every card's events into one union, which on four cards counts a
moment in which any card works as a moment in which all do. ``kernel_fn``
is a copy of ``chip_smoke.kernel_fn``.
"""

from __future__ import annotations

import re

import numpy as np

WINDOW_SPAN = "bench.window"
SPAN_PREFIX = "bench."
TOP = 10
NAMED_GAPS = 200


def kernel_fn(name: str) -> str:
    """A kernel event's demangled signature -> the function's own name,
    e.g. "void (anonymous namespace)::setop_kernel<2>(long long const*,
    ...)" -> "setop_kernel"."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name.split("(")[0].split("<")[0].split("::")[-1]


def _union(intervals):
    """Sorted disjoint union of (lo, hi) intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class Trace:
    """The device and host events of one profiled window (microseconds on
    the profiler's clock)."""

    def __init__(self, prof, devices):
        from torch.autograd import DeviceType
        evs = list(prof.events())
        win = [e for e in evs if e.name == WINDOW_SPAN]
        self.lo = min(e.time_range.start for e in win) if win else None
        self.hi = max(e.time_range.end for e in win) if win else None
        # the benchmark's own spans also show on the device timeline, as
        # annotations: they are not device work
        self.device = [(e.device_index, e.time_range.start,
                        e.time_range.end, e.name) for e in evs
                       if e.device_type == DeviceType.CUDA
                       and not e.name.startswith(SPAN_PREFIX)]
        self.host = [(e.time_range.start, e.time_range.end, e.name)
                     for e in evs if e.device_type == DeviceType.CPU
                     and e.name != WINDOW_SPAN]
        self.indices = sorted({d.index or 0 for d in devices
                               if d.type == "cuda"})
        self.busy_us = {i: _union((lo, hi) for d, lo, hi, _ in self.device
                                  if d == i) for i in self.indices}

    def longest_host_ops(self, n: int = 8) -> list:
        """[name, seconds] of the ``n`` longest host operations."""
        ops = [h for h in self.host if not h[2].startswith(SPAN_PREFIX)]
        return [[name, (b - a) / 1e6] for a, b, name in sorted(
            ops, key=lambda h: h[0] - h[1])[:n]]

    def has_device_events(self) -> bool:
        return bool(self.device)

    def busy_s(self, index: int) -> float:
        """Seconds in the window in which card ``index`` ran anything."""
        lo, hi = ((self.lo, self.hi) if self.lo is not None
                  else (float("-inf"), float("inf")))
        return sum(max(0.0, min(b, hi) - max(a, lo))
                   for a, b in self.busy_us[index]) / 1e6

    def kernels(self, match) -> tuple[int, float]:
        """(events, device seconds) of the kernels whose short name
        ``match`` accepts, over every card."""
        hit = [hi - lo for _, lo, hi, name in self.device
               if match(kernel_fn(name))]
        return len(hit), sum(hit) / 1e6

    def device_ops(self) -> list:
        """[short name, device seconds summed over the cards], longest
        first."""
        rows = {}
        for _, lo, hi, name in self.device:
            rows[kernel_fn(name)] = rows.get(kernel_fn(name), 0.0) + (
                hi - lo) / 1e6
        return sorted(([n, s] for n, s in rows.items()),
                      key=lambda r: -r[1])[:TOP]

    def idle_gaps(self) -> list:
        """[what the host did, idle seconds], longest first, over the
        ``NAMED_GAPS`` longest idle gaps of each card in the window. Each
        moment of a gap goes to the benchmark's innermost span around it
        ("between jobs" outside every span) and to the outermost host
        operation running then, or to "python" where none is (the host
        in no recorded operation: parsing, or waiting for the parse).
        """
        if self.lo is None:
            return []
        spans = [h for h in self.host if h[2].startswith(SPAN_PREFIX)]
        tops = []
        for a, b, name in sorted(h for h in self.host
                                 if not h[2].startswith(SPAN_PREFIX)):
            if not tops or a >= tops[-1][1]:
                tops.append((a, b, name))
        starts = np.array([t[0] for t in tops], np.float64)
        ends = np.array([t[1] for t in tops], np.float64)
        rows = {}

        def add(name, us):
            rows[name] = rows.get(name, 0.0) + us / 1e6

        for i in self.indices:
            gaps, prev = [], self.lo
            for a, b in self.busy_us[i] + [[self.hi, self.hi]]:
                a, b = max(a, self.lo), min(b, self.hi)
                if a > prev:
                    gaps.append((prev, a))
                prev = max(prev, b)
            gaps.sort(key=lambda g: g[0] - g[1])
            for g_lo, g_hi in gaps[:NAMED_GAPS]:
                # cut the gap where a span starts or ends inside it
                cuts = sorted({g_lo, g_hi} | {x for sp in spans
                                              for x in sp[:2]
                                              if g_lo < x < g_hi})
                for lo, hi in zip(cuts, cuts[1:]):
                    mid = (lo + hi) / 2
                    inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
                    where = (min(inner, key=lambda sp: sp[1] - sp[0])[2]
                             [len(SPAN_PREFIX):] if inner
                             else "between jobs")
                    covered = 0.0
                    for a, b, name in tops[
                            np.searchsorted(ends, lo, "right"):
                            np.searchsorted(starts, hi)]:
                        over = min(b, hi) - max(a, lo)
                        if over > 0:
                            add(f"{where}: {name}", over)
                            covered += over
                    add(f"{where}: python", hi - lo - covered)
        return sorted(([n, s] for n, s in rows.items()),
                      key=lambda r: -r[1])[:TOP]
