"""What the program records of itself, for the per-layer readers: the time
in its spans (``zotpu_torch.metrics.span``, ranges named ``zotpu.<name>``
in the trace) and its counters (``zotpu_torch.metrics.counters``). The
program counts only while a profiler runs, so in a traced run its
counters cover the window (its library loads excepted: they are kept from
the start of the process). A program that records neither gives None."""

SPAN_PREFIX = "zotpu."


def span_share(ctx, name: str):
    """Seconds in the program's spans ``name`` on the driving thread,
    clipped to the traced window, as a share of it; None where the trace
    holds no such span."""
    t = ctx.trace
    if t is None or t.lo is None or t.hi <= t.lo:
        return None
    full = SPAN_PREFIX + name
    spans = [(a, b) for a, b, n in t.host if n == full]
    if not spans:
        return None
    return sum(max(0.0, min(b, t.hi) - max(a, t.lo))
               for a, b in spans) / (t.hi - t.lo)


def counters():
    """The program's counters, {name: number}; None where it keeps none."""
    from zotpu_torch import metrics
    read = getattr(metrics, "counters", None)
    return read() if read is not None else None
