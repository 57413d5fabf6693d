"""dedup_roofline (%), kernel K2 (``kernels/sortdedup.py``,
``csrc/dedup.cu``: ``dedup_kernel``, then ``dedup_close_kernel``): the
bytes its launches must move at the card's HBM peak, over the device time
of both kernels in the trace.

A launch reads each sorted int64 key once, writes each unique key and its
int64 count once, and writes n_unique (8 B): 142,667,800 B for 8,912,896
keys in and 4,460,289 out (the kernel table in ``PERF.md``). The keys are
the program's counters ``dedup.keys_in`` and ``dedup.keys_out``, summed
over the window; the launches are the trace's ``dedup_kernel`` events."""

from benchmark import peaks, program

KERNELS = ("dedup_kernel", "dedup_close_kernel")


def launch_bytes(keys_in: int, keys_out: int, launches: int) -> int:
    return 8 * keys_in + 16 * keys_out + 8 * launches


def read(ctx):
    t, c = ctx.trace, program.counters()
    if t is None or not c or "dedup.keys_in" not in c:
        return None
    launches, _ = t.kernels(lambda name: name == "dedup_kernel")
    _, seconds = t.kernels(lambda name: name in KERNELS)
    return peaks.roofline_percent(
        ctx, launch_bytes(c["dedup.keys_in"], c["dedup.keys_out"],
                          launches), seconds)
