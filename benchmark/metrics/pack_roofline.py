"""pack_roofline (%), kernel K1a (``kernels/pack.py``, ``csrc/pack.cu``
``pack_wire_kernel``): the bytes a launch must move at the card's HBM
peak, over the launches' device time in the trace.

A launch over R rows of L bases at k reads the wire words (R x L/16 u32),
the invalid mask (R x L/32 u32) and the lengths (R int32), and writes one
int64 key a window (R x (L - k + 1)): 75,497,472 B for 65,536 x 160 at
k=25 (the arithmetic of the kernel table in ``PERF.md``). R is the
configuration's batch."""

from benchmark import peaks


def launch_bytes(rows: int, max_len: int, k: int) -> int:
    return rows * (max_len // 16 * 4 + max_len // 32 * 4 + 4
                   + (max_len - k + 1) * 8)


def read(ctx):
    t, c = ctx.trace, ctx.cfg
    if t is None:
        return None
    n, seconds = t.kernels(lambda name: name == "pack_wire_kernel")
    rows = c["batch_reads"]
    return peaks.roofline_percent(
        ctx, n * launch_bytes(rows, c["max_len"], c["k"]), seconds)
