"""join_roofline (%), kernel K4 (``kernels/join.py``, ``csrc/join.cu``:
``join_meta_kernel``, ``join_dir_kernel``, ``join_row_hits_kernel``): the
bytes a launch must move at the card's HBM peak, over the device time of
its kernels in the trace.

A launch over R rows of L bases at k reads one int64 key a window
(R x (L - k + 1)) and the panel, padded to a power of two (at least 8),
once, and writes R int32 row hits: 88,342,528 B for 65,536 x 160 at k=25
against 2,048,552 keys padded to 2^21. (The kernel table in ``PERF.md``
took the row hits as 8 B: 88,604,672.)"""

from benchmark import peaks

KERNELS = ("join_meta_kernel", "join_dir_kernel", "join_row_hits_kernel")


def padded(n: int) -> int:
    return max(1 << (n - 1).bit_length(), 8) if n else 8


def launch_bytes(rows: int, max_len: int, k: int, panel_keys: int) -> int:
    return rows * (max_len - k + 1) * 8 + padded(panel_keys) * 8 + rows * 4


def read(ctx):
    t, c = ctx.trace, ctx.cfg
    if t is None:
        return None
    launches, _ = t.kernels(lambda name: name == "join_row_hits_kernel")
    _, seconds = t.kernels(lambda name: name in KERNELS)
    nbytes = launch_bytes(c["batch_reads"], c["max_len"], c["k"],
                          len(ctx.job.inputs.panel))
    return peaks.roofline_percent(ctx, launches * nbytes, seconds)
