"""sort_roofline (%), the sort (``torch.sort`` in ``kernels/sortdedup.py``):
the bytes a sort must move at the card's HBM peak, over the device time
of the CUB radix-sort kernels in the trace.

A sort of a batch's keys reads R x (L - k + 1) int64 keys once and writes
them sorted once: 16 B a key, 142,606,336 B for 65,536 x 160 at k=25.
The indices ``torch.sort`` also writes are not needed by the step and are
not counted; nor is the time of the kernel that fills them. One sort runs
for each K1a launch (a batch)."""

from benchmark import peaks


def sort_bytes(rows: int, max_len: int, k: int) -> int:
    return rows * (max_len - k + 1) * 16


def read(ctx):
    t, c = ctx.trace, ctx.cfg
    if t is None:
        return None
    sorts, _ = t.kernels(lambda name: name == "pack_wire_kernel")
    _, seconds = t.kernels(lambda name: "radixsort" in name.lower())
    rows = c["batch_reads"]
    return peaks.roofline_percent(
        ctx, sorts * sort_bytes(rows, c["max_len"], c["k"]), seconds)
