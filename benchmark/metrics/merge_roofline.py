"""merge_roofline (%), kernel K3 (``kernels/merge_fused.py``,
``csrc/merge.cu``: ``setop_partition_kernel``, ``setop_kernel``) as the
accumulator runs it (op merge): the bytes its launches must move at the
card's HBM peak, over the device time of both kernels in the trace.

A merge reads each valid key and count of both sides once (16 B a key),
writes each key and count of the result once, and reads n_a and n_b and
writes n_out (24 B): 237,640,504 B at the kernel table's level-0 shape
(4,460,289 + 4,456,199 keys in, 5,936,042 out). The keys are the
program's counters ``merge.keys_in`` and ``merge.keys_out``, summed over
the window; the launches are the trace's ``setop_kernel`` events."""

from benchmark import peaks, program

KERNELS = ("setop_partition_kernel", "setop_kernel")


def launch_bytes(keys_in: int, keys_out: int, launches: int) -> int:
    return 16 * keys_in + 16 * keys_out + 24 * launches


def read(ctx):
    t, c = ctx.trace, program.counters()
    if t is None or not c or "merge.keys_in" not in c:
        return None
    launches, _ = t.kernels(lambda name: name == "setop_kernel")
    _, seconds = t.kernels(lambda name: name in KERNELS)
    return peaks.roofline_percent(
        ctx, launch_bytes(c["merge.keys_in"], c["merge.keys_out"],
                          launches), seconds)
