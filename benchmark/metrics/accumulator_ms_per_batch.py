"""accumulator_ms_per_batch (ms), the accumulator
(``workloads/accumulator.py`` through K3, ``kernels/merge_fused.py``,
``csrc/merge.cu``: ``setop_partition_kernel``, ``setop_kernel``): the
device milliseconds of K3's kernels in the trace over the batches the
window's jobs parsed. K3's bytes depend on the data, so it has no
roofline until the program counts them."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.window.batches:
        return None
    n, seconds = t.kernels(lambda n: n in ("setop_partition_kernel",
                                           "setop_kernel"))
    return 1e3 * seconds / ctx.window.batches if n else None
