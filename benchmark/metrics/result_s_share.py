"""result_s_share (1), the accumulator's tail (``workloads/kmerize.py``,
``DeviceAccumulator.result``): the seconds of the span ``zotpu.result``
(the last merges, the overflow check, the copy of the set to the host, its
count of k-mers), as a share of the traced window."""

from benchmark import program


def read(ctx):
    return program.span_share(ctx, "result")
