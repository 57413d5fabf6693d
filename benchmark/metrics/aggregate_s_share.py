"""aggregate_s_share (1), the scan's aggregation
(``workloads/pulldown.RecordAggregator``): the seconds of the span
``zotpu.aggregate`` (each batch's row hits summed into its records, and
each sample's result), as a share of the traced window."""

from benchmark import program


def read(ctx):
    return program.span_share(ctx, "aggregate")
