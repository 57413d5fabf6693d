"""parse_wait_share (1), the host pipeline (``io/prefetch.py``): the
seconds the thread that drives the jobs waits for the next parsed batch
(the span ``zotpu.parse_wait`` around the prefetch queue's ``get``), as a
share of the traced window."""

from benchmark import program


def read(ctx):
    return program.span_share(ctx, "parse_wait")
