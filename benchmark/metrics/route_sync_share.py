"""route_sync_share (1), the route (``dist/shuffle._route``): the seconds
of the span ``zotpu.route_sync``, the host's read of the flag that says
whether a batch takes the overflow second round (one host sync a batch
wherever the second round is on, which it is over more than one slot), as
a share of the traced window."""

from benchmark import program


def read(ctx):
    return program.span_share(ctx, "route_sync")
