"""set_read_s_share (1), the set read (``io/container.read`` of both
files in ``workloads/setops.set_op_paths`` and ``jaccard_paths``): the
seconds in the program's span ``zotpu.set_read``, as a share of the traced
window."""

from benchmark import program


def read(ctx):
    return program.span_share(ctx, "set_read")
