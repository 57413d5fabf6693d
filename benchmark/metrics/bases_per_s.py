"""bases_per_s (bases/s): the input bases of every job completed in the
window over the window's wall time, from the first job's start to the end
of the first job that ends ``--seconds`` or more after it."""


def read(ctx):
    w = ctx.window
    return w.bases / w.window_s if w.bases else None
