"""cpu_s_per_gbase (s/Gbase), the host process: its CPU seconds (user and
system, every thread: parse workers, the thread that drives the jobs,
CUDA's own) over the window, per 10^9 input bases of the window's jobs.
An end-to-end metric, read in the untraced run, so the profiler's own
host work is not in it."""


def read(ctx):
    w = ctx.window
    return w.cpu_s / (w.bases / 1e9) if w.bases else None
