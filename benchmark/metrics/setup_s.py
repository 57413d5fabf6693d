"""setup_s (s): from the start of the run's process to the start of the
window: imports, the CUDA contexts, the inputs made from the seed and
written, the kernels' build or load, and the warm-up job."""


def read(ctx):
    return ctx.setup_s
