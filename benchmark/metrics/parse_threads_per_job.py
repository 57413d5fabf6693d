"""parse_threads_per_job (1), the host pipeline (``workloads/feed.
batches``): the threads that parsed a job's input, summed over the feed's
calls (the program's counter ``parse.threads``: 1 on the serial path,
min(W, files) where the parse pool takes whole files, W where it cuts
pieces), per job of the traced window. None where the program keeps no
such counter."""

from benchmark import program


def read(ctx):
    c, jobs = program.counters(), len(ctx.window.jobs)
    if not c or "parse.threads" not in c or not jobs:
        return None
    return c["parse.threads"] / jobs
