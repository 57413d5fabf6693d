"""inflate_threads_per_job (1), the inflate (``io/bgzf.BgzfPipe``,
``io/fastq._ChunkPipe``): the threads that ran an inflate task for the
pipes of a job's gzip files (the program's counter ``inflate.threads``: at
most a BGZF file's pool size and its groups, 1 a plain gzip file), summed
over the files, per job of the traced window. None where the program keeps
no such counter."""

from benchmark import program


def read(ctx):
    c, jobs = program.counters(), len(ctx.window.jobs)
    if not c or "inflate.threads" not in c or not jobs:
        return None
    return c["inflate.threads"] / jobs
