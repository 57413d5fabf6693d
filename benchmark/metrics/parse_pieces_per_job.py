"""parse_pieces_per_job (1), the host pipeline (``workloads/kmerize.
_iter_batches``, ``io/fastq.cut_fastq``): the pieces of ``batch_reads``
records that a job's plain FASTQ files were cut into, so that the parse
pool parses one file on several threads (the program's counter
``parse.pieces``; 0 where the pool takes whole files), per job of the
traced window. None where the program keeps no such counter."""

from benchmark import program


def read(ctx):
    c, jobs = program.counters(), len(ctx.window.jobs)
    if not c or "parse.pieces" not in c or not jobs:
        return None
    return c["parse.pieces"] / jobs
