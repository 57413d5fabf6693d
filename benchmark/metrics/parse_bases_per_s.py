"""parse_bases_per_s (bases/s), the host pipeline: the host iterator a job
drives (``io/fastq``, ``io/native``, ``io/wire``, ``io/prefetch`` through
``workloads/kmerize._iter_batches`` or ``workloads/pulldown.
_iter_scan_batches``), over the cell's own files with the job's own
arguments, drained alone with no device step, after the window. Bases
over its wall time."""

import time


def read(ctx):
    t = time.perf_counter()
    bases = ctx.job.host_pipeline()
    return bases / (time.perf_counter() - t)
