"""allocs_per_job (1), the device allocator: the memory the caching
allocators took from CUDA in the traced window (``cudaMalloc`` calls for
the card, ``cudaHostAlloc`` for pinned host memory, from any thread; the
program's counters ``alloc.device`` and ``alloc.host``, taken where
``kmerize_paths`` and ``pulldown_paths`` enter and return), per job."""

from benchmark import program


def read(ctx):
    c, jobs = program.counters(), len(ctx.window.jobs)
    if not c or "alloc.device" not in c or not jobs:
        return None
    return (c["alloc.device"] + c["alloc.host"]) / jobs
