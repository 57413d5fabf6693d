"""inflate_gb_per_s (GB/s), the inflate (``io/bgzf.BgzfPipe``,
``io/fastq._ChunkPipe``): the bytes the window's gzip inputs inflated to
(the program's counter ``inflate.bytes_out``) over the wall seconds of the
inflate tasks, summed over the threads that ran them (``inflate.s``): the
inflate's rate for each second of a thread's time. It falls where the
inflate threads outnumber the cores. None where the program keeps no such
counters."""

from benchmark import program


def read(ctx):
    c = program.counters()
    if not c or not c.get("inflate.s") or "inflate.bytes_out" not in c:
        return None
    return c["inflate.bytes_out"] / c["inflate.s"] / 1e9
