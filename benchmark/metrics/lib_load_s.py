"""lib_load_s (s), set-up: the program's share of ``setup_s`` that loads
its libraries, the first ``_build.lib()`` (the CUDA kernels) and the first
``io/native.get_lib()`` (the C++ FASTQ parser): the program's counter
``load.s`` less ``load.build_s``, the seconds nvcc and g++ compiled in it.
A run in a checkout with no build yet compiles both, one after it none,
so the compile is left out: the reading is the load alone."""

from benchmark import program


def read(ctx):
    c = program.counters()
    if not c or "load.s" not in c:
        return None
    return c["load.s"] - c.get("load.build_s", 0.0)
