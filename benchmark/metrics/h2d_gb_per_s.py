"""h2d_gb_per_s (GB/s), the upload (``workloads/kmerize.upload``,
``workloads/pulldown.panel_to_device``): the bytes the program uploads in
the window (its counter ``h2d.bytes``: each host tensor's ``nbytes``), over
the device seconds of the trace's host-to-device copies."""

from benchmark import program


def read(ctx):
    t, c = ctx.trace, program.counters()
    if t is None or not c or not c.get("h2d.bytes"):
        return None
    _, seconds = t.kernels(lambda name: "HtoD" in name)
    return c["h2d.bytes"] / seconds / 1e9 if seconds > 0 else None
