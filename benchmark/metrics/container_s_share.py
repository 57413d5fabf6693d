"""container_s_share (1), the container layer (``io/container.py``): the
seconds in the window spent in the job's container call (``write_stream``
of the result, or ``read`` of the scan's panel), as a share of the
window."""


def read(ctx):
    w = ctx.window
    spent = sum(b - a for name, a, b in w.spans if name == "container")
    return spent / w.window_s if spent and w.window_s else None
