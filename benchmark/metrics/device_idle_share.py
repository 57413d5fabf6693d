"""device_idle_share (1): 1 minus the share of the traced window in which a
card ran a kernel or a copy (the union of its device events), the mean
over the cell's cards."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.has_device_events() or not ctx.window.window_s:
        return None
    w = ctx.window.window_s
    return sum(1 - t.busy_s(i) / w for i in t.indices) / len(t.indices)
