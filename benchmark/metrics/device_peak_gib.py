"""device_peak_gib (GiB): the allocator's peak
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the end of set-up) over the window, on the fullest of the cell's cards."""


def read(ctx):
    peak = max(ctx.peak_bytes)
    return peak / 2 ** 30 if peak else None
