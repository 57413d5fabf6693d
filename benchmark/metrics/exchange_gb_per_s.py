"""exchange_gb_per_s (GB/s), the exchange (``dist/mesh.Mesh.all_to_all``
under ``dist/shuffle._route``): the bytes the slots addressed to other
slots in the traced window (the program's counter ``exchange.bytes``) over
the device seconds of the trace's copies between cards (``Memcpy PtoP``
events), summed over the cards. None where no copy crossed a card (slots
on one device exchange by a transpose)."""

from benchmark import program


def read(ctx):
    t, c = ctx.trace, program.counters()
    if t is None or not c or not c.get("exchange.bytes"):
        return None
    _, seconds = t.kernels(lambda name: "PtoP" in name)
    return c["exchange.bytes"] / seconds / 1e9 if seconds > 0 else None
