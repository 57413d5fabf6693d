"""alltoall_bytes_per_base (B/base), the exchange (``dist/mesh.Mesh.
all_to_all`` under ``dist/shuffle._route``): the bytes of the all-to-all
rows that the slots addressed to other slots in the traced window (the
program's counter ``exchange.bytes``, by the arithmetic of
``mesh.slot_bytes``), over the input bases of the window's jobs.

Every bucket ships at its capacity, sentinel pads included: over 4 slots,
65,536 x 160 batches at k=25 and a capacity factor of 4, a batch ships
4 senders x 4 buckets x 2,228,224 slots x 8 B x 3/4 = 213,909,504 B (the
second round, where it runs, adds a quarter), and a 16-file run of 16
batches 24.58 B a base. The valid keys need about 5 B a base."""

from benchmark import program


def batch_bytes(slots: int, bucket: int, key_bytes: int = 8) -> int:
    """Bytes one exchange of ``slots`` senders' (slots, bucket) buffers
    ships to other slots."""
    return slots * slots * bucket * key_bytes * (slots - 1) // slots


def read(ctx):
    c, bases = program.counters(), ctx.window.bases
    if not c or "exchange.bytes" not in c or not bases:
        return None
    return c["exchange.bytes"] / bases
