"""tree_roofline (%), the receive tree (``dist/shuffle.
merge_received_runs``): K5 (``kernels/merge_runs.py``) and K6
(``kernels/merge_dedup.py``), both in ``csrc/merge_runs.cu``. The bytes
their launches must move at the card's HBM peak, over the device time of
their kernels in the trace, summed over the cards.

- K5, a merge pass, reads and writes every slot once, sentinel pads
  included: 16 B a slot, 142,606,336 B at 8,912,896 slots (slot 0 of 4 at
  a 65,536 x 160 batch, k=25). The slots are the program's counter
  ``tree.k5_slots``.
- K6, the last level, reads each valid key once and writes each unique
  key and its int64 count once, and n_out (8 B): 60,068,760 B for
  3,605,244 valid keys in and 1,951,675 out (the kernel table in
  ``PERF.md``). The keys are the counters ``tree.k6_keys_in`` and
  ``tree.k6_keys_out``; the launches are the trace's
  ``merge_dedup_kernel`` events.

The time is that of K5's two kernels and K6's three: its partition, its
main kernel and the closing kernel it shares with K2
(``dedup_close_kernel``). K2 does not run in a step over more than one
slot, so in the cells that list this metric every closing kernel is
K6's."""

from benchmark import peaks, program

KERNELS = ("merge_runs_partition_kernel", "merge_runs_kernel",
           "merge_dedup_partition_kernel", "merge_dedup_kernel",
           "dedup_close_kernel")


def k5_bytes(slots: int) -> int:
    return 16 * slots


def k6_bytes(keys_in: int, keys_out: int, launches: int) -> int:
    return 8 * keys_in + 16 * keys_out + 8 * launches


def read(ctx):
    t, c = ctx.trace, program.counters()
    if t is None or not c or "tree.k5_slots" not in c:
        return None
    launches, _ = t.kernels(lambda name: name == "merge_dedup_kernel")
    _, seconds = t.kernels(lambda name: name in KERNELS)
    nbytes = k5_bytes(c["tree.k5_slots"]) + k6_bytes(
        c.get("tree.k6_keys_in", 0), c.get("tree.k6_keys_out", 0), launches)
    return peaks.roofline_percent(ctx, nbytes, seconds)
