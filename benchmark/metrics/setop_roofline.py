"""setop_roofline (%), kernel K3 (``kernels/merge_fused.py``,
``csrc/merge.cu``: ``setop_partition_kernel``, ``setop_kernel``) as the
set ops run it: the bytes its launches must move at the card's HBM peak,
over the device time of both kernels in the trace.

What a launch must move depends on its op. Each valid key of both sides is
read once (8 B); a union reads every count too (8 B a key in) and writes
each key and count of the result (16 B a key out); an intersect reads the
counts of the keys it keeps on both sides and writes them (32 B a key
out); a diff reads A's count of each key it keeps and writes it (24 B a
key out); jaccard's launch is an intersect. Every launch reads n_a and n_b
and writes n_out (24 B). At 2^24 + 2^24 disjoint random keys (the kernel
table in ``PERF.md``): union 1,073,741,848 B, intersect 268,435,480 B,
diff 671,088,664 B. The keys are the program's counters
``setop.<op>.keys_in`` and ``setop.<op>.keys_out``, summed over the
window; the launches are the trace's ``setop_kernel`` events."""

from benchmark import peaks, program

KERNELS = ("setop_partition_kernel", "setop_kernel")
# (bytes a key in, bytes a key out) by op
PER_KEY = {"union": (16, 16), "intersect": (8, 32), "diff": (8, 24),
           "jaccard": (8, 32)}


def op_bytes(op: str, keys_in: int, keys_out: int) -> int:
    """What ``op``'s launches must move, less their 24 B a launch."""
    k_in, k_out = PER_KEY[op]
    return k_in * keys_in + k_out * keys_out


def launch_bytes(op: str, keys_in: int, keys_out: int,
                 launches: int) -> int:
    return op_bytes(op, keys_in, keys_out) + 24 * launches


def read(ctx):
    t, c = ctx.trace, program.counters()
    if t is None or not c:
        return None
    nbytes = sum(op_bytes(op, c[f"setop.{op}.keys_in"],
                          c.get(f"setop.{op}.keys_out", 0))
                 for op in PER_KEY if f"setop.{op}.keys_in" in c)
    if not nbytes:
        return None
    launches, _ = t.kernels(lambda name: name == "setop_kernel")
    _, seconds = t.kernels(lambda name: name in KERNELS)
    return peaks.roofline_percent(ctx, nbytes + 24 * launches, seconds)
