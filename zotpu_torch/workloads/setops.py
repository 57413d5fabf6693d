"""Set-algebra workload wrappers (BASELINE configs 2 and 3).

Port of zotpu/workloads/setops.py. Every function takes and returns the
container's numpy form (sorted unique u64 keys, u32 counts); inside, keys
cross to the port's int64 form (keys.py), go up to the device, and through
the fused set-op kernel K3 (kernels/merge_fused.py) with the valid counts as
0-d device tensors. Only the dense prefix ``[:n_out]`` comes back.

Not carried over, because each bounds the TPU's compile count and the port
compiles nothing per shape: ``_pad_pow2`` (a set goes up at its own length)
and ``_pow2_cap`` (a slot's row is as long as its slice). The sort-based
``kernels/setops.cardinalities`` is one K3 ``intersect`` launch here, and
only its ``n_out`` crosses to the host.

The sharded forms run on a mesh of slots (dist/mesh.py): both inputs are
sorted, so key-prefix sharding is a contiguous slice per slot; slot d runs
K3 on its slice of both sets on its own device, the outputs concatenate
already globally sorted, and the cardinalities come from the summed |A|,
|B| and n_out, read with one transfer. In a multi-controller run
``set_op_sharded_stream`` builds only this process's slots' rows from the
shared files, sums the cardinalities over the processes and returns this
process's rows; the caller gathers the process sets
(``shuffle.allgather_host_sets``).
"""

from __future__ import annotations

import numpy as np
import torch

from zotpu_torch import keys as K
from zotpu_torch import semantics as S
from zotpu_torch.dist.mesh import shard_bits
from zotpu_torch.io import container
from zotpu_torch.kernels.merge_fused import set_op_fused
from zotpu_torch.workloads.accumulator import to_host
from zotpu_torch.workloads.kmerize import sharded_mesh


def _upload(keys, counts, device):
    """(u64 keys, u32 counts or None) -> a dense device entry (int64 keys,
    int64 counts, n as a 0-d int64 tensor)."""
    k, c = K.from_numpy_set(keys, counts, device)
    return k, c, torch.tensor(k.shape[0], dtype=torch.int64, device=device)


def _download(parts):
    """Per-slot (keys, counts, n) with n a host int -> concatenated (u64
    keys, u32 counts) of the dense prefixes, through one pinned buffer."""
    host = to_host([k[:n] for k, _, n in parts] + [c[:n] for _, c, n in parts])
    host = [t.numpy() for t in host]
    D = len(parts)
    return (np.concatenate(host[:D]).astype(np.uint64),
            np.concatenate(host[D:]).astype(S.COUNT_DTYPE))


def set_op(a: tuple[np.ndarray, np.ndarray], b: tuple[np.ndarray, np.ndarray],
           op: str, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Device set op between two sorted unique (keys u64, counts u32) pairs:
    one K3 launch on the whole sets."""
    ka, ca, na = _upload(*a, device)
    kb, cb, nb = _upload(*b, device)
    keys, counts, n = set_op_fused(ka, ca, kb, cb, op, n_a=na, n_b=nb)
    return _download([(keys, counts, int(n))])


def merge_tree_device(runs: list[tuple[np.ndarray, np.ndarray]],
                      device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Pairwise device merge tree over sorted runs (counts saturate): the
    reference's pairing order, an odd run carried to the next level. A run
    goes up when its first merge needs it, the levels stay on the device,
    and the result crosses to the host once."""
    if not runs:
        return np.empty(0, np.uint64), np.empty(0, S.COUNT_DTYPE)
    if len(runs) == 1:
        return runs[0]
    level = list(runs)

    def entry(x):
        return x if len(x) == 3 else _upload(*x, device)

    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            (ka, ca, na), (kb, cb, nb) = entry(level[i]), entry(level[i + 1])
            nxt.append(set_op_fused(ka, ca, kb, cb, "merge", n_a=na, n_b=nb))
            level[i] = level[i + 1] = None      # free the merged inputs
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    keys, counts, n = level[0]
    return _download([(keys, counts, int(n))])


def _cards(na: int, nb: int, n_out: int, op: str) -> dict:
    """{a, b, intersect, union, jaccard} from the op's own output size:
    n_out = |A|+|B|-|A^B| for union/merge, |A^B| for intersect, |A|-|A^B|
    for diff."""
    n_int = {"merge": na + nb - n_out, "union": na + nb - n_out,
             "intersect": n_out, "diff": na - n_out}[op]
    n_uni = na + nb - n_int
    return {"a": na, "b": nb, "intersect": n_int, "union": n_uni,
            "jaccard": n_int / n_uni if n_uni else 0.0}


def jaccard(a_keys: np.ndarray, b_keys: np.ndarray, device="cuda") -> dict:
    """Similarity statistics from device cardinalities: one K3 ``intersect``
    with counts of one; only n_out crosses to the host."""
    ka, ca, na = _upload(a_keys, None, device)
    kb, cb, nb = _upload(b_keys, None, device)
    n = set_op_fused(ka, ca, kb, cb, "intersect", n_a=na, n_b=nb)[2]
    return _cards(len(a_keys), len(b_keys), int(n), "intersect")


# ---------------------------------------------------------------------------
# sharded set ops


def _prefix_edges(k: int, n_shards: int) -> np.ndarray:
    """The D-1 key values where slot ownership changes (key-prefix
    sharding: slot d owns keys in [edges[d-1], edges[d]))."""
    p = shard_bits(n_shards)
    return ((np.arange(1, n_shards, dtype=np.uint64)
             << np.uint64(2 * k - p)) if p else np.empty(0, np.uint64))


def _slot_bounds(keys, edges) -> np.ndarray:
    """D+1 offsets into one sorted key array: slot d holds
    [bounds[d], bounds[d+1])."""
    return np.concatenate([[0], np.searchsorted(keys, edges), [len(keys)]]
                          ).astype(np.int64)


def _partition_sorted_prefix(keys, counts, k: int, n_shards: int):
    """Split one sorted set into its D contiguous per-slot slices by key
    prefix: a list of (keys, counts or None) views. A slot's row is as long
    as its slice (an empty slice for a slot that owns no key)."""
    keys = np.asarray(keys, np.uint64)
    bounds = _slot_bounds(keys, _prefix_edges(k, n_shards))
    return [(keys[lo:hi], None if counts is None else counts[lo:hi])
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def _partition_cached(keys, counts, k: int, mesh, cache):
    """Device-resident partition of one sorted set, one dense (keys, counts,
    n) entry per slot on the slot's device, memoized across pairwise calls
    so that an N-way jaccard matrix partitions and uploads each set once.
    Keyed by array identity; the cache entry holds a reference to the
    arrays so their ids cannot be recycled while cached. ``counts=None``
    means all-ones (the jaccard form)."""

    def part():
        return [_upload(kd, cd, dev) for (kd, cd), dev in zip(
            _partition_sorted_prefix(keys, counts, k, mesh.size),
            mesh.devices)]

    if cache is None:
        return part()
    ck = (id(keys), None if counts is None else id(counts), k,
          tuple(str(d) for d in mesh.devices))
    hit = cache.get(ck)
    if hit is None:
        cache[ck] = hit = (keys, counts, part())
    return hit[2]


def _run_slots(mesh, rows_a, rows_b, op: str, gather: bool):
    """K3 per local slot on its rows of both sets; the per-slot n_out and
    the |A|, |B| and n_out summed over every slot of the mesh cross to the
    host in one transfer."""
    outs = [set_op_fused(ka, ca, kb, cb, op, n_a=na, n_b=nb)
            for (ka, ca, na), (kb, cb, nb) in zip(rows_a, rows_b)]
    dev0 = outs[0][2].device
    on0 = lambda ts: torch.stack([t.to(dev0) for t in ts])
    ns = on0([o[2] for o in outs])
    sums = mesh.allreduce(torch.stack([on0([r[2] for r in rows_a]).sum(),
                                       on0([r[2] for r in rows_b]).sum(),
                                       ns.sum()]))
    vals = torch.cat([ns, sums]).tolist()
    ns, (na, nb, n_out) = vals[:-3], vals[-3:]
    cards = _cards(na, nb, n_out, op)
    if not gather:
        return None, None, cards
    keys, counts = _download([(k, c, n) for (k, c, _), n in zip(outs, ns)])
    return keys, counts, cards


def set_op_sharded(a: tuple[np.ndarray, np.ndarray],
                   b: tuple[np.ndarray, np.ndarray], op: str, k: int,
                   n_shards: int, gather: bool = True,
                   cache: dict | None = None, device="cuda", devices=None
                   ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Key-prefix-sharded set op across ``n_shards`` device slots (the
    slots are ``devices`` when given, else n_shards slots of ``device``).

    Each slot runs K3 on its slice of both sets; outputs concatenate already
    globally sorted (disjoint prefix ranges) and equal the single-device
    ``set_op``. Returns (keys, counts, cards) with cards = the summed
    {a, b, intersect, union, jaccard} cardinalities, derived from the op's
    own output size (no second kernel).

    ``gather=False`` copies no result set and returns (None, None, cards):
    the form for cardinality-only queries (jaccard). ``cache`` (a plain
    dict the caller owns) memoizes each set's device partition across
    calls. A side's counts may be None (all-ones, the jaccard form)."""
    mesh = sharded_mesh(n_shards, device, devices)
    rows_a = _partition_cached(a[0], a[1], k, mesh, cache)
    rows_b = _partition_cached(b[0], b[1], k, mesh, cache)
    return _run_slots(mesh, rows_a, rows_b, op, gather)


def jaccard_sharded(a_keys: np.ndarray, b_keys: np.ndarray, k: int,
                    n_shards: int, cache: dict | None = None, device="cuda",
                    devices=None) -> dict:
    """Similarity from summed per-slot cardinalities: only the counts leave
    the mesh. ``cache`` makes an N-way matrix partition/upload each set
    once."""
    _, _, cards = set_op_sharded((a_keys, None), (b_keys, None), "intersect",
                                 k, n_shards, gather=False, cache=cache,
                                 device=device, devices=devices)
    return cards


def set_op_sharded_stream(path_a: str, path_b: str, op: str, n_shards: int,
                          chunk: int = 1 << 22, device="cuda", devices=None):
    """Sharded set op streamed straight from two container files.

    Two streaming passes per input (O(chunk) host memory each): pass 1
    counts per-slot rows by searchsorted on the key-prefix edges; pass 2
    fills ONE slot's row at a time and uploads it to its device when
    complete. The inputs are sorted, so slots complete in order and at
    most one partial row buffer is live. Peak host memory is O(largest row
    + chunk) per input, not O(set). In a multi-controller run every
    process reads both files and builds only its own slots' rows.

    Returns (k, keys, counts, cards): this process's slots' rows in slot
    order (the full sorted result under a single controller) and the
    cardinalities summed over every slot."""
    mesh = sharded_mesh(n_shards, device, devices)
    local = range(mesh.first, mesh.first + len(mesh.devices))

    def sizes_of(path):
        r = container.ChunkReader(path)
        edges = _prefix_edges(r.k, n_shards)
        sizes = np.zeros(n_shards, np.int64)
        for keys, _ in r.chunks(chunk):
            sizes += np.diff(_slot_bounds(keys, edges))
        return r.k, sizes

    def build(path, k, sizes):
        edges = _prefix_edges(k, n_shards)
        rows = [None] * n_shards
        live = None             # (slot, keys buffer, counts buffer, cursor)
        for keys, counts in container.ChunkReader(path).chunks(chunk):
            b = _slot_bounds(keys, edges)
            for d in local:
                m = int(b[d + 1] - b[d])
                if m == 0:
                    continue
                if live is None:
                    live = [d, np.empty(sizes[d], np.uint64),
                            None if counts is None
                            else np.empty(sizes[d], S.COUNT_DTYPE), 0]
                _, kbuf, cbuf, cur = live
                kbuf[cur:cur + m] = keys[b[d]:b[d + 1]]
                if cbuf is not None:
                    cbuf[cur:cur + m] = counts[b[d]:b[d + 1]]
                live[3] = cur + m
                if live[3] == sizes[d]:
                    rows[d] = _upload(kbuf, cbuf,
                                      mesh.devices[d - local.start])
                    live = None
        for d, dev in zip(local, mesh.devices):     # slots that saw no row
            if rows[d] is None:
                rows[d] = _upload(np.empty(0, np.uint64), None, dev)
        return rows[local.start:local.stop]

    ka, sa = sizes_of(path_a)
    kb, sb = sizes_of(path_b)
    if ka != kb:
        raise ValueError(f"K mismatch: {path_a} has k={ka}, {path_b} k={kb}")
    keys, counts, cards = _run_slots(mesh, build(path_a, ka, sa),
                                     build(path_b, kb, sb), op, True)
    return ka, keys, counts, cards
