"""Hash-space-sharded kmerize and pulldown steps over a mesh of device slots.

Port of zotpu/dist/shuffle.py (dist/mesh.py: one process, or P processes
of L slots each). Each slot owns a contiguous range of the 2k-bit key
space selected by the top p = log2(D) key bits (prefix sharding), or by
the top bits of a 32-bit avalanche of the key (``shard_hash="mixed"``,
balanced under GC skew).
A step packs each slot's read rows (K1), sorts them so owners are
non-decreasing, fills fixed-capacity per-destination buckets, exchanges
them with the mesh's ``all_to_all`` (an overflow second round takes what a
first-round bucket could not hold), and merges the D received runs:

- kmerize: a merge tree of K5 passes whose last level is K6 (merge +
  dense dedup-compact), one dense (keys, counts, n) run per slot;
- pulldown: a K7 tree carrying each probe's global read-row id, then K4's
  tagged entry against the slot's panel row, then ``psum`` of the per-row
  hits over slots.

Keys are the port's int64 keys (keys.py); every received run is ascending
(the TPU's ``reverse_odd`` alternating direction is not kept), and
capacities are not rounded to a tile. A step takes and returns this
process's L slots, indexed globally where it matters (a slot's own entry
of the routed volumes, the read-row ids). This module imports no JAX: the
JAX module's numpy helpers ``gather_global`` and ``partition_panel`` are
copied here, not imported, and the multi-controller helpers
``hosts_prefix_ordered``, ``gather_local_rows`` and ``allgather_host_sets``
are ported on the mesh's collectives.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from zotpu_torch import metrics
from zotpu_torch import semantics as S
from zotpu_torch.dist.mesh import shard_bits
from zotpu_torch.kernels.join import row_hits_tagged
from zotpu_torch.kernels.merge_dedup import merge_dedup_pair, merge_dedup_pass
from zotpu_torch.kernels.merge_runs import merge_runs_pair, merge_runs_pass
from zotpu_torch.kernels.pack import pack_canonical, pack_canonical_wire
from zotpu_torch.kernels.sortdedup import dedup_compact
from zotpu_torch.keys import SENTINEL

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 tensors a in [0, 2**32): the 64-bit
    product could leave the signed range, so c is split into 16-bit
    halves and every partial product stays below 2**48."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def routing_mix32(hi, lo):
    """semantics.routing_mix32 on int64 tensors holding u32 words: a
    product combine, then murmur3's fmix32 finalizer, mod 2**32."""
    x = _mul32(hi, 0x9E3779B1) ^ _mul32(lo, 0x85EBCA77) ^ (lo >> 16)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _embed_bits(k: int, p: int) -> int | None:
    """Bit position, within the key's high 32-bit word, at which the p-bit
    mixed-routing owner is embedded: ``bits_hi = max(2k - 32, 0)``, the
    word's used bits. None when ``bits_hi + p > 31`` (the JAX rule, which
    kept an embedded key off the sentinel word); the caller then sorts by
    a separate mix channel. In int64 keys the owner sits at bit
    32 + bits_hi. With bits_hi + p <= 31 the embedded key stays below
    2**63; it could equal SENTINEL = 2**63 - 1 only for an all-ones key
    (the all-T k-mer) with owner D - 1 at bits_hi + p == 31, and an all-T
    k-mer is never canonical (its reverse complement, all-A, is 0)."""
    bits_hi = max(2 * k - 32, 0)
    if p > 0 and bits_hi + p <= 31:
        return bits_hi
    return None


def _mixed_owner_sort(keys, k: int, p: int, n_shards: int, payload=None):
    """Sort one slot's keys into owner-contiguous order for mixed sharding.

    Embeds the owner (the top p bits of the routing mix) above the key bits
    so ONE int64 sort groups by owner and key-sorts within each owner: every
    bucket is then an ascending run and the receive side keeps its merge
    tree. Sentinels route to the last slot. Returns (keys with the owner
    still embedded, owner, payload, True); strip with ``_strip_owner``
    after routing. When the owner does not fit, sorts by (mix, key) with
    two stable sorts and returns the plain keys and False: buckets are then
    mix-ordered, not key-sorted, and the receive side must sort."""
    sent = keys == SENTINEL
    mix = routing_mix32(keys >> 32, keys & _M32)
    eb = _embed_bits(k, p)
    if eb is not None:
        owner = torch.clamp(mix >> (32 - p), max=n_shards - 1)
        shift = 32 + eb
        ekeys = torch.where(sent, SENTINEL, keys | (owner << shift))
        ekeys, order = torch.sort(ekeys)
        owner = torch.clamp(ekeys >> shift, max=n_shards - 1)
        return ekeys, owner, None if payload is None else payload[order], True
    mix = torch.where(sent, _M32, mix)
    keys, o1 = torch.sort(keys)
    mix, o2 = torch.sort(mix[o1], stable=True)
    order = o1[o2]
    owner = torch.clamp(mix >> (32 - p), max=n_shards - 1)
    return (keys[o2], owner, None if payload is None else payload[order],
            False)


def _strip_owner(rkeys, k: int, p: int):
    """Clear embedded owner bits from routed keys (sentinels preserved)."""
    eb = _embed_bits(k, p)
    if eb is None or p == 0:
        return rkeys
    keep = SENTINEL ^ (((1 << p) - 1) << (32 + eb))
    return torch.where(rkeys == SENTINEL, SENTINEL, rkeys & keep)


def _owner_of(keys, k: int, p: int, n_shards: int):
    """Top p bits of the 2k-bit key -> owner slot (int64); sentinels clamp
    to the last slot (they carry no weight)."""
    if p == 0:
        return torch.zeros_like(keys)
    return torch.clamp(keys >> (2 * k - p), max=n_shards - 1)


class Routed(NamedTuple):
    """_route's result, one entry per slot: the received keys (D runs of
    capacity, then D runs of capacity2 when ``need2``), the received
    payload (or None), the slot's overflow (valid keys that fit neither
    round), ``need2`` (a Python bool: some sender overflowed its first
    round) and ``landed``, the (D,) count of this sender's valid keys that
    landed in each destination's buckets."""
    keys: list
    pay: list | None
    overflow: list
    need2: bool
    landed: list


def _fill(x, starts, sizes, offset: int, cap_r: int, fillv: int):
    """(D, cap_r) send buffer: bucket d holds x[starts[d] + offset :] up to
    the end of d's contiguous segment, then fillv."""
    m = x.shape[0]
    j = torch.arange(cap_r, device=x.device)
    idx = torch.clamp(starts[:, None] + (offset + j)[None, :], max=m)
    xp = torch.cat([x, x.new_full((1,), fillv)])
    live = j[None, :] < (sizes[:, None] - offset)
    return torch.where(live, xp[idx], fillv)


def _route(mesh, keys, k: int, capacity: int, payload=None,
           capacity2: int = 0, owners=None) -> Routed:
    """Owner-route each slot's sorted keys into (D, capacity) buckets and
    exchange them (``shuffle._route``).

    ``keys[i]`` is slot i's int64 keys, sorted so that the owner is
    non-decreasing: by key for the prefix owner, or as
    ``_mixed_owner_sort`` leaves them with ``owners`` given. Bucket d of a
    sender is the contiguous slice of its rows owned by d; valid rows form
    a prefix (sentinels sort last), so per-destination valid counts are
    clamped range lengths. ``capacity2 > 0`` enables the overflow second
    round: rows beyond a bucket's first capacity go into a second (D,
    capacity2) exchange. It runs iff some sender's first round left a
    valid row behind; that flag is read on the host, one sync per call
    (JAX's ``lax.cond`` on the replicated ``psum``), in the span
    ``route_sync``. Every sender's ``landed`` goes to the counter
    ``exchange.valid_keys`` (the keys a slot routes to itself included)."""
    D = mesh.size
    p = shard_bits(D)
    plans = []
    for i, x in enumerate(keys):
        own = owners[i] if owners is not None else _owner_of(x, k, p, D)
        n_valid = (x != SENTINEL).sum()
        starts = torch.searchsorted(own, torch.arange(D, device=x.device))
        ends = torch.cat([starts[1:], starts.new_full((1,), x.shape[0])])
        v_dest = torch.minimum(ends, n_valid) - torch.minimum(starts, n_valid)
        plans.append((starts, ends - starts, v_dest, n_valid))

    def exchange(offset: int, cap_r: int):
        rk = mesh.all_to_all([_fill(x, st, sz, offset, cap_r, SENTINEL)
                              for x, (st, sz, _, _) in zip(keys, plans)])
        rp = None if payload is None else mesh.all_to_all(
            [_fill(y, st, sz, offset, cap_r, 0)
             for y, (st, sz, _, _) in zip(payload, plans)])
        return rk, rp

    rkeys, rpay = exchange(0, capacity)
    n_ok = [torch.clamp(v, max=capacity).sum() for _, _, v, _ in plans]
    need2 = False
    if capacity2 > 0:
        left = mesh.psum([pl[3] - ok for pl, ok in zip(plans, n_ok)])[0]
        with metrics.span("route_sync"):
            need2 = bool(left > 0)
    if need2:
        rk2, rp2 = exchange(capacity, capacity2)
        rkeys = [torch.cat([a, b]) for a, b in zip(rkeys, rk2)]
        if rpay is not None:
            rpay = [torch.cat([a, b]) for a, b in zip(rpay, rp2)]
        n_ok = [ok + torch.clamp(v - capacity, min=0, max=capacity2).sum()
                for ok, (_, _, v, _) in zip(n_ok, plans)]
    overflow = [pl[3] - ok for pl, ok in zip(plans, n_ok)]
    landed = [torch.clamp(v, max=capacity + capacity2)
              for _, _, v, _ in plans]
    if metrics.tracing():
        for x in landed:
            metrics.count_device("exchange.valid_keys", x)
    return Routed(rkeys, rpay, overflow, need2, landed)


def merge_received_runs(rkeys, n_shards: int, cap: int, cap2: int,
                        dedup: bool = False):
    """Receive-side merge tree of one slot (``shuffle.merge_received_runs``).

    ``rkeys`` is [n_shards ascending runs of cap | n_shards of cap2],
    sentinel-padded. Tree passes run on K5; the first round's runs and the
    second round's runs form two subtrees that meet in one final pair.
    ``dedup=True`` makes the final level K6 and returns dense (ukeys,
    counts, n_unique) of capacity len(rkeys); otherwise returns the sorted
    keys."""
    n1 = n_shards * cap
    k1 = rkeys[:n1]
    if dedup and cap2 == 0 and n_shards == 1:
        return merge_dedup_pair(k1, cap)   # one run: an empty-B pair
    run = cap
    while run < n1:
        if dedup and cap2 == 0 and run * 2 >= n1:
            return merge_dedup_pass(k1, run)
        k1, _ = merge_runs_pass(k1, None, run)
        run *= 2
    if cap2 == 0:
        return k1
    k2 = rkeys[n1:]
    run = cap2
    while run < n_shards * cap2:
        k2, _ = merge_runs_pass(k2, None, run)
        run *= 2
    both = torch.cat([k1, k2])
    if dedup:
        return merge_dedup_pair(both, n1)
    return merge_runs_pair(both, None, n1)[0]


def merge_received_runs_tag(rkeys, rtag, n_shards: int, cap: int, cap2: int):
    """The receive-side merge tree with a payload channel
    (``shuffle.merge_received_runs_tag``): K7 passes over the first round's
    runs, over the second round's, then one K7 pair. Returns (keys, tags)
    ascending by key. Sentinel rows are bucket padding; their tags are
    never read."""
    n1 = n_shards * cap
    k1, t1 = rkeys[:n1], rtag[:n1]
    run = cap
    while run < n1:
        k1, t1 = merge_runs_pass(k1, t1, run)
        run *= 2
    if cap2 == 0:
        return k1, t1
    k2, t2 = rkeys[n1:], rtag[n1:]
    run = cap2
    while run < n_shards * cap2:
        k2, t2 = merge_runs_pass(k2, t2, run)
        run *= 2
    return merge_runs_pair(torch.cat([k1, k2]), torch.cat([t1, t2]), n1)


def _capacities(mesh, m_local: int, capacity_factor: float,
                second_round: bool) -> tuple[int, int]:
    cap = int(math.ceil(m_local * capacity_factor / mesh.size))
    return cap, ((cap + 3) // 4 if second_round else 0)


def _pack(inputs, k: int, wire: bool):
    return pack_canonical_wire(*inputs, k) if wire else pack_canonical(
        *inputs, k)


def _check_step(k: int, read_len: int, wire: bool, shard_hash: str):
    S.check_k(k)
    if wire and read_len % 32:
        raise ValueError(f"wire form needs 32 | read_len, got {read_len}")
    if shard_hash not in ("prefix", "mixed"):
        raise ValueError(f"unknown shard_hash {shard_hash!r}")


def make_kmerize_step(mesh, k: int, reads_per_chip: int, read_len: int,
                      capacity_factor: float = 2.0, second_round: bool = True,
                      wire: bool = False, shard_hash: str = "prefix",
                      force_second_round: bool = False):
    """The sharded kmerize step (``shuffle.make_kmerize_step``).

    Returns (step, cap_out). ``step(inputs)`` takes one tuple per local slot,
    (codes (R, L) u8, lengths) or with ``wire=True`` (packed, mask,
    lengths) on that slot's device, R = reads_per_chip, and returns one
    (ukeys, counts, n_unique, overflow, routed) tuple per slot: a dense
    sorted unique run of capacity at most ``cap_out`` with int64
    occurrence counts, 0-d int64 n_unique and overflow, and ``routed``,
    the valid keys the slot received. Concatenating the slots' dense
    prefixes gives the global set (sorted for prefix sharding).

    Every branch emits a dense run, so the JAX package's
    ``step_emits_dense`` is always true here: the tree (K5 then K6) when
    the received runs are key-sorted (prefix, or mixed with the owner
    embedded) and D > 1 or ``force_second_round``; otherwise ``torch.sort``
    (only where the buckets are not sorted runs: the mixed fallback) and
    K2. ``force_second_round`` enables the overflow round even at D = 1,
    so one slot can exercise the skew path with a capacity factor below 1.
    When no sender overflows, the second round is skipped and the run
    holds the first round's D * cap slots. ``step.second_rounds`` counts
    the calls that took the second round. The tree's last level, K6, takes
    every valid key the slot received, so that count goes to
    ``tree.k6_keys_in`` here: K6's wrapper sees only the capacity. The
    marked form (``compact=False``) and ``_bench_no_dedup`` are not
    ported."""
    _check_step(k, read_len, wire, shard_hash)
    D = mesh.size
    p = shard_bits(D)
    cap, cap2 = _capacities(mesh, reads_per_chip * (read_len - k + 1),
                            capacity_factor,
                            (second_round and D > 1) or force_second_round)
    mixed = shard_hash == "mixed" and p > 0
    tree_order_ok = not mixed or _embed_bits(k, p) is not None
    use_tree = tree_order_ok and (D > 1 or force_second_round)

    def step(inputs):
        keys, owners = [], []
        for inp in inputs:
            x = _pack(inp, k, wire)
            if mixed:
                x, own, _, _ = _mixed_owner_sort(x, k, p, D)
                owners.append(own)
            else:
                x = torch.sort(x).values
            keys.append(x)
        r = _route(mesh, keys, k, cap, capacity2=cap2,
                   owners=owners if mixed else None)
        step.second_rounds += r.need2
        routed = mesh.psum(r.landed)
        out = []
        for d, rk in enumerate(r.keys):
            received = routed[d][mesh.first + d]
            if mixed:
                rk = _strip_owner(rk, k, p)
            if D == 1 and cap2 == 0:
                # one bucket run: the sender's sorted array, as it is
                run = dedup_compact(rk)
            elif use_tree:
                run = merge_received_runs(rk, D, cap, cap2 if r.need2 else 0,
                                          dedup=True)
                metrics.count_device("tree.k6_keys_in", received)
            else:
                run = dedup_compact(torch.sort(rk).values)
            out.append((*run, r.overflow[d], received))
        return out

    step.second_rounds = 0
    return step, D * (cap + cap2)


def make_pulldown_step(mesh, k: int, reads_per_chip: int, read_len: int,
                       capacity_factor: float = 2.0, wire: bool = False,
                       shard_hash: str = "prefix"):
    """The sharded panel pulldown step (``shuffle.make_pulldown_step``,
    BASELINE config 5).

    ``step(inputs, panels)`` takes one input tuple per local slot (as in
    make_kmerize_step) and that slot's panel row (``partition_panel`` with
    the same ``shard_hash``, on the slot's device). Each window carries its
    global read-row id (global slot d's rows are d * R .. d * R + R - 1)
    through the routing. Each slot merges its received probes with K7 (row
    id as the payload) and counts its panel hits per row with K4's tagged
    entry; ``psum`` over all D slots gives every local slot the same
    (D * R,) int32 row hits.
    Returns (row hits per slot, overflow per slot). Where mixed routing
    cannot embed the owner the received probes are not key-sorted; K4's
    tagged entry needs no sorted probes, so they go to it unmerged (JAX's
    ``_join_xla`` fallback is not ported). ``step.second_rounds`` counts
    the calls that took the overflow round; ``step.routed_bytes_per_probe``
    is what one routed probe ships (its key and row id), read off the
    exchanged tensors of the last call."""
    _check_step(k, read_len, wire, shard_hash)
    D = mesh.size
    p = shard_bits(D)
    m_per_read = read_len - k + 1
    R_total = D * reads_per_chip
    cap, cap2 = _capacities(mesh, reads_per_chip * m_per_read,
                            capacity_factor, D > 1)
    mixed = shard_hash == "mixed" and p > 0
    use_stream = not mixed or _embed_bits(k, p) is not None

    def step(inputs, panels):
        keys, rids, owners = [], [], []
        for d, inp in enumerate(inputs, start=mesh.first):
            x = _pack(inp, k, wire)
            rid = torch.arange(d * reads_per_chip, (d + 1) * reads_per_chip,
                               device=x.device).repeat_interleave(m_per_read)
            if mixed:
                x, own, rid, _ = _mixed_owner_sort(x, k, p, D, payload=rid)
                owners.append(own)
            else:
                x, order = torch.sort(x)
                rid = rid[order]
            keys.append(x)
            rids.append(rid)
        r = _route(mesh, keys, k, cap, payload=rids, capacity2=cap2,
                   owners=owners if mixed else None)
        step.second_rounds += r.need2
        step.routed_bytes_per_probe = (r.keys[0].element_size()
                                       + r.pay[0].element_size())
        hits = []
        for d, (rk, rt) in enumerate(zip(r.keys, r.pay)):
            if mixed:
                rk = _strip_owner(rk, k, p)
            if use_stream:
                rk, rt = merge_received_runs_tag(rk, rt, D, cap,
                                                 cap2 if r.need2 else 0)
            hits.append(row_hits_tagged(panels[d], rk, rt, R_total))
        return mesh.psum(hits), r.overflow

    step.second_rounds = 0
    step.routed_bytes_per_probe = None
    return step


def gather_global(keys, counts, n_unique, reorder: bool = False):
    """Host-side: concatenate the slots' dense prefixes -> sorted u64 keys
    and u32 counts (``shuffle.gather_global``). ``keys``/``counts`` hold
    one int64 array per slot. Prefix sharding concatenates globally
    sorted; mixed sharding passes reorder=True for a final sort (keys are
    disjoint across slots, so no counts combine)."""
    keys_out, cnt_out = [], []
    for kd, cd, n in zip(keys, counts, n_unique):
        n = int(n)
        keys_out.append(np.asarray(kd[:n]).astype(np.uint64))
        cnt_out.append(np.asarray(cd[:n]).astype(S.COUNT_DTYPE))
    keys = np.concatenate(keys_out) if keys_out else np.empty(0, np.uint64)
    cnts = (np.concatenate(cnt_out) if cnt_out
            else np.empty(0, S.COUNT_DTYPE))
    if reorder and len(keys):
        order = np.argsort(keys, kind="stable")
        keys, cnts = keys[order], cnts[order]
    return keys, cnts


# Multi-controller: a step's outputs are already this process's slots'
# rows, so gathering them is gather_global over the local lists.
gather_local_rows = gather_global


def hosts_prefix_ordered(mesh) -> bool:
    """True when every process's slots are contiguous in the mesh AND the
    process ranges ascend with the process index: the layout in which
    gather_local_rows / allgather_host_sets concatenate prefix-sharded
    results already sorted (otherwise callers pass reorder=True)."""
    seen: dict[int, list[int]] = {}
    for i, p in enumerate(mesh.owners):
        seen.setdefault(p, []).append(i)
    prev_end = -1
    for p in sorted(seen):
        idxs = seen[p]
        if idxs != list(range(idxs[0], idxs[0] + len(idxs))):
            return False
        if idxs[0] <= prev_end:
            return False
        prev_end = idxs[-1]
    return True


def allgather_host_sets(mesh, keys, cnts, reorder: bool = False):
    """Combine every process's (u64 keys, u32 counts) into the global set
    on EVERY process. Slot key ranges are disjoint, so no counts combine;
    prefix sharding concatenates sorted (processes hold ascending slot
    ranges in process order), mixed passes reorder=True for a final stable
    sort. Keys and counts cross as int64 on the mesh's device."""
    dev = mesh.devices[0]
    both = torch.stack([torch.from_numpy(np.asarray(keys).astype(np.int64)),
                        torch.from_numpy(np.asarray(cnts).astype(np.int64))],
                       dim=1).to(dev)
    both = mesh.allgather(both).cpu().numpy()
    keys = both[:, 0].astype(np.uint64)
    cnts = both[:, 1].astype(S.COUNT_DTYPE)
    if reorder and len(keys):
        order = np.argsort(keys, kind="stable")
        keys, cnts = keys[order], cnts[order]
    return keys, cnts


def partition_panel(panel_keys: np.ndarray, k: int, n_shards: int,
                    panel_cap: int | None = None,
                    shard_hash: str = "prefix"):
    """Host-side: split a sorted panel into per-slot SENTINEL-padded int64
    rows (``shuffle.partition_panel``). Must use the same shard_hash as
    the pulldown step. Each row stays sorted (the stable owner sort keeps
    key order within an owner). Returns ((n_shards, cap) int64, cap)."""
    panel_keys = np.asarray(panel_keys, np.uint64)
    if shard_hash == "mixed":
        hi, lo = S.split_hi_lo(panel_keys)
        p = shard_bits(n_shards)
        mix = S.routing_mix32(hi, lo)
        owners = (np.minimum(mix >> np.uint32(32 - p),
                             np.uint32(n_shards - 1)).astype(np.int64)
                  if p else np.zeros(len(panel_keys), np.int64))
        order = np.argsort(owners, kind="stable")
        panel_keys, owners = panel_keys[order], owners[order]
    else:
        owners = S.shard_of_u64(k, shard_bits(n_shards), panel_keys)
    bounds = np.searchsorted(owners, np.arange(n_shards + 1))
    sizes = np.diff(bounds)
    cap = panel_cap or max(int(sizes.max()) if len(sizes) else 1, 8)
    rows = np.full((n_shards, cap), SENTINEL, np.int64)
    for d in range(n_shards):
        seg = panel_keys[bounds[d]:bounds[d + 1]]
        if len(seg) > cap:
            raise ValueError(f"panel shard {d} ({len(seg)}) exceeds "
                             f"capacity {cap}")
        rows[d, :len(seg)] = seg.astype(np.int64)
    return rows, cap
