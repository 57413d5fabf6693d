"""The port's entry points: the counterpart of the repository's
``__graft_entry__.py``, on tensors with an explicit device.

- ``entry(device)``: the single-device kmerize step with its example
  arguments: 1,024 reads of 256 bases at k=25 through the pack kernel on
  u8 codes (K1b), ``torch.sort`` and the dense dedup-compact kernel (K2).
- ``dryrun_multichip(n_devices, devices)``: one step of every
  multi-device path on tiny shapes, each checked: the wire-packed
  prefix-routed kmerize step (K1a, the receive tree K5 then K6) with two
  adds to the sharded accumulator (the second a K3 level merge), the
  mixed-hash step with its re-sorting gather, the hash-sharded pulldown
  step (K7 tree, K4 tagged) and ``set_op_sharded`` against the one-device
  ``set_op`` (K3).

Both run on the card unless the caller asks for the CPU (``device="cpu"``,
``devices=["cpu"] * n``), where every wrapper runs its plain version. There
is no fallback: with no card, or fewer cards than asked for, they raise.
The JAX version's third block forces the TPU receive path onto a CPU mesh
through the Pallas interpreter; its counterpart here is the port's normal
path, since every sharded kmerize step emits the dense K5/K6 form.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from zotpu_torch.dist import mesh as M
from zotpu_torch.dist import shuffle
from zotpu_torch.io import wire
from zotpu_torch.kernels.pack import pack_canonical
from zotpu_torch.kernels.sortdedup import kmer_sort_dedup
from zotpu_torch.reference_impl import golden as G
from zotpu_torch.workloads import setops
from zotpu_torch.workloads.accumulator import ShardedAccumulator

ENTRY_K, ENTRY_READS, ENTRY_LEN = 25, 1024, 256
DRY_K, DRY_READS_PER_SLOT, DRY_LEN = 13, 4, 64
DRY_CAPACITY_FACTOR = 6.0
DRY_PANEL_SEQ = "ACGTACGTACGTACGTACGTACG"


class DryRunError(RuntimeError):
    """A check of ``dryrun_multichip`` failed."""


def _check(cond, what: str) -> None:
    if not cond:
        raise DryRunError(f"dry run: {what}")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the kernels' plain versions")
    return dev


def entry_inputs():
    """The example arguments as host arrays: (1024, 256) u8 codes drawn
    from ``default_rng(0)`` and full int32 lengths."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(ENTRY_READS, ENTRY_LEN)).astype(
        np.uint8)
    return codes, np.full(ENTRY_READS, ENTRY_LEN, np.int32)


def entry(device="cuda"):
    """(step, (codes, lengths)): ``step`` packs the reads (K1b) and
    returns the dense sorted (keys, counts, n_unique) of their canonical
    k-mers (``torch.sort``, then K2); the arguments live on ``device``."""
    dev = _device(device)
    codes, lengths = entry_inputs()

    def step(codes, lengths):
        return kmer_sort_dedup(pack_canonical(codes, lengths, ENTRY_K))

    return step, (torch.from_numpy(codes).to(dev),
                  torch.from_numpy(lengths).to(dev))


def dry_inputs(n_devices: int):
    """The dry run's reads as host arrays: (n_devices * 4, 64) u8 codes
    drawn from ``default_rng(1)`` and full int32 lengths; slot d holds
    rows 4d .. 4d + 3."""
    rows = n_devices * DRY_READS_PER_SLOT
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=(rows, DRY_LEN)).astype(np.uint8)
    return codes, np.full(rows, DRY_LEN, np.int32)


def _per_slot(mesh, arrays):
    """Host arrays of all rows -> one tuple per slot on its device."""
    R = DRY_READS_PER_SLOT
    return [tuple(torch.from_numpy(np.ascontiguousarray(a[d * R:(d + 1) * R]))
                  .to(dev) for a in arrays)
            for d, dev in enumerate(mesh.devices)]


def _gather(out, reorder=False):
    return shuffle.gather_global([o[0].cpu().numpy() for o in out],
                                 [o[1].cpu().numpy() for o in out],
                                 [int(o[2]) for o in out], reorder=reorder)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One step of every multi-device path over ``n_devices`` slots, with
    the JAX dry run's checks; raises ``DryRunError`` on a failed check.

    ``devices=None`` places the slots on the first ``n_devices`` visible
    cards and raises when fewer are visible; ``devices=["cuda:0"] * n``
    places n slots on one card, ``["cpu"] * n`` on the CPU. Returns the
    global (u64 keys, u32 counts) of the accumulator, the union's size,
    the sharded set op's cardinalities, the overflow totals, the bytes the
    mesh moved (``sent_bytes`` to other processes, ``slot_bytes`` between
    slots) and the wall seconds of each block and in all."""
    t_start = time.perf_counter()
    if devices is None:
        mesh = M.make_mesh(n_devices)
    else:
        for d in devices:
            _device(d)
        mesh = M.make_mesh(n_devices, devices=devices)
    D, k = mesh.size, DRY_K
    R, L = DRY_READS_PER_SLOT, DRY_LEN
    codes, lengths = dry_inputs(D)
    sent0, slot0 = M.sent_bytes(), M.slot_bytes()
    wall = {}

    # the wire-packed, prefix-routed step, then two adds to the sharded
    # accumulator: the second add merges level 0 (K3 on every slot)
    t0 = time.perf_counter()
    step, cap_out = shuffle.make_kmerize_step(
        mesh, k, R, L, capacity_factor=DRY_CAPACITY_FACTOR, wire=True)
    packed, mask = wire.pack_codes(codes)
    out = step(_per_slot(mesh, (packed.view(np.int32), mask.view(np.int32),
                                lengths)))
    overflow = {"prefix": sum(int(o[3]) for o in out)}
    step_keys, step_cnts = _gather(out)
    acc = ShardedAccumulator(mesh.devices, cap_out, mesh=mesh)
    for _ in range(2):
        acc.add([o[:3] for o in out])
    keys, cnts = shuffle.gather_global(*acc.result())
    _check(overflow["prefix"] == 0, f"prefix step overflowed "
           f"{overflow['prefix']} keys")
    _check(len(keys) == len(np.unique(keys)), "the global keys are unique")
    _check(np.array_equal(step_keys, keys)
           and np.array_equal(step_cnts.astype(np.uint64) * 2,
                              cnts.astype(np.uint64)),
           "the accumulator's counts are twice the single step's")
    wall["prefix_s"] = time.perf_counter() - t0

    # mixed-hash routing on u8 codes: slot ranges interleave in key space,
    # so the gather re-sorts
    t0 = time.perf_counter()
    mstep, _ = shuffle.make_kmerize_step(
        mesh, k, R, L, capacity_factor=DRY_CAPACITY_FACTOR,
        shard_hash="mixed")
    mout = mstep(_per_slot(mesh, (codes, lengths)))
    overflow["mixed"] = sum(int(o[3]) for o in mout)
    mkeys, mcnts = _gather(mout, reorder=True)
    _check(overflow["mixed"] == 0, f"mixed step overflowed "
           f"{overflow['mixed']} keys")
    _check(np.array_equal(mkeys, keys) and np.array_equal(mcnts, step_cnts),
           "mixed routing gives the prefix step's keys and counts")
    wall["mixed_s"] = time.perf_counter() - t0

    # the hash-sharded pulldown step against a panel split by key prefix:
    # the JAX dry run's panel, plus the first read's k-mers so that some
    # rows hit
    t0 = time.perf_counter()
    panel_keys, _ = G.kmerize(k, [DRY_PANEL_SEQ, codes[0]])
    prow, _ = shuffle.partition_panel(panel_keys, k, D)
    pstep = shuffle.make_pulldown_step(
        mesh, k, R, L, capacity_factor=DRY_CAPACITY_FACTOR)
    hits, povf = pstep(_per_slot(mesh, (codes, lengths)),
                       [torch.from_numpy(prow[d]).to(dev)
                        for d, dev in enumerate(mesh.devices)])
    overflow["pulldown"] = sum(int(o) for o in povf)
    row_hits = hits[0].cpu().numpy().astype(np.int64)
    _check(overflow["pulldown"] == 0, f"pulldown step overflowed "
           f"{overflow['pulldown']} probes")
    _check(np.array_equal(row_hits, G.scan_panel(k, panel_keys, list(codes))),
           "the pulldown step's row hits equal golden.scan_panel")
    wall["pulldown_s"] = time.perf_counter() - t0

    # key-prefix-sharded set op, its cardinalities summed over the slots
    t0 = time.perf_counter()
    b_keys = keys[::2]
    b_cnt = np.ones(len(b_keys), np.uint32)
    sk, sc, cards = setops.set_op_sharded(
        (keys, cnts), (b_keys, b_cnt), "union", k, D,
        devices=[str(d) for d in mesh.devices])
    wk, wc = setops.set_op((keys, cnts), (b_keys, b_cnt), "union",
                           device=mesh.devices[0])
    _check(np.array_equal(sk, wk) and np.array_equal(sc, wc),
           "the sharded union equals the one-device union")
    _check(cards["intersect"] == len(b_keys),
           f"cards['intersect'] {cards['intersect']} == |B| {len(b_keys)}")
    wall["set_op_s"] = time.perf_counter() - t0
    wall["total_s"] = time.perf_counter() - t_start
    return {"devices": [str(d) for d in mesh.devices], "keys": keys,
            "counts": cnts, "row_hits": row_hits, "union": len(sk),
            "cards": cards, "overflow": overflow,
            "sent_bytes": M.sent_bytes() - sent0,
            "slot_bytes": M.slot_bytes() - slot0,
            "wall": wall}
