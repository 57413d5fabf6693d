"""kmerize workload: FASTQ/FASTA -> sorted canonical k-mer set + counts.

Port of zotpu/workloads/kmerize.py ``kmerize_paths`` in accumulator mode,
with ``_iter_batches`` and ``Stats``. The host side is the JAX package's
own shared code: ``fastq.parse_batches`` (halo = k-1), ``prefetch`` and the
2-bit wire pack ``wire.pack_codes``. Per batch the device runs the pack
kernel (K1; the wire form when ``max_len % 32 == 0``, u8 codes otherwise),
``torch.sort``, the dedup-compact kernel (K2), and the accumulator's fused
merges (K3). The result crosses to the host once, at the end.

On CUDA each batch is copied from pinned host memory on a side stream with
``non_blocking=True``, and the copy starts before the previous batch's
merges are enqueued, so the two overlap.

``kmerize_paths_sharded`` ports the single-controller sharded path
(``kmerize_paths_sharded`` in accumulator mode): each batch's rows split
over the mesh's slots, the sharded step (dist/shuffle.py) routes every
k-mer to its owner slot, and each slot's runs merge in its own LSM
accumulator (``ShardedAccumulator``). Spill/resume (single-device or
sharded) and multi-controller runs are not yet ported.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from zotpu import semantics as S
from zotpu.io import fastq, wire
from zotpu.io.prefetch import prefetch, prefetch_many
from zotpu_torch.dist import shuffle
from zotpu_torch.dist.mesh import make_mesh
from zotpu_torch.kernels.pack import pack_canonical, pack_canonical_wire
from zotpu_torch.kernels.sortdedup import kmer_sort_dedup
from zotpu_torch.workloads.accumulator import (DeviceAccumulator,
                                               ShardedAccumulator)


@dataclasses.dataclass
class Stats:
    reads: int = 0
    bases: int = 0
    kmers: int = 0
    batches: int = 0
    unique: int = 0
    n_chips: int = 1
    # sharded runs only: valid k-mers each slot received over the run (the
    # routing-skew metric), and the batches that took the overflow round
    routed_per_shard: list | None = None
    second_rounds: int | None = None

    def as_dict(self):
        return dataclasses.asdict(self)


def host_tensors(batch, wire_pack: bool, pin: bool):
    """A parsed batch as host tensors: (packed, mask, lengths) wire words
    (u32 bit patterns as int32) or (codes, lengths); pinned when ``pin``."""
    if wire_pack:
        packed, mask = wire.pack_codes(batch.codes)
        arrays = (packed.view(np.int32), mask.view(np.int32), batch.lengths)
    else:
        arrays = (batch.codes, batch.lengths)
    ts = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return tuple(t.pin_memory() for t in ts) if pin else ts


def upload(host, device, copy_stream):
    """Start copying host tensors to ``device`` on ``copy_stream`` (None on
    the CPU, where the tensors are returned as they are)."""
    if copy_stream is None:
        return tuple(t.to(device) for t in host)
    with torch.cuda.stream(copy_stream):
        return tuple(t.to(device, non_blocking=True) for t in host)


def await_upload(tensors, device, copy_stream) -> None:
    """Make the compute stream of ``device`` wait for an upload."""
    if copy_stream is None:
        return
    compute = torch.cuda.current_stream(device)
    compute.wait_stream(copy_stream)
    for t in tensors:
        t.record_stream(compute)


class SlotUploads:
    """Per-slot uploads of a batch's host tensors: slot d takes rows
    [d * R, (d + 1) * R) of each, on a copy stream of its device."""

    def __init__(self, mesh, rows_per_slot: int):
        self.mesh, self.rows = mesh, rows_per_slot
        self.streams = {dev: torch.cuda.Stream(dev) if dev.type == "cuda"
                        else None for dev in mesh.devices}

    def start(self, host):
        R = self.rows
        return [upload(tuple(t[d * R:(d + 1) * R] for t in host), dev,
                       self.streams[dev])
                for d, dev in enumerate(self.mesh.devices)]

    def wait(self, slots) -> None:
        for ts, dev in zip(slots, self.mesh.devices):
            await_upload(ts, dev, self.streams[dev])


def sharded_mesh(n_shards: int, device="cuda", devices=None):
    """The mesh of a sharded run: ``devices`` as given (several slots may
    share a card), else n_shards slots of ``device``; more slots than
    visible cards raise as the JAX package does."""
    if devices is None and torch.device(device).type == "cuda":
        n_dev = torch.cuda.device_count()
        if n_shards > n_dev:
            raise ValueError(f"--shards {n_shards} exceeds the {n_dev} "
                             f"available device(s)")
    return make_mesh(n_shards, device=device, devices=devices)


def _iter_batches(paths, batch_reads, max_len, k, stats, wire_pack=False,
                  pin=False):
    """Prefetched stream of each batch's host tensors; updates stats.

    stats.reads counts input RECORDS, not rows: halo-chunked overlong
    records span several rows (and possibly batches), deduplicated via
    record_ids. The wire pack and pinning run in the prefetch thread, so
    they overlap device work. Several files parse in a small worker pool
    (ZOTPU_PARSE_WORKERS overrides its size); batches of different files
    then interleave, which the accumulator allows."""

    def parse_one(path):
        for batch in fastq.parse_batches(path, batch_reads, max_len,
                                         halo=k - 1):
            yield batch, host_tensors(batch, wire_pack, pin)

    def count(batch, last_id):
        rids = batch.record_ids[:batch.n_reads]
        n_rec = len(np.unique(rids))
        if n_rec and last_id is not None and rids[0] == last_id:
            n_rec -= 1  # first record continues from the previous batch
        return n_rec, (int(rids[-1]) if len(rids) else last_id)

    def account(batch, n_rec):
        stats.batches += 1
        stats.reads += n_rec
        stats.bases += batch.bases

    if len(paths) > 1:
        workers = int(os.environ.get("ZOTPU_PARSE_WORKERS",
                                     min(4, os.cpu_count() or 1)))
        last_ids: dict[int, int] = {}
        for tag, (batch, host) in prefetch_many(
                [functools.partial(parse_one, p) for p in paths],
                workers=workers, depth=2 * max(workers, 1)):
            n_rec, last_ids[tag] = count(batch, last_ids.get(tag))
            account(batch, n_rec)
            yield host
        return

    def all_batches():
        for path in paths:
            last_id = None
            for batch, host in parse_one(path):
                n_rec, last_id = count(batch, last_id)
                yield batch, host, n_rec

    for batch, host, n_rec in prefetch(all_batches(), depth=2):
        account(batch, n_rec)
        yield host


def kmerize_paths(paths: list[str], k: int, batch_reads: int = 4096,
                  max_len: int = 256, spill_dir: str | None = None,
                  stats: Stats | None = None,
                  merge_capacity: int = 1 << 26, device="cuda"
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Kmerize files into one sorted unique (keys u64, counts u32) pair.

    Per-batch runs stay on ``device`` and merge in the LSM accumulator
    (workloads/accumulator.py); ``merge_capacity`` bounds its unique keys.
    ``spill_dir`` (per-batch checkpoint files) is not yet ported and
    raises NotImplementedError."""
    if spill_dir is not None:
        raise NotImplementedError(
            "--spill-dir/--resume are not yet ported to zotpu_torch; run "
            "`python -m zotpu kmerize --spill-dir` for checkpointed runs")
    S.check_k(k)
    device = torch.device(device)
    stats = stats if stats is not None else Stats()
    on_cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_cuda else None
    wire_pack = max_len % 32 == 0  # striped wire words need 32 | L
    acc: DeviceAccumulator | None = None
    pending = None

    def consume(run):
        nonlocal acc
        if acc is None:
            acc = DeviceAccumulator(run[0].shape[0], max_cap=merge_capacity,
                                    device=device)
        acc.add(*run)

    for host in _iter_batches(paths, batch_reads, max_len, k, stats,
                              wire_pack=wire_pack, pin=on_cuda):
        # Start this batch's upload, enqueue the previous batch's merges
        # while it flies, then run this batch's step on the uploaded inputs.
        dev = upload(host, device, copy_stream)
        if pending is not None:
            consume(pending)
        await_upload(dev, device, copy_stream)
        if wire_pack:
            keys = pack_canonical_wire(*dev, k)
        else:
            keys = pack_canonical(*dev, k)
        pending = kmer_sort_dedup(keys)
    if pending is not None:
        consume(pending)
    if acc is None:
        keys, counts = np.empty(0, np.uint64), np.empty(0, S.COUNT_DTYPE)
    else:
        keys, counts = acc.result()
    stats.kmers = int(counts.sum(dtype=np.uint64))
    stats.unique = len(keys)
    return keys, counts


def kmerize_paths_sharded(paths: list[str], k: int, n_shards: int,
                          batch_reads: int = 4096, max_len: int = 256,
                          stats: Stats | None = None,
                          capacity_factor: float = 4.0,
                          spill_dir: str | None = None, resume: bool = False,
                          merge_capacity: int = 1 << 26,
                          shard_hash: str = "prefix", device="cuda",
                          devices=None, force_second_round: bool = False
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Sharded kmerize over a mesh of n_shards slots (a power of two): each
    batch of batch_reads rows splits evenly over the slots, k-mers route to
    their owner slot (with an overflow second round), and per-slot runs
    accumulate on their devices (ShardedAccumulator): one transfer at the
    end. The slots are ``devices`` when given (several may name one card),
    else n_shards slots of ``device``.

    Routing overflow is checked once, at the end (a device-side counter),
    and raises ValueError. ``spill_dir`` (with or without ``resume``) is not
    yet ported and raises NotImplementedError; without it ``resume`` does
    nothing, as in the JAX package. ``force_second_round`` is the step's flag
    (dist/shuffle.make_kmerize_step)."""
    if spill_dir is not None:
        raise NotImplementedError(
            "--spill-dir/--resume with --shards are not yet ported to "
            "zotpu_torch; run `python -m zotpu kmerize --shards N "
            "--spill-dir` for checkpointed sharded runs")
    S.check_k(k)
    stats = stats if stats is not None else Stats()
    stats.n_chips = n_shards
    mesh = sharded_mesh(n_shards, device, devices)
    reads_per_chip = max(batch_reads // n_shards, 1)
    wire_pack = max_len % 32 == 0
    step, cap_out = shuffle.make_kmerize_step(
        mesh, k, reads_per_chip, max_len, capacity_factor=capacity_factor,
        wire=wire_pack, shard_hash=shard_hash,
        force_second_round=force_second_round)
    acc = ShardedAccumulator(mesh.devices, cap_out, max_cap=merge_capacity)
    uploads = SlotUploads(mesh, reads_per_chip)
    pin = any(d.type == "cuda" for d in mesh.devices)
    overflow = routed = pending = None
    for host in _iter_batches(paths, reads_per_chip * n_shards, max_len, k,
                              stats, wire_pack=wire_pack, pin=pin):
        slots = uploads.start(host)
        if pending is not None:
            acc.add(pending)
        uploads.wait(slots)
        out = step(slots)
        pending = [o[:3] for o in out]
        ovf = [o[3] for o in out]
        rt = [o[4] for o in out]
        overflow = ovf if overflow is None else [
            a + b for a, b in zip(overflow, ovf)]
        routed = rt if routed is None else [a + b for a, b in zip(routed, rt)]
    if pending is not None:
        acc.add(pending)
    stats.second_rounds = step.second_rounds
    if routed is None:
        keys, counts = np.empty(0, np.uint64), np.empty(0, S.COUNT_DTYPE)
        stats.routed_per_shard = [0] * n_shards
    else:
        dev0 = mesh.devices[0]
        vals = torch.stack([x.to(dev0) for x in overflow + routed]).tolist()
        if sum(vals[:n_shards]) > 0:
            raise ValueError("all-to-all bucket overflow (deferred): raise "
                             "capacity_factor")
        stats.routed_per_shard = vals[n_shards:]
        keys, counts = shuffle.gather_global(
            *acc.result(), reorder=shard_hash == "mixed")
    stats.kmers = int(counts.sum(dtype=np.uint64))
    stats.unique = len(keys)
    return keys, counts
