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
merges are enqueued, so the two overlap. Spill/resume and the sharded path
are not yet ported.
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
from zotpu_torch.kernels.pack import pack_canonical, pack_canonical_wire
from zotpu_torch.kernels.sortdedup import kmer_sort_dedup
from zotpu_torch.workloads.accumulator import DeviceAccumulator


@dataclasses.dataclass
class Stats:
    reads: int = 0
    bases: int = 0
    kmers: int = 0
    batches: int = 0
    unique: int = 0
    n_chips: int = 1

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
        if on_cuda:
            with torch.cuda.stream(copy_stream):
                dev = tuple(t.to(device, non_blocking=True) for t in host)
        else:
            dev = host
        if pending is not None:
            consume(pending)
        if on_cuda:
            compute = torch.cuda.current_stream(device)
            compute.wait_stream(copy_stream)
            for t in dev:
                t.record_stream(compute)
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
