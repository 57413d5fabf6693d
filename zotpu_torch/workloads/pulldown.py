"""Panel pulldown / scan workload (BASELINE config 5), single device.

Port of zotpu/workloads/pulldown.py ``scan_batch``, ``scan_batch_wire``,
``panel_to_device`` and ``pulldown_paths``. The panel lives on the device
as a sorted SENTINEL-padded int64 tensor. Per batch the device runs the
pack kernel (K1; the wire form when ``max_len % 32 == 0``, u8 codes
otherwise) and the membership join (K4), and only the per-row hit counts
come back to the host, where rows re-aggregate into records
(``RecordAggregator``: a vectorised counterpart of the JAX package's, with
equal results, so the driving thread holds the GIL that the parse thread
needs for a few array operations a batch, not a Python loop over records).

One stream of the host feed (workloads/feed.py) runs over every sample:
with two samples or more the parse pool parses whole samples at once, so
samples interleave and each sample's batches keep their file order (each
sample has its own aggregator), and the parse overlaps the device work.
Each batch goes up through a stager (workloads/staging.py: on CUDA
from pinned host memory on a copy stream), and its row hits come down into
pinned memory behind an event; the host aggregates batch i-1 while the
card works on batch i.

``pulldown_paths_sharded`` ports the hash-sharded scan: the panel is
partitioned over the mesh's slots by the same owner function as the
routing, read k-mers route to their owner slot carrying their global
read-row id, and per-row hits sum over slots (dist/shuffle.py
``make_pulldown_step``). In a multi-controller run (``_pulldown_sharded_
multihost`` of the JAX package) samples go round-robin to the processes,
each fills its own slots' rows, and the steps run in lockstep.
"""

from __future__ import annotations

import numpy as np
import torch

from zotpu_torch import metrics
from zotpu_torch.dist import shuffle
from zotpu_torch.dist.mesh import lockstep, sharded_mesh
from zotpu_torch.kernels.join import row_hits_sorted_join
from zotpu_torch.kernels.pack import pack_canonical, pack_canonical_wire
from zotpu_torch.keys import SENTINEL
from zotpu_torch.workloads import feed
from zotpu_torch.workloads.staging import Stager, Stagers


def scan_batch(codes, lengths, panel, k: int):
    """(R, L) u8 codes vs the device panel -> (R,) int32 per-row hits."""
    R, L = codes.shape
    keys = pack_canonical(codes, lengths, k)
    return row_hits_sorted_join(panel, keys, R, L - k + 1)


def scan_batch_wire(packed, mask, lengths, panel, k: int):
    """scan_batch over the 0.375 B/base wire form (zotpu/io/wire.py)."""
    R, W = packed.shape
    keys = pack_canonical_wire(packed, mask, lengths, k)
    return row_hits_sorted_join(panel, keys, R, 16 * W - k + 1)


def panel_to_device(keys: np.ndarray, device="cuda"):
    """Sorted u64 panel keys -> int64 tensor on device (the card unless
    the caller names another), SENTINEL-padded to the next power of two
    (at least 8). The span ``upload``; its bytes count as ``h2d.bytes``."""
    with metrics.span("upload"):
        keys = np.asarray(keys, np.uint64)
        n = len(keys)
        cap = max(1 << (n - 1).bit_length(), 8) if n else 8
        if n and keys.max() >= np.uint64(1 << 62):
            raise ValueError("panel key >= 2**62 (not a packed k-mer)")
        out = np.full(cap, SENTINEL, np.int64)
        out[:n] = keys.astype(np.int64)
        metrics.count("h2d.bytes", out.nbytes)
        return torch.from_numpy(out).to(device)


class RecordAggregator:
    """Re-aggregate per-ROW hit counts into per-RECORD counts.

    Overlong records are halo-chunked into several rows (possibly spanning
    batch boundaries), and counting rows would overstate reads_with_hits /
    misalign per-read output. Chunk halos never duplicate a k-mer start
    position, so summing row hits per record is exact.

    A vectorised counterpart of zotpu.workloads.pulldown.RecordAggregator
    (whose module imports jax), with equal results. It relies on record ids
    that never decrease, within a batch and from one batch to the next, as
    ``fastq.parse_batches`` yields them: a record's rows are one run of
    equal ids, and only a batch's first record can continue the previous
    batch's last. Each batch's per-record sums stay an array until
    ``result()``; the counters ``aggregate.records`` (records a batch
    starts) and ``aggregate.carried`` (1 where its first record continues
    the previous non-empty batch's last) say how much work that was."""

    def __init__(self):
        self._sums: list[np.ndarray] = []   # non-empty int64 chunks
        self._last_id = -1

    def add(self, row_hits: np.ndarray, record_ids: np.ndarray) -> None:
        if len(record_ids) == 0:
            return
        ids = np.asarray(record_ids)
        starts = feed.record_starts(ids)
        sums = np.add.reduceat(np.asarray(row_hits), starts, dtype=np.int64)
        carried = bool(self._sums) and ids[0] == self._last_id
        if carried:     # the record spans batches
            self._sums[-1][-1] += sums[0]
            sums = sums[1:]
        if len(sums):
            self._sums.append(sums)
        self._last_id = ids[-1]
        metrics.count("aggregate.records", len(sums))
        metrics.count("aggregate.carried", int(carried))

    def result(self) -> tuple[int, int, list[int]]:
        """(total hits, records with a hit, every record's hits)."""
        if len(self._sums) > 1:
            self._sums = [np.concatenate(self._sums)]
        per_read = self._sums[0] if self._sums else np.zeros(0, np.int64)
        return (int(per_read.sum()), int(np.count_nonzero(per_read > 0)),
                per_read.tolist())


def _iter_scan_batches(paths, batch_reads, max_len, k, wire_pack, pin):
    """(sample index, batch, host tensors) over every sample: the host
    feed, where the parse, the wire pack and pinning run, on the parse
    pool over whole samples where there are two or more (one prefetch
    thread for one). Samples interleave; each sample's batches come in
    file order, as its ``RecordAggregator`` needs."""
    return ((idx, batch, host) for idx, batch, host, _ in feed.batches(
        paths, batch_reads, max_len, k, wire_pack=wire_pack, pin=pin,
        parallel=True, in_order=True))


def pulldown_paths(panel_keys: np.ndarray, sample_paths: list[str], k: int,
                   batch_reads: int = 4096, max_len: int = 256,
                   device="cuda"):
    """Per-sample (total_hits, reads_with_hits, per_read_hits list)."""
    device = torch.device(device)
    allocs = metrics.alloc_mark(device)
    panel = panel_to_device(panel_keys, device=device)
    wire_pack = max_len % 32 == 0
    stager = Stager(device)
    aggs = [RecordAggregator() for _ in sample_paths]
    pending = None

    def finish(idx, batch, hits, done):
        if done is not None:
            with metrics.span("download_wait"):
                done.synchronize()
        n = batch.n_reads   # padding rows past n_reads are cut off
        with metrics.span("aggregate"):
            aggs[idx].add(hits.numpy()[:n], batch.record_ids[:n])

    for idx, batch, host in _iter_scan_batches(
            sample_paths, batch_reads, max_len, k, wire_pack,
            device.type == "cuda"):
        dev = stager.upload(host)
        stager.wait(dev)
        with metrics.span("step"):
            if wire_pack:
                hits = scan_batch_wire(*dev, panel, k)
            else:
                hits = scan_batch(*dev, panel, k)
            hits, done = stager.download(hits)
        if pending is not None:
            finish(*pending)
        pending = (idx, batch, hits, done)
    if pending is not None:
        finish(*pending)
    with metrics.span("aggregate"):
        results = [agg.result() for agg in aggs]
    metrics.count_allocs(allocs)
    return results


def pulldown_paths_sharded(panel_keys: np.ndarray, sample_paths: list[str],
                           k: int, n_shards: int, batch_reads: int = 4096,
                           max_len: int = 256, capacity_factor: float = 4.0,
                           shard_hash: str = "prefix", device="cuda",
                           devices=None):
    """Hash-sharded pulldown over a mesh of n_shards slots (BASELINE config
    5): per-sample (total_hits, reads_with_hits, per_read_hits list), the
    same surface as pulldown_paths. The slots are ``devices`` when given
    (several may name one card), else n_shards slots of ``device``. A
    routing overflow (the total over every slot) raises ValueError for the
    batch it happens in.

    In a multi-controller run process p reads samples[p::P] into its own
    slots' rows, [row0, row0 + L * R) of the global batch, and a drained
    process feeds all-padding rows until every process is drained; a step
    may thus mix batches of different samples, which is sound because row
    ids are global, the per-row hits are summed over every slot, and each
    process aggregates only its own rows. Every process returns every
    sample's summary (gathered by max over an array that starts at -1),
    but per-read vectors only for its own samples (None for the others)."""
    mesh = sharded_mesh(n_shards, device, devices)
    reads_per_chip = max(batch_reads // n_shards, 1)
    rows = reads_per_chip * len(mesh.devices)
    row0 = mesh.first * reads_per_chip
    wire_pack = max_len % 32 == 0
    prow, _ = shuffle.partition_panel(panel_keys, k, n_shards,
                                      shard_hash=shard_hash)
    panels = [torch.from_numpy(prow[mesh.first + d]).to(dev)
              for d, dev in enumerate(mesh.devices)]
    step = shuffle.make_pulldown_step(mesh, k, reads_per_chip, max_len,
                                      capacity_factor=capacity_factor,
                                      wire=wire_pack, shard_hash=shard_hash)
    stagers = Stagers(mesh, reads_per_chip)
    pin = any(d.type == "cuda" for d in mesh.devices)
    mine = range(mesh.process_index, len(sample_paths), mesh.process_count)
    aggs = {idx: RecordAggregator() for idx in mine}
    dev0 = mesh.devices[0]
    pending = None

    def finish(idx, batch, hits, overflow, done):
        if done is not None:
            done.synchronize()
        if int(overflow) > 0:
            raise ValueError("all-to-all bucket overflow in scan: raise "
                             "capacity_factor")
        if batch is not None:
            n = batch.n_reads
            aggs[idx].add(hits.numpy()[:n], batch.record_ids[:n])

    stream = _iter_scan_batches([sample_paths[i] for i in mine], rows,
                                max_len, k, wire_pack, pin)
    pad = ((None, None, feed.padding_host(rows, max_len, wire_pack, pin))
           if mesh.multi else None)
    for j, batch, host in lockstep(mesh, stream, pad):
        slots = stagers.upload(host)
        stagers.wait(slots)
        hits, overflow = step(slots, panels)
        both = torch.cat([hits[0][row0:row0 + rows].to(torch.int64),
                          mesh.psum(overflow)[0].to(dev0).reshape(1)])
        both, done = stagers.slots[0].download(both)
        if pending is not None:
            finish(*pending)
        pending = (None if j is None else mine[j], batch, both[:rows],
                   both[rows], done)
    if pending is not None:
        finish(*pending)
    stat = torch.full((len(sample_paths), 2), -1, dtype=torch.int64)
    per_read = {}
    for idx, agg in aggs.items():
        tot, rwh, per_read[idx] = agg.result()
        stat[idx] = torch.tensor([tot, rwh])
    stat = mesh.allreduce(stat.to(dev0), "max").tolist()
    return [(tot, rwh, per_read.get(idx))
            for idx, (tot, rwh) in enumerate(stat)]
