"""kmerize workload: FASTQ/FASTA -> sorted canonical k-mer set + counts.

Port of zotpu/workloads/kmerize.py: ``kmerize_paths`` and
``kmerize_paths_sharded`` in accumulator and in spill mode, with
``_iter_batches``, ``Stats``, ``merge_runs`` and the spill-run checks. The
host side is the port's copy of the shared code: ``fastq.parse_batches``
(halo = k-1), ``prefetch`` and the 2-bit wire pack ``wire.pack_codes``. Per
batch the device runs the pack kernel (K1; the wire form when ``max_len %
32 == 0``, u8 codes otherwise), ``torch.sort``, the dedup-compact kernel
(K2), and the accumulator's fused merges (K3). The result crosses to the
host once, at the end.

On CUDA each batch is copied from pinned host memory on a side stream with
``non_blocking=True``, and the copy starts before the previous batch's
merges are enqueued, so the two overlap.

``kmerize_paths_sharded`` ports the sharded path: each batch's rows split
over the mesh's slots, the sharded step (dist/shuffle.py) routes every
k-mer to its owner slot, and each slot's runs merge in its own LSM
accumulator (``ShardedAccumulator``). In a multi-controller run (a process
group exists, dist/mesh.py) each process parses only its own files into
its own slots' rows, and the steps run in lockstep across the processes
(``_iter_global_batches``).

With ``spill_dir`` each batch's run crosses to the host (a plain copy of
its dense prefix) and is written as ``run{batch:06d}.zkf`` with a layout
stamp in its meta: the checkpoint. ``resume=True`` re-reads the runs whose
stamp matches and recomputes the rest; the end is ``merge_runs`` over all
runs (the host's golden merge below ``DEVICE_MERGE_THRESHOLD`` keys, the K3
merge tree of workloads/setops.py at or above it). File names, keys, counts
and stamps are the JAX package's, so either package resumes a directory the
other left. A multi-controller process writes its own slots' rows of a
batch as ``run{batch:06d}.p{process}.zkf``.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from zotpu_torch import semantics as S
from zotpu_torch import keys as K
from zotpu_torch.io import container, fastq, wire
from zotpu_torch.io.prefetch import prefetch, prefetch_many
from zotpu_torch.dist import shuffle
from zotpu_torch.dist.mesh import make_mesh, multi_controller, process_mesh
from zotpu_torch.kernels.pack import pack_canonical, pack_canonical_wire
from zotpu_torch.kernels.sortdedup import kmer_sort_dedup
from zotpu_torch.reference_impl import golden as G
from zotpu_torch.workloads.accumulator import (DeviceAccumulator,
                                               ShardedAccumulator, to_host)


@dataclasses.dataclass
class Stats:
    reads: int = 0
    bases: int = 0
    kmers: int = 0
    batches: int = 0
    unique: int = 0
    n_chips: int = 1
    # sharded runs only: valid k-mers each slot received over the run (the
    # routing-skew metric)
    routed_per_shard: list | None = None
    # sharded runs only: the batches that took the overflow round. The JAX
    # package's Stats has no such counter, so it stays out of as_dict()
    # (the kmerize JSON line and the container's meta["stats"]).
    second_rounds: int | None = None

    def as_dict(self):
        d = dataclasses.asdict(self)
        del d["second_rounds"]
        return d


DEVICE_MERGE_THRESHOLD = 1 << 20  # total keys from which the device tree wins


def merge_runs(runs: list[tuple[np.ndarray, np.ndarray]],
               force_host: bool = False, device="cuda"
               ) -> tuple[np.ndarray, np.ndarray]:
    """Tree-merge sorted (keys, counts) runs, summing counts (saturating).

    Small totals merge on the host (the golden numpy merge); totals of
    ``DEVICE_MERGE_THRESHOLD`` keys or more take the pairwise K3 merge tree
    on ``device``. ``force_host=True`` pins the golden path regardless of
    size (the --host cross-check never uses device kernels)."""
    if not runs:
        return np.empty(0, np.uint64), np.empty(0, S.COUNT_DTYPE)
    total = sum(len(r[0]) for r in runs)
    if not force_host and total >= DEVICE_MERGE_THRESHOLD:
        from zotpu_torch.workloads.setops import merge_tree_device
        return merge_tree_device(runs, device=device)
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(G.merge([runs[i], runs[i + 1]]))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


class Interrupted(RuntimeError):
    """Raised by the fault-injection hook to simulate a mid-run crash."""


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
    """The mesh of a sharded run: in a multi-controller run n_shards
    global slots over the processes (``process_mesh`` on ``device``);
    otherwise ``devices`` as given (several slots may share a card), else
    n_shards slots of ``device``; more slots than visible cards raise as the
    JAX package does."""
    if multi_controller():
        return process_mesh(n_shards, device)
    if devices is None and torch.device(device).type == "cuda":
        n_dev = torch.cuda.device_count()
        if n_shards > n_dev:
            raise ValueError(f"--shards {n_shards} exceeds the {n_dev} "
                             f"available device(s)")
    return make_mesh(n_shards, device=device, devices=devices)


def _iter_batches(paths, batch_reads, max_len, k, stats, wire_pack=False,
                  pin=False, parallel=True):
    """Prefetched stream of each batch's host tensors; updates stats.

    stats.reads counts input RECORDS, not rows: halo-chunked overlong
    records span several rows (and possibly batches), deduplicated via
    record_ids. The wire pack and pinning run in the prefetch thread, so
    they overlap device work. With ``parallel`` several files parse in a
    small worker pool (ZOTPU_PARSE_WORKERS overrides its size); batches of
    different files then INTERLEAVE, which only a consumer that does not
    depend on insertion order allows (the accumulator). Spill mode passes
    parallel=False: its numbered run files must cover the same reads on
    every run, or a resume would count reads twice."""

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

    if parallel and len(paths) > 1:
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


def padding_host(rows: int, max_len: int, wire_pack: bool, pin: bool):
    """The host tensors of an all-padding batch (INVALID codes, zero
    lengths; in the wire form too): what a drained process feeds."""
    return host_tensors(fastq.CodeBatch(
        codes=np.full((rows, max_len), S.INVALID_CODE, np.uint8),
        lengths=np.zeros(rows, np.int32), n_reads=0), wire_pack, pin)


def lockstep(mesh, items, pad):
    """``items`` as they come, in step with the other processes of a
    multi-controller mesh: a process whose items run out yields ``pad``
    until every process is drained. One reduction a batch decides it, so
    every process takes the same number of (collective) steps."""
    if not mesh.multi:
        yield from items
        return
    it = iter(items)
    flag = torch.zeros((), dtype=torch.int64, device=mesh.devices[0])
    while True:
        item = next(it, None)
        if not int(mesh.allreduce(flag + (item is not None), "max")):
            return
        yield pad if item is None else item


def _iter_global_batches(paths, mesh, reads_per_chip, max_len, k, stats,
                         wire_pack=False, pin=False, parallel=False):
    """Batch stream of the sharded step (``kmerize._iter_global_batches``):
    host tensors of this process's slots' rows, reads_per_chip a slot.
    In a multi-controller run each process parses ONLY its own files
    (``paths``), and a drained process feeds all-padding rows until every
    process is drained."""
    rows = reads_per_chip * len(mesh.devices)
    return lockstep(mesh, _iter_batches(
        paths, rows, max_len, k, stats, wire_pack=wire_pack, pin=pin,
        parallel=parallel), padding_host(rows, max_len, wire_pack, pin)
        if mesh.multi else None)


_STAMP_KEYS = ("k", "batch_reads", "max_len", "process_count",
               "process_index", "n_shards", "shard_hash")


def _load_run_if_valid(path, stamp):
    """Read a spill run iff its layout stamp matches; None = recompute.

    The match is exact over _STAMP_KEYS, not a subset check: a file whose
    meta carries a layout key ABSENT from the caller's stamp (a sharded
    run's ``n_shards`` found by a later plain resume with the same k,
    batch_reads and max_len) covers a different batch layout and must be
    recomputed."""
    if not os.path.exists(path):
        return None
    ks = container.read(path)
    if any(ks.meta.get(key) != val for key, val in stamp.items()):
        return None                           # stale layout: recompute
    if any(key in ks.meta and key not in stamp for key in _STAMP_KEYS):
        return None                           # another mode's spill: recompute
    return ks


def resume_from_spills(spill_dir: str, device="cuda"
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Rebuild the merged set from previously written per-batch runs.

    Every run file must carry an IDENTICAL layout stamp (k, batching, and
    for sharded runs the process and slot layout): run contents depend on
    all of them, so a directory mixing leftovers of a run with a different
    layout would count the reads the stale files cover twice. Mixed stamps
    raise instead."""
    runs = []
    ref = None
    for name in sorted(os.listdir(spill_dir)):
        if not name.endswith(".zkf"):
            continue
        ks = container.read(os.path.join(spill_dir, name))
        sig = (ks.k,) + tuple(ks.meta.get(key) for key in _STAMP_KEYS)
        if ref is None:
            ref = (name, sig)
        elif sig != ref[1]:
            raise ValueError(
                f"spill dir mixes runs from different layouts: {ref[0]} has "
                f"{ref[1]} but {name} has {sig}; delete the stale files or "
                f"rerun kmerize with --spill-dir to recompute")
        runs.append((ks.keys, ks.counts))
    return merge_runs(runs, device=device)


def _write_run(run_path, k, keys, counts, batch_no, stamp):
    container.write(run_path, container.KmerSet(
        k=k, keys=keys, counts=counts, meta={"run": batch_no, **stamp}))


def kmerize_paths(paths: list[str], k: int, batch_reads: int = 4096,
                  max_len: int = 256, spill_dir: str | None = None,
                  stats: Stats | None = None, resume: bool = False,
                  fail_after_batches: int | None = None,
                  merge_capacity: int = 1 << 26, device="cuda"
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Kmerize files into one sorted unique (keys u64, counts u32) pair.

    Default (no spill_dir): per-batch runs stay on ``device`` and merge in
    the LSM accumulator (workloads/accumulator.py); ``merge_capacity``
    bounds its unique keys.

    With ``spill_dir`` (an existing directory) each batch's dense run is
    copied to the host and written as a ZKF file, the checkpoint
    granularity: ``resume=True`` re-reads completed runs instead of
    recomputing them, so a crashed run redoes at most one batch. The files
    parse one after another then, so that a run file covers the same reads
    on every run. ``fail_after_batches`` is the fault-injection hook used
    by tests: the batch in flight is written before the raise, so exactly
    that many run files exist."""
    S.check_k(k)
    device = torch.device(device)
    stats = stats if stats is not None else Stats()
    on_cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_cuda else None
    wire_pack = max_len % 32 == 0  # striped wire words need 32 | L
    use_acc = spill_dir is None
    acc: DeviceAccumulator | None = None
    runs: list[tuple[np.ndarray, np.ndarray]] = []
    batch_no = 0
    pending = None  # (device run, batch_no, run_path)
    # run-file contents depend on the batching layout and on k
    stamp = {"k": k, "batch_reads": batch_reads, "max_len": max_len}

    def consume(p):
        nonlocal acc
        run, bno, run_path = p
        if use_acc:
            if acc is None:
                acc = DeviceAccumulator(run[0].shape[0],
                                        max_cap=merge_capacity, device=device)
            acc.add(*run)
            return
        # spill mode transfers every batch by design
        n = int(run[2])
        keys, cnts = K.to_numpy_set(*to_host([run[0][:n], run[1][:n]]), n)
        _write_run(run_path, k, keys, cnts, bno, stamp)
        stats.kmers += int(cnts.sum(dtype=np.uint64))
        runs.append((keys, cnts))

    for host in _iter_batches(paths, batch_reads, max_len, k, stats,
                              wire_pack=wire_pack, pin=on_cuda,
                              parallel=use_acc):
        batch_no += 1
        run_path = (os.path.join(spill_dir, f"run{batch_no:06d}.zkf")
                    if spill_dir is not None else None)
        if resume and run_path:
            ks = _load_run_if_valid(run_path, stamp)
            if ks is not None:
                if pending is not None:
                    consume(pending)
                    pending = None
                stats.kmers += int(ks.counts.sum(dtype=np.uint64))
                runs.append((ks.keys, ks.counts))
                continue
        if fail_after_batches is not None and batch_no > fail_after_batches:
            if pending is not None:
                consume(pending)
            raise Interrupted(f"injected failure before batch {batch_no}")
        # Start this batch's upload, enqueue the previous batch's merges
        # (or write its run) while it flies, then run this batch's step on
        # the uploaded inputs.
        dev = upload(host, device, copy_stream)
        if pending is not None:
            consume(pending)
        await_upload(dev, device, copy_stream)
        if wire_pack:
            keys = pack_canonical_wire(*dev, k)
        else:
            keys = pack_canonical(*dev, k)
        pending = (kmer_sort_dedup(keys), batch_no, run_path)
    if pending is not None:
        consume(pending)
    if not use_acc:
        keys, counts = merge_runs(runs, device=device)
    else:
        keys, counts = (acc.result() if acc is not None else
                        (np.empty(0, np.uint64), np.empty(0, S.COUNT_DTYPE)))
        stats.kmers = int(counts.sum(dtype=np.uint64))
    stats.unique = len(keys)
    return keys, counts


def kmerize_paths_sharded(paths: list[str], k: int, n_shards: int,
                          batch_reads: int = 4096, max_len: int = 256,
                          stats: Stats | None = None,
                          capacity_factor: float = 4.0,
                          spill_dir: str | None = None, resume: bool = False,
                          fail_after_batches: int | None = None,
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

    In a multi-controller run (dist/mesh.py) n_shards is the global slot
    count, ``paths`` are this process's own files, and every process
    returns the global result. ``stats.reads`` and ``stats.bases`` are
    summed over the processes; ``stats.batches`` counts this process's
    parsed batches, as in the JAX package.

    With ``spill_dir`` each batch's run is written as a ZKF checkpoint
    instead (a transfer a batch by design, the contract of the
    single-device spill path): the globally gathered run, or in a
    multi-controller run this process's slots' rows as
    ``run{batch:06d}.p{process}.zkf``. ``resume=True`` re-reads completed
    runs (a batch is skipped only when EVERY process still has its valid
    file: steps are collective), and without a ``spill_dir`` does nothing,
    as in the JAX package. A multi-controller process merges its own runs
    on the host, then the disjoint process sets are gathered.
    Routing overflow raises ValueError: checked once, at the end (a
    device-side counter), in accumulator mode, and batch by batch in spill
    mode, each time on the total over every slot. ``fail_after_batches``
    is the tests' fault-injection hook. ``force_second_round`` is the
    step's flag (dist/shuffle.make_kmerize_step)."""
    S.check_k(k)
    stats = stats if stats is not None else Stats()
    stats.n_chips = n_shards
    mesh = sharded_mesh(n_shards, device, devices)
    multi = mesh.multi
    L = len(mesh.devices)
    dev0 = mesh.devices[0]
    reads_per_chip = max(batch_reads // n_shards, 1)
    wire_pack = max_len % 32 == 0
    use_acc = spill_dir is None
    step, cap_out = shuffle.make_kmerize_step(
        mesh, k, reads_per_chip, max_len, capacity_factor=capacity_factor,
        wire=wire_pack, shard_hash=shard_hash,
        force_second_round=force_second_round)
    acc = ShardedAccumulator(mesh.devices, cap_out, max_cap=merge_capacity,
                             mesh=mesh)
    uploads = SlotUploads(mesh, reads_per_chip)
    pin = any(d.type == "cuda" for d in mesh.devices)
    overflow = routed = pending = None
    runs: list[tuple[np.ndarray, np.ndarray]] = []
    batch_no = 0
    # prefix-sharded process sets concatenate sorted only in this layout
    reorder = shard_hash == "mixed" or not shuffle.hosts_prefix_ordered(mesh)
    # a run file covers the reads of one batch under this slot layout
    stamp = {"k": k, "process_count": mesh.process_count,
             "process_index": mesh.process_index, "n_shards": n_shards,
             "batch_reads": batch_reads, "max_len": max_len,
             "shard_hash": shard_hash}
    suffix = f".p{mesh.process_index}" if multi else ""

    def add(total, xs):
        return xs if total is None else [a + b for a, b in zip(total, xs)]

    for host in _iter_global_batches(paths, mesh, reads_per_chip, max_len,
                                     k, stats, wire_pack=wire_pack, pin=pin,
                                     parallel=use_acc):
        batch_no += 1
        run_path = (os.path.join(spill_dir, f"run{batch_no:06d}{suffix}.zkf")
                    if spill_dir is not None else None)
        if resume and run_path:
            ks = _load_run_if_valid(run_path, stamp)
            have = torch.tensor(ks is not None, dtype=torch.int64,
                                device=dev0)
            if int(mesh.allreduce(have, "min")):
                stats.kmers += int(ks.counts.sum(dtype=np.uint64))
                runs.append((ks.keys, ks.counts))
                continue
        if fail_after_batches is not None and batch_no > fail_after_batches:
            raise Interrupted(f"injected failure before batch {batch_no}")
        slots = uploads.start(host)
        if pending is not None:
            acc.add(pending)
        uploads.wait(slots)
        out = step(slots)
        routed = add(routed, [o[4] for o in out])
        if use_acc:
            pending = [o[:3] for o in out]
            overflow = add(overflow, [o[3] for o in out])
            continue
        # spill mode: the overflow check and the run's sizes cost one host
        # sync a batch, by design
        vals = torch.stack([mesh.psum([o[3] for o in out])[0].to(dev0)]
                           + [o[2].to(dev0) for o in out]).tolist()
        if vals[0] > 0:
            raise ValueError(
                "all-to-all bucket overflow: raise capacity_factor")
        ns = vals[1:]
        parts = [t.numpy() for t in to_host(
            [o[0][:n] for o, n in zip(out, ns)]
            + [o[1][:n] for o, n in zip(out, ns)])]
        keys, cnts = shuffle.gather_local_rows(
            parts[:L], parts[L:], ns, reorder=shard_hash == "mixed")
        stats.kmers += int(cnts.sum(dtype=np.uint64))
        _write_run(run_path, k, keys, cnts, batch_no, stamp)
        runs.append((keys, cnts))
    if pending is not None:
        acc.add(pending)
    stats.second_rounds = step.second_rounds
    if routed is not None:
        total = mesh.psum(overflow or [torch.zeros((), dtype=torch.int64,
                                                   device=dev0)])[0]
        vals = torch.cat([mesh.allgather(torch.stack([x.to(dev0)
                                                      for x in routed])),
                          total.to(dev0).reshape(1)]).tolist()
        stats.routed_per_shard = vals[:n_shards]
        if vals[n_shards] > 0:
            raise ValueError("all-to-all bucket overflow (deferred): raise "
                             "capacity_factor")
    if not use_acc:
        # a process merges its own runs on the host, then the disjoint
        # process sets are gathered
        keys, counts = merge_runs(runs, force_host=multi, device=dev0)
        if multi:
            keys, counts = shuffle.allgather_host_sets(mesh, keys, counts,
                                                       reorder=reorder)
            stats.kmers = int(counts.sum(dtype=np.uint64))
    elif overflow is None:
        keys, counts = np.empty(0, np.uint64), np.empty(0, S.COUNT_DTYPE)
    else:
        keys, counts = shuffle.gather_global(
            *acc.result(), reorder=shard_hash == "mixed")
        stats.kmers = int(counts.sum(dtype=np.uint64))
    if multi:   # reads and bases were counted per process
        stats.reads, stats.bases = mesh.allreduce(torch.tensor(
            [stats.reads, stats.bases], dtype=torch.int64,
            device=dev0)).tolist()
    stats.unique = len(keys)
    return keys, counts
