"""The host feed of every workload: input paths -> the serial path's
batches, their host tensors, and the input records each batch adds. The
parse (``io/fastq``, halo = k-1), the wire pack, pinning and the record
count all run in the parse threads, so they overlap device work.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from zotpu_torch import metrics
from zotpu_torch import semantics as S
from zotpu_torch.io import bgzf, fastq, wire
from zotpu_torch.io.prefetch import prefetch, prefetch_many


def record_starts(ids: np.ndarray) -> np.ndarray:
    """The rows of a batch where a record starts: its first row and every
    row whose record id differs from the row before. Record ids never
    decrease (``fastq.CodeBatch``), so a record's rows are one run of equal
    ids and these are the starts of the runs, one a record."""
    ids = np.asarray(ids)
    if len(ids) == 0:
        return np.zeros(0, np.int64)
    return np.flatnonzero(np.concatenate(([True], ids[1:] != ids[:-1])))


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


def padding_host(rows: int, max_len: int, wire_pack: bool, pin: bool):
    """The host tensors of an all-padding batch (INVALID codes, zero
    lengths; in the wire form too): what a drained process feeds."""
    return host_tensors(fastq.CodeBatch(
        codes=np.full((rows, max_len), S.INVALID_CODE, np.uint8),
        lengths=np.zeros(rows, np.int32), n_reads=0), wire_pack, pin)


def parse_workers() -> int:
    """W, the parse pool's threads: ZOTPU_PARSE_WORKERS, else
    min(4, cores)."""
    return int(os.environ.get("ZOTPU_PARSE_WORKERS",
                              min(4, os.cpu_count() or 1)))


def batches(paths, batch_reads, max_len, k, wire_pack=False, pin=False,
            parallel=False, in_order=False):
    """Every batch of the serial path over ``paths`` exactly once, as
    (file index, batch, host tensors, records it adds); the records summed
    over a call are the input's (a halo-chunked record spans rows, and
    possibly batches).

    With ``parallel`` the parse runs on a pool of W threads
    (``parse_workers``) and batches INTERLEAVE: with fewer files than W,
    all plain FASTQ (``fastq.cuttable``), the workers parse pieces of
    ``batch_reads`` records (``fastq.cut_fastq``, counted as
    ``parse.pieces``; partial batches go through ``_Rejoin``), and a
    file's pieces may come out of order; else, with more than one file,
    whole files, each drained from start to end by one worker, so each
    file's batches come in file order. ``in_order`` asks for that order
    (a consumer that keeps state per file across its batches): the cut
    path never runs. Otherwise one prefetch thread parses the files in
    order. The threads a call parses on are counted once as
    ``parse.threads``: W on the cut path, min(W, files) on the file pool,
    1 on the serial path.

    While a profiler runs, what the .gz files' pipes inflated (on threads
    of their own, where a counter would be dropped) is summed in one
    ``bgzf.InflateTotals`` and recorded here, on the driving thread, once
    the last batch has passed: ``inflate.bytes_in``, ``inflate.bytes_out``,
    ``inflate.s``, ``inflate.threads`` and ``inflate.members`` (0 for plain
    gzip). A call over plain files records none of them."""
    workers = parse_workers()
    inflated = bgzf.InflateTotals() if metrics.tracing() else None

    def counted(f, parsed):
        last = None     # a source's previous record id
        for batch in parsed:
            ids = batch.record_ids[:batch.n_reads]
            n_rec = len(record_starts(ids))
            if n_rec and ids[0] == last:
                n_rec -= 1      # the record continues from the last batch
            if len(ids):
                last = ids[-1]
            yield f, batch, host_tensors(batch, wire_pack, pin), n_rec

    def whole(f, path):
        return counted(f, fastq.parse_batches(path, batch_reads, max_len,
                                              halo=k - 1, totals=inflated))

    def piece(f, data, rec0):
        return counted(f, fastq.parse_fastq_piece(data, rec0, batch_reads,
                                                  max_len, halo=k - 1))

    cut = (parallel and not in_order and len(paths) < workers
           and all(map(fastq.cuttable, paths)))
    if cut:
        sources = (functools.partial(piece, f, *c)
                   for f, path in enumerate(paths)
                   for c in fastq.cut_fastq(path, batch_reads))
    else:
        sources = [functools.partial(whole, f, p)
                   for f, p in enumerate(paths)]
    if cut or (parallel and len(paths) > 1):
        metrics.count("parse.threads",
                      workers if cut else min(workers, len(paths)))
        items = prefetch_many(sources, workers=workers,
                              depth=2 * max(workers, 1))
    else:
        metrics.count("parse.threads", 1)
        items = enumerate(prefetch((item for source in sources
                                    for item in source()), depth=2))
    rejoin = _Rejoin(len(paths), batch_reads, max_len,
                     lambda b: host_tensors(b, wire_pack, pin))
    seen = set()    # the pieces whose first batch came
    for tag, (f, batch, host, n_rec) in items:
        if cut and tag not in seen:
            seen.add(tag)
            metrics.count("parse.pieces", 1)
        if cut and batch.n_reads < batch_reads:
            yield from rejoin.add(f, batch, host, n_rec)
        else:
            yield f, batch, host, n_rec
    yield from rejoin.flush()
    if inflated is not None and inflated.threads:
        for name in ("bytes_in", "bytes_out", "s", "threads", "members"):
            metrics.count("inflate." + name, getattr(inflated, name))


class _Rejoin:
    """The partial batches of a cut file's pieces, joined into the serial
    path's batches: a file's rows fill batches of ``batch_reads`` in order,
    so a file gives ceil(rows / batch_reads) batches however it was cut.

    A piece's batch is partial where it is its file's last, or where an
    overlong read gave the piece more rows than one batch. A file's one
    partial batch is kept as it came (the serial path's last batch, its
    host tensors made in the worker); a second one sends the rows of both
    into the file's emitter, and each batch completed there gets its host
    tensors from ``to_host`` here. A batch's bases ride on its first row,
    and the records of a file's partial batches on the next batch of that
    file that comes out."""

    def __init__(self, n_files, batch_reads, max_len, to_host):
        self.ems = [fastq._BatchEmitter(batch_reads, max_len)
                    for _ in range(n_files)]
        self.lone: dict[int, tuple] = {}
        self.owed = [0] * n_files
        self.to_host = to_host

    def add(self, f, batch, host, n_rec):
        """Take a partial batch of file ``f`` that adds ``n_rec`` records;
        yields (f, batch, host, records) of each batch completed."""
        self.owed[f] += n_rec
        em = self.ems[f]
        if f not in self.lone and em.r == 0:
            self.lone[f] = batch, host
            return
        if f in self.lone:
            yield from self._rows(f, self.lone.pop(f)[0])
        yield from self._rows(f, batch)

    def _out(self, f, batch, host):
        n_rec, self.owed[f] = self.owed[f], 0
        return f, batch, host, n_rec

    def _rows(self, f, b):
        n = b.n_reads
        bases = np.zeros(n, np.int64)
        bases[0] = b.bases
        for done in self.ems[f].add_block(b.codes[:n], b.lengths[:n],
                                          b.record_ids[:n], bases):
            yield self._out(f, done, self.to_host(done))

    def flush(self):
        """Every file's last batch: (f, batch, host, records)."""
        for f, em in enumerate(self.ems):
            if f in self.lone:
                yield self._out(f, *self.lone.pop(f))
            for done in em.flush():
                yield self._out(f, done, self.to_host(done))
