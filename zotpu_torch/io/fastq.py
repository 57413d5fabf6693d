"""FASTA/FASTQ input pipeline.

A copy of zotpu/io/fastq.py.

Reference analog: zotmer/library/file.py ``openFile``/``readFasta``/``readFastq``
(streaming generators over gzip-transparent files; unverified, reference mount
empty -- SURVEY.md section 0).

Device-first difference: besides the per-record generators, this module provides
**batched** parsing straight into fixed-shape ``(R, L)`` u8 code matrices --
the host-side half of the kmerize pipeline. Parsing is numpy-vectorized
(newline scans via ``np.where`` on the raw byte buffer, LUT encode) so the host
can keep up with the device; a C++ fast path can replace `_split_lines` later
without changing the interface.
"""

from __future__ import annotations

import gzip
import io
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from zotpu_torch import semantics as S


def open_file(path: str, mode: str = "rb"):
    """Gzip-transparent open (reference analog: library/file.openFile).

    '-' maps to the stdio byte streams (writes previously vanished into a
    throwaway BytesIO)."""
    if path == "-":
        import sys
        return sys.stdout.buffer if ("w" in mode or "a" in mode) else sys.stdin.buffer
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(f) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) from a FASTA stream."""
    name, chunks = None, []
    for raw in f:
        line = raw.decode("ascii") if isinstance(raw, bytes) else raw
        line = line.rstrip("\r\n")
        if line.startswith(">"):
            if name is not None:
                yield name, "".join(chunks)
            fields = line[1:].split()
            name, chunks = fields[0] if fields else "", []
        elif line:
            chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def read_fastq(f) -> Iterator[tuple[str, str, str]]:
    """Yield (id, sequence, quality) from a FASTQ stream."""
    while True:
        hdr = f.readline()
        if not hdr:
            return
        if isinstance(hdr, bytes):
            seq = f.readline(); plus = f.readline(); qual = f.readline()
            yield (hdr.decode("ascii").rstrip("\r\n")[1:],
                   seq.decode("ascii").rstrip("\r\n"),
                   qual.decode("ascii").rstrip("\r\n"))
        else:
            # rstrip \r too: a text-mode file object without universal
            # newlines over CRLF input would otherwise leave a trailing
            # \r on seq/qual (the bytes branch above already does)
            seq = f.readline(); plus = f.readline(); qual = f.readline()
            yield (hdr.rstrip("\r\n")[1:], seq.rstrip("\r\n"),
                   qual.rstrip("\r\n"))


# --- batched vectorized parsing --------------------------------------------

@dataclass
class CodeBatch:
    """A fixed-shape batch of encoded reads for the device.

    codes:   (R, L) u8, values 0..3 valid, 4 invalid/padding
    lengths: (R,) int32 true read lengths (<= L)
    n_reads: number of real ROWS (rows beyond are all-padding)
    bases:   input bases attributable to this batch for stats -- excludes
             padding and the (k-1)-halo overlap of chunked rows; defaults to
             sum(lengths[:n_reads]).
    record_ids: (R,) int64 input-record index of each row (global, 0-based;
             -1 for padding rows). Overlong records are halo-chunked into
             several rows, so per-RECORD results must re-aggregate rows that
             share an id -- ids are non-decreasing and a record's rows may
             span consecutive batches. Defaults to one record per row.
    """
    codes: np.ndarray
    lengths: np.ndarray
    n_reads: int
    bases: int = -1
    record_ids: np.ndarray | None = None
    # Optional H2D wire form (packed 2-bit codes, invalid bitmask) -- see
    # io/wire.py. Populated by the input pipeline when the consumer ships
    # batches to a device, so the pack overlaps device compute in the
    # prefetch thread.
    wire: tuple | None = None

    def __post_init__(self):
        if self.bases < 0:
            self.bases = int(self.lengths[:self.n_reads].sum())


def _chunk_bytes() -> int:
    """Streaming read granularity (ZOTPU_CHUNK_BYTES overrides; tests use
    tiny chunks to exercise every carry path)."""
    import os
    return int(os.environ.get("ZOTPU_CHUNK_BYTES", 64 << 20))


def _iter_file_chunks(path: str, totals=None):
    """The file's bytes, gzip-transparent, _chunk_bytes() at a time. With
    ``totals`` (io/bgzf.InflateTotals; a .gz file) each read is timed and
    counted as an inflate task: its seconds, the bytes it gave, and the
    compressed bytes read from the file meanwhile."""
    with open_file(path, "rb") as f:
        raw = getattr(f, "fileobj", f)
        pos = raw.tell() if totals is not None else 0
        while True:
            t = time.perf_counter()
            data = f.read(_chunk_bytes())
            if totals is not None:
                end = raw.tell()
                totals.add(end - pos, len(data), time.perf_counter() - t)
                pos = end
            if not data:
                return
            yield data


class _ChunkPipe:
    """File-like ``.read()`` facade over a prefetch()'d chunk generator.

    For .gz inputs the zlib inflate (GIL-released) then runs in its OWN
    thread, overlapped with the parse/encode stages downstream -- the
    chunk-pipelined half of the parallel host input pipeline (SURVEY.md
    section 7 "gzip inflation ... overlapped"; a single gzip STREAM is
    inherently serial to inflate, so within one file this pipelining is the
    whole opportunity -- cross-file parallelism is io/prefetch.prefetch_many).
    RSS stays flat: at most ``depth`` chunks are buffered.

    With ``totals`` (io/bgzf.InflateTotals; a .gz file only) each chunk
    read, timed in the prefetch thread, counts as an inflate task of that
    one thread. The caller's driving thread records them."""

    def __init__(self, path: str, totals=None):
        from zotpu_torch.io.prefetch import prefetch
        self._gen = prefetch(_iter_file_chunks(path, totals), depth=2)

    def read(self, n: int = -1) -> bytes:  # n ignored: chunks are pre-sized
        return next(self._gen, b"")

    def close(self) -> None:
        self._gen.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_chunks(path: str, totals=None):
    """Chunk source for the batched parsers; .gz pipelines inflate into its
    own thread (ZOTPU_PIPELINE_INFLATE=1 forces it for any file, =0 off).
    BGZF (bgzip) files -- independently-inflatable gzip blocks carrying the
    BC extra subfield -- inflate block-groups in a small thread POOL
    instead, so one large file is no longer capped at one core's inflate
    rate (ZOTPU_BGZF_WORKERS sizes the pool, =1
    reduces to the serial pipeline).

    ``totals`` (io/bgzf.InflateTotals) goes to the pipe of a .gz file,
    which counts in it on its own threads what it inflated: the bytes in
    and out, the seconds of its tasks and its threads. The thread that
    drives the job records them (workloads/feed.batches); a file that is
    not .gz counts nothing."""
    import os
    mode = os.environ.get("ZOTPU_PIPELINE_INFLATE", "auto")
    if mode == "1" or (mode == "auto" and path.endswith(".gz")):
        from zotpu_torch.io import bgzf
        totals = totals if path.endswith(".gz") else None
        if path != "-" and bgzf.is_bgzf(path) and bgzf.default_workers() > 1:
            return bgzf.BgzfPipe(path, totals=totals)
        return _ChunkPipe(path, totals)
    return open_file(path, "rb")


class _BatchEmitter:
    """Accumulates encoded rows into fixed-shape CodeBatch-es.

    Memory is bounded by one pending batch + one appended block -- the heart
    of the bounded-RSS streaming pipeline (a WGS run larger than host RAM
    must stream). A pending batch's buffers are allocated by its first row,
    so an emitter that full batches pass by costs nothing."""

    def __init__(self, max_reads: int, max_len: int):
        self.max_reads = max_reads
        self.max_len = max_len
        self._reset()

    def _reset(self):
        self.codes = self.lengths = self.ids = None
        self.r = 0
        self.bases = 0

    def _alloc(self):
        if self.codes is None:
            self.codes = np.full((self.max_reads, self.max_len),
                                 S.INVALID_CODE, np.uint8)
            self.lengths = np.zeros(self.max_reads, np.int32)
            self.ids = np.full(self.max_reads, -1, np.int64)

    def add_block(self, codes2d, lengths, ids, new_bases):
        """Append a block of rows ((B, max_len) u8 + per-row metadata);
        yields every CodeBatch completed along the way."""
        b = 0
        n = len(lengths)
        while b < n:
            self._alloc()
            take = min(self.max_reads - self.r, n - b)
            self.codes[self.r:self.r + take] = codes2d[b:b + take]
            self.lengths[self.r:self.r + take] = lengths[b:b + take]
            self.ids[self.r:self.r + take] = ids[b:b + take]
            self.bases += int(np.sum(new_bases[b:b + take]))
            self.r += take
            b += take
            if self.r == self.max_reads:
                yield self._emit()

    def add_row(self, row, rec_id, new_bases):
        """Append one row (<= max_len codes, padded here)."""
        self._alloc()
        self.codes[self.r, :len(row)] = row
        self.codes[self.r, len(row):] = S.INVALID_CODE
        self.lengths[self.r] = len(row)
        self.ids[self.r] = rec_id
        self.bases += int(new_bases)
        self.r += 1
        if self.r == self.max_reads:
            yield self._emit()

    def _emit(self):
        batch = CodeBatch(codes=self.codes, lengths=self.lengths,
                          n_reads=self.r, bases=self.bases,
                          record_ids=self.ids)
        self._reset()
        return batch

    def flush(self):
        if self.r:
            yield self._emit()


def _overlong_span_slow(em, span: np.ndarray, rec0: int, max_len: int,
                        halo: int):
    """Reparse a span of complete records that contains overlong read(s),
    per-record with halo-chunking (rare slow path; the native parser
    truncates at max_len, so its output for such a span is unusable)."""
    nl = np.where(span == 0x0A)[0]
    n_rec = len(nl) // 4
    line_starts = np.concatenate(([0], nl[:4 * n_rec - 1] + 1))
    line_ends = nl[:4 * n_rec].copy()
    has_cr = (line_ends > line_starts) & (span[np.maximum(
        line_ends - 1, 0)] == 0x0D)
    line_ends -= has_cr
    s = line_starts[1::4].astype(np.int64)
    e = line_ends[1::4].astype(np.int64)
    for i in range(n_rec):
        rec = S.ENCODE_LUT[span[s[i]:e[i]]]
        yield from _emit_record_rows(em, rec, rec0 + i, max_len, halo)


def _fastq_records(em, buf, rec0: int, max_reads: int, max_len: int,
                   halo: int):
    """Parse every complete record of ``buf`` (bytes or a u8 array), the
    first with record id ``rec0``, into ``em``; yields each CodeBatch
    completed along the way and returns (bytes consumed, records parsed).
    A trailing incomplete record is left unconsumed.

    The one parse of a FASTQ byte span: the serial path runs it on each
    chunk (with the carry), the cut path (``cut_fastq``) on each piece.
    It picks its parser itself: the native C++ fast path when available (it
    finds record boundaries and overlong reads itself via consumed/max_seen
    -- no redundant numpy newline pre-scan, which cost 9x: 123 vs 1084
    Mbase/s measured), the vectorized numpy gather otherwise, and
    per-record halo-chunking for spans with overlong reads -- so a handful
    of long reads mid-file degrade only their own span. A span of
    ``max_reads`` records with no read over ``max_len`` passes ``em`` by
    as one zero-copy batch when ``em`` holds no rows."""
    from zotpu_torch.io import native

    if native.get_lib() is not None:
        buf_np = np.frombuffer(buf, np.uint8)
        off, rec = 0, rec0
        while True:
            codes, lengths, n, consumed, mx = native.parse_fastq_buffer(
                buf, max_reads, max_len, offset=off)
            if n == 0:  # incomplete trailing record: left to the caller
                break
            if mx > max_len:
                yield from _overlong_span_slow(
                    em, buf_np[off:off + consumed], rec, max_len, halo)
            elif em.r == 0 and n == max_reads:
                # common case: full batch straight through, zero copy
                ids = np.arange(rec, rec + n, dtype=np.int64)
                yield CodeBatch(codes=codes, lengths=lengths, n_reads=n,
                                record_ids=ids)
            else:
                ids = np.arange(rec, rec + n, dtype=np.int64)
                yield from em.add_block(codes[:n], lengths[:n], ids,
                                        lengths[:n])
            rec += n
            off += consumed
        return off, rec - rec0
    buf = np.frombuffer(buf, np.uint8)
    nl = np.where(buf == 0x0A)[0]
    n_rec = len(nl) // 4
    if n_rec == 0:
        return 0, 0
    end = int(nl[4 * n_rec - 1]) + 1
    line_starts = np.concatenate(([0], nl[:4 * n_rec - 1] + 1))
    line_ends = nl[:4 * n_rec].copy()
    has_cr = (line_ends > line_starts) & (buf[np.maximum(
        line_ends - 1, 0)] == 0x0D)
    line_ends -= has_cr
    s = line_starts[1::4].astype(np.int64)
    e = line_ends[1::4].astype(np.int64)
    lens = e - s
    if len(lens) and int(lens.max()) > max_len:
        # overlong reads: per-record halo-chunk (rare slow path)
        for i in range(n_rec):
            rec = S.ENCODE_LUT[buf[s[i]:e[i]]]
            yield from _emit_record_rows(em, rec, rec0 + i, max_len, halo)
    else:
        idx = s[:, None] + np.arange(max_len)[None, :]
        idx = np.minimum(idx, len(buf) - 1)
        rows = np.where(np.arange(max_len)[None, :] < lens[:, None],
                        S.ENCODE_LUT[buf[idx]], S.INVALID_CODE)
        ids = rec0 + np.arange(n_rec, dtype=np.int64)
        yield from em.add_block(rows, lens.astype(np.int32), ids, lens)
    return end, n_rec


def _fastq_batches_chunked(path: str, max_reads: int, max_len: int,
                           halo: int, totals=None) -> Iterator[CodeBatch]:
    """Chunked FASTQ parse: bounded memory, record-boundary carry.

    Reads _chunk_bytes() at a time (gzip-transparent; decompression happens
    here, inside the prefetch thread when driven by workloads). Records are
    4-line groups, so the carry is everything past the last complete group;
    each chunk goes through ``_fastq_records``.
    """
    em = _BatchEmitter(max_reads, max_len)
    rec0 = 0
    with _open_chunks(path, totals) as f:
        carry = b""
        while True:
            data = f.read(_chunk_bytes())
            final = not data
            buf_b = carry + data
            carry = b""
            if final and buf_b and not buf_b.endswith(b"\n"):
                buf_b += b"\n"
            if not buf_b:
                break
            used, n = yield from _fastq_records(em, buf_b, rec0, max_reads,
                                                max_len, halo)
            rec0 += n
            if final:
                break  # a trailing partial record: tolerate like readers do
            carry = buf_b[used:]
    yield from em.flush()


def cuttable(path: str) -> bool:
    """Whether ``cut_fastq`` can cut ``path``: a plain FASTQ file. A gzip
    stream (BGZF too) cannot be cut at a byte offset, stdin is read once,
    and a FASTA record can be a chromosome."""
    return (path != "-" and not path.endswith(".gz")
            and sniff_format(path) == "fastq")


def _skip_lines(arr: np.ndarray, n: int, off: int) -> tuple[int, int]:
    """(bytes up to and including the last, newlines found) of the first
    ``n`` newlines of ``arr[off:]``: the native memchr loop, else numpy."""
    from zotpu_torch.io import native

    got = native.skip_lines(arr, n, off)
    if got is not None:
        return got
    nl = np.flatnonzero(arr[off:] == 0x0A)[:n]
    return (int(nl[-1]) + 1 if len(nl) else 0), len(nl)


def cut_fastq(path: str, records: int) -> Iterator[tuple[np.ndarray, int]]:
    """Cut a plain FASTQ file (``cuttable``) into pieces of ``records``
    records, the last of what is left: yields (the piece's bytes as a u8
    array, the record id of its first record).

    Reads the file in order, _chunk_bytes() at a time, and cuts after
    every 4 * ``records`` newlines, as the parser groups lines into
    records, so no record crosses a piece. A piece is a view into its
    chunk; only one that straddles two chunks is copied. The last piece
    gets the final newline the file may lack. ``parse_fastq_piece`` turns
    a piece into batches, so pieces parse on several threads at once."""
    lines = 4 * records
    rec0 = 0
    parts, have = [], 0  # a piece that straddles chunks, its newlines
    for data in _iter_file_chunks(path):
        arr = np.frombuffer(data, np.uint8)
        off = 0
        while True:
            used, found = _skip_lines(arr, lines - have, off)
            if have + found < lines:
                break
            piece = arr[off:off + used]
            if parts:
                piece = np.concatenate(parts + [piece])
                parts, have = [], 0
            yield piece, rec0
            rec0 += records
            off += used
        if off < len(arr):
            parts.append(arr[off:])
            have += found
    if parts:
        if parts[-1][-1] != 0x0A:
            parts.append(np.frombuffer(b"\n", np.uint8))
        yield np.concatenate(parts), rec0


def parse_fastq_piece(piece: np.ndarray, rec0: int, max_reads: int,
                      max_len: int, halo: int = 0) -> Iterator[CodeBatch]:
    """The batches of one piece of ``cut_fastq``, record ids from ``rec0``,
    by the serial path's own parse (``_fastq_records``). A piece of
    ``max_reads`` records with no read over ``max_len`` is one full batch:
    the batch the serial path emits for those records. The last piece of a
    file gives the serial path's last batch. A piece with an overlong read
    is halo-chunked within itself and flushes its own partial batch, whose
    rows the caller may join to other pieces' (workloads/kmerize.py)."""
    em = _BatchEmitter(max_reads, max_len)
    yield from _fastq_records(em, piece, rec0, max_reads, max_len, halo)
    yield from em.flush()


def _emit_record_rows(em, rec, rec_id, max_len, halo):
    """One (possibly overlong) record -> halo-chunked rows through the
    emitter, with per-row new-base attribution (each input base once)."""
    n = len(rec)
    if n <= max_len:
        yield from em.add_row(rec, rec_id, n)
        return
    step = max_len - halo
    total = n
    i = 0
    for off in range(0, max(n - halo, 1), step):
        row = rec[off:off + max_len]
        take = min(max_len if i == 0 else step, total)
        yield from em.add_row(row, rec_id, take)
        total -= take
        i += 1


def _fasta_batches_chunked(path: str, max_reads: int, max_len: int,
                           halo: int, totals=None) -> Iterator[CodeBatch]:
    """Chunked FASTA parse: bounded memory even for genome-sized records.

    Sequence bases accumulate per record and full halo rows are emitted as
    soon as max_len bases are available, so a chromosome never materializes
    whole; only a < max_len tail plus one chunk is ever resident.
    """
    em = _BatchEmitter(max_reads, max_len)
    step = max_len - halo
    rec_id = -1
    cur = np.empty(0, np.uint8)
    rows_emitted = 0

    def feed(codes):
        nonlocal cur, rows_emitted
        cur = np.concatenate([cur, codes]) if len(cur) else codes
        while len(cur) >= max_len:
            attr = max_len if rows_emitted == 0 else step
            yield from em.add_row(cur[:max_len], rec_id, attr)
            rows_emitted += 1
            cur = cur[step:]

    def end_record():
        nonlocal cur, rows_emitted
        if rec_id >= 0 and (len(cur) or rows_emitted):
            n = len(cur)
            while rows_emitted == 0 or n > halo:
                attr = n if rows_emitted == 0 else n - halo
                yield from em.add_row(cur[:max_len], rec_id, attr)
                rows_emitted += 1
                cur = cur[step:]
                n = len(cur)
                if n == 0:
                    break
        cur = np.empty(0, np.uint8)
        rows_emitted = 0

    with _open_chunks(path, totals) as f:
        carry = b""
        while True:
            data = f.read(_chunk_bytes())
            final = not data
            buf_b = carry + data
            carry = b""
            if final and buf_b and not buf_b.endswith(b"\n"):
                buf_b += b"\n"
            if not buf_b:
                break
            cut = buf_b.rfind(b"\n") + 1
            if cut == 0:
                carry = buf_b
                continue
            carry = buf_b[cut:]
            buf = np.frombuffer(buf_b[:cut], np.uint8)
            nl = np.where(buf == 0x0A)[0]
            starts = np.concatenate(([0], nl[:-1] + 1))
            headers = starts[buf[starts] == ord(">")]
            # regions between headers hold pure sequence bytes (+newlines)
            bounds = np.concatenate(([0], headers, [len(buf)]))
            for bi in range(len(bounds) - 1):
                a, b = int(bounds[bi]), int(bounds[bi + 1])
                if a == b:
                    continue
                if buf[a] == ord(">"):  # header line starts this region
                    yield from end_record()
                    rec_id += 1
                    a = int(nl[np.searchsorted(nl, a)]) + 1  # skip header line
                seg = buf[a:b]
                seg = seg[(seg != 0x0A) & (seg != 0x0D)]
                if len(seg) and rec_id >= 0:
                    yield from feed(S.ENCODE_LUT[seg])
            if final:
                break
        yield from end_record()
    yield from em.flush()


def parse_batches(path: str, max_reads: int, max_len: int,
                  fmt: str | None = None, halo: int = 0,
                  totals=None) -> Iterator[CodeBatch]:
    """Stream a FASTA/FASTQ file as fixed-shape CodeBatch-es, BOUNDED memory.

    Sequences longer than ``max_len`` are split into ``max_len`` rows that
    overlap by ``halo`` bases (workloads pass halo=k-1) so no boundary k-mer
    is lost and no k-mer start position is duplicated. Files are read in
    _chunk_bytes() pieces with record-boundary carry (gzip-transparent), so a
    run larger than host RAM streams with flat RSS; decompression and encode
    happen here -- inside the prefetch thread when driven by workloads.
    A .gz file's inflate is counted in ``totals`` (``_open_chunks``).
    """
    if fmt is None:
        fmt = sniff_format(path)
    if fmt == "fastq":
        yield from _fastq_batches_chunked(path, max_reads, max_len, halo,
                                          totals)
        return
    yield from _fasta_batches_chunked(path, max_reads, max_len, halo, totals)


def _rows_to_batches(rows, max_reads, max_len, new_bases=None, rowids=None):
    """Pre-encoded, pre-padded code rows -> CodeBatch stream.

    Padding is INVALID_CODE, which already invalidates every window touching
    it, so lengths can be uniformly max_len; ``new_bases`` carries the true
    per-row input-base attribution for stats (no padding/halo double count);
    ``rowids`` the per-row record index (a record's chunk rows may span two
    yielded batches)."""
    for lo in range(0, len(rows), max_reads):
        chunk = rows[lo:lo + max_reads]
        r = len(chunk)
        codes = np.full((max_reads, max_len), S.INVALID_CODE, dtype=np.uint8)
        if r:
            codes[:r] = np.stack(chunk)
        bases = (sum(new_bases[lo:lo + max_reads]) if new_bases is not None
                 else -1)
        ids = np.full(max_reads, -1, np.int64)
        ids[:r] = (np.asarray(rowids[lo:lo + max_reads], np.int64)
                   if rowids is not None else np.arange(lo, lo + r))
        yield CodeBatch(codes=codes,
                        lengths=np.full(max_reads, max_len, np.int32),
                        n_reads=r, bases=bases, record_ids=ids)


def chunk_with_halo(seq_codes: np.ndarray, k: int, chunk_len: int) -> np.ndarray:
    """Split one long code sequence into rows with (k-1)-base overlap so no
    boundary k-mer is lost (SURVEY.md section 5, long-context analog)."""
    n = len(seq_codes)
    step = chunk_len - (k - 1)
    rows = []
    for off in range(0, max(n - k + 1, 1), step):
        row = seq_codes[off:off + chunk_len]
        if len(row) < chunk_len:
            row = np.pad(row, (0, chunk_len - len(row)),
                         constant_values=S.INVALID_CODE)
        rows.append(row)
    return np.stack(rows) if rows else np.empty((0, chunk_len), np.uint8)


def sniff_format(path: str) -> str:
    if path == "-":
        # stdin is read exactly once downstream; peek instead of read so the
        # first record's '@'/'>' byte is still there for the parser (and the
        # stream is not closed)
        import sys
        first = sys.stdin.buffer.peek(1)[:1]
    else:
        with open_file(path, "rb") as f:
            first = f.read(1)
    if first == b">":
        return "fasta"
    if first == b"@":
        return "fastq"
    raise ValueError(f"cannot sniff FASTA/FASTQ format of {path!r}")
