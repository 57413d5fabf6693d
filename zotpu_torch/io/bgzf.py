"""BGZF (bgzip) block-parallel gzip input.

Reference analog: none -- zotmer opens .gz serially (SURVEY.md section 1 L1).
Written after zotpu/io/bgzf.py. A single plain-gzip STREAM is inherently
serial to inflate (each byte's dictionary is the previous 32 KB), so one
large .fastq.gz caps host input at one core's inflate rate. BGZF -- the
blocked gzip variant ubiquitous in genomics (htslib/bgzip/BAM) -- is a
concatenation of INDEPENDENT gzip members of <= 64 KB, each advertising its
compressed size in a "BC" extra-field subfield, so the members can be
inflated in parallel and re-emitted in order.

``BgzfPipe`` is a drop-in for the ``.read()`` chunk facade fastq._open_chunks
hands the batched parsers: it walks the block headers sequentially (one
bounded buffer), groups ~``GROUP_BYTES`` of compressed blocks, inflates the
groups in a small thread pool (zlib releases the GIL), and yields the
inflated chunks IN ORDER with a bounded in-flight window -- flat RSS, same
bytes as serial gzip (tests assert equality). A group's members are each
inflated from a slice of the group that holds that member alone, so zlib
is never handed (and never copies, under the GIL) the rest of the group.

What an inflate did is counted in an ``InflateTotals`` that the caller
hands the pipe (``BgzfPipe`` here, ``fastq._ChunkPipe`` for plain gzip):
plain numbers, added on the threads that inflate. Those threads are not
the one a profiler traces, so the thread that drives the job records the
totals (``workloads/feed.batches``: the counters ``inflate.*``).
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib

_GZ_MAGIC = b"\x1f\x8b"
_FEXTRA = 0x04
#: the compressed bytes of whole blocks that BgzfPipe inflates as one task
GROUP_BYTES = 8 << 20


class InflateTotals:
    """What the inflate of gzip inputs did, summed over the pipes handed
    it: ``bytes_in``, the compressed bytes of the gzip members inflated;
    ``bytes_out``, the bytes they gave; ``s``, the wall seconds of each
    inflate task, summed over tasks; ``threads``, the threads that ran at
    least one task; ``members``, the BGZF members inflated, each from its
    own slice (0 for plain gzip, whose stream is read whole). The pipes add
    on the threads that inflate, under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ran: set[threading.Thread] = set()  # held: none counts twice
        self.bytes_in = self.bytes_out = self.members = 0
        self.s = 0.0

    @property
    def threads(self) -> int:
        return len(self._ran)

    def add(self, bytes_in: int, bytes_out: int, s: float,
            members: int = 0) -> None:
        """One task's totals, added on the thread that ran it."""
        with self._lock:
            self._ran.add(threading.current_thread())
            self.bytes_in += bytes_in
            self.bytes_out += bytes_out
            self.s += s
            self.members += members


def _bc_bsize(extra: bytes) -> int | None:
    """BSIZE (total block size - 1) from a gzip extra field, or None."""
    i = 0
    while i + 4 <= len(extra):
        si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
            "<H", extra[i + 2:i + 4])[0]
        if si1 == 66 and si2 == 67 and slen == 2 and i + 6 <= len(extra):
            return struct.unpack("<H", extra[i + 4:i + 6])[0]
        i += 4 + slen
    return None


def is_bgzf(path: str) -> bool:
    """True when the first gzip member carries the BC (BGZF) marker."""
    try:
        with open(path, "rb") as f:
            hdr = f.read(18)
    except OSError:
        return False
    if len(hdr) < 18 or hdr[:2] != _GZ_MAGIC or not hdr[3] & _FEXTRA:
        return False
    xlen = struct.unpack("<H", hdr[10:12])[0]
    with open(path, "rb") as f:
        f.seek(12)
        extra = f.read(xlen)
    return len(extra) == xlen and _bc_bsize(extra) is not None


def _iter_groups(path: str, group_bytes: int):
    """Yield byte strings of whole consecutive BGZF blocks, ~group_bytes of
    compressed data each (one sequential pass, one group buffered)."""
    with open(path, "rb") as f:
        group: list[bytes] = []
        size = 0
        while True:
            hdr = f.read(12)
            if not hdr:
                break
            if len(hdr) < 12 or hdr[:2] != _GZ_MAGIC or not hdr[3] & _FEXTRA:
                raise ValueError(f"{path}: corrupt BGZF block header at "
                                 f"offset {f.tell() - len(hdr)}")
            xlen = struct.unpack("<H", hdr[10:12])[0]
            extra = f.read(xlen)
            bsize = _bc_bsize(extra)
            if bsize is None:
                raise ValueError(f"{path}: BGZF block without BC subfield "
                                 f"at offset {f.tell() - 12 - xlen}")
            rest = f.read(bsize + 1 - 12 - xlen)
            if len(rest) != bsize + 1 - 12 - xlen:
                raise ValueError(f"{path}: truncated BGZF block")
            group.append(hdr + extra + rest)
            size += bsize + 1
            if size >= group_bytes:
                yield b"".join(group)
                group, size = [], 0
        if group:
            yield b"".join(group)


def _member_spans(data: bytes):
    """Yield ``(start, end)`` of each BGZF member of ``data``, a
    concatenation of whole members, from the BSIZE of its BC subfield."""
    off = 0
    while off < len(data):
        hdr = data[off:off + 12]
        if len(hdr) < 12 or hdr[:2] != _GZ_MAGIC or not hdr[3] & _FEXTRA:
            raise ValueError(f"corrupt BGZF block header at offset {off}")
        xlen = struct.unpack_from("<H", hdr, 10)[0]
        bsize = _bc_bsize(data[off + 12:off + 12 + xlen])
        if bsize is None:
            raise ValueError(f"BGZF block without BC subfield at offset {off}")
        end = off + bsize + 1
        if end > len(data):
            raise ValueError(f"truncated BGZF block at offset {off}")
        yield off, end
        off = end


def _inflate_members(data: bytes) -> bytes:
    """Inflate a concatenation of complete BGZF members, each from a
    slice that ends where its BSIZE says: zlib (which releases the GIL
    while it inflates) is handed no byte past the member, so there is no
    rest of the group to carry over in ``unused_data``. wbits 31 keeps
    zlib's checks of each member's gzip header, CRC32 and ISIZE; a deflate
    stream that does not end exactly at the member's end raises."""
    view = memoryview(data)
    out = []
    for start, end in _member_spans(data):
        d = zlib.decompressobj(wbits=31)
        out.append(d.decompress(view[start:end]))
        if not d.eof:
            raise ValueError(f"corrupt BGZF block at offset {start}: "
                             "incomplete or truncated deflate stream")
        if d.unused_data:
            raise ValueError(f"corrupt BGZF block at offset {start}: "
                             f"{len(d.unused_data)} bytes after its gzip "
                             "member")
    return b"".join(out)


def _ordered_parallel(items, fn, workers: int, window: int):
    """Map ``fn`` over ``items`` with a thread pool, yielding results IN
    ORDER with at most ``window`` tasks in flight (bounded RSS)."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as ex:
        dq: collections.deque = collections.deque()
        for item in items:
            dq.append(ex.submit(fn, item))
            while len(dq) >= window:
                yield dq.popleft().result()
        while dq:
            yield dq.popleft().result()


def default_workers() -> int:
    return int(os.environ.get("ZOTPU_BGZF_WORKERS",
                              min(4, os.cpu_count() or 1)))


class BgzfPipe:
    """File-like ``.read()`` facade inflating BGZF block groups in parallel.

    Drop-in for fastq's chunk sources: each ``.read()`` returns the next
    inflated group (callers treat the size argument as advisory, exactly as
    with _ChunkPipe). Plain-gzip files must NOT come here -- callers gate on
    ``is_bgzf``.

    With ``totals`` (an ``InflateTotals``) the pipe counts each task, timed
    on the pool thread that runs ``_inflate_members``: its group's bytes in
    and out, its seconds, its thread and its members. A pool starts a
    thread only as tasks come, so a file of one group counts one. The
    caller's driving thread records them; nothing is counted here."""

    def __init__(self, path: str, workers: int | None = None,
                 totals: InflateTotals | None = None):
        workers = workers or default_workers()
        inflate = _inflate_members
        if totals is not None:
            def inflate(data: bytes) -> bytes:
                t = time.perf_counter()
                out = _inflate_members(data)
                dt = time.perf_counter() - t
                totals.add(len(data), len(out), dt,
                           sum(1 for _ in _member_spans(data)))
                return out
        self._gen = _ordered_parallel(
            _iter_groups(path, GROUP_BYTES), inflate, workers,
            window=workers + 2)

    def read(self, n: int = -1) -> bytes:
        return next(self._gen, b"")

    def close(self) -> None:
        self._gen.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_bgzf(path: str, data: bytes, level: int = 1,
               block_bytes: int = 0xFF00) -> None:
    """Minimal BGZF writer (fixtures/tests/bench; production reads only).

    Splits ``data`` into <= block_bytes pieces, each a complete gzip member
    with the BC extra subfield, and appends the standard 28-byte EOF block.
    """
    def block(piece: bytes) -> bytes:
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = c.compress(piece) + c.flush()
        bsize = 18 + len(cdata) + 8
        if bsize - 1 > 0xFFFF:
            raise ValueError("BGZF block too large; lower block_bytes")
        hdr = (b"\x1f\x8b\x08\x04" + b"\x00" * 4 + b"\x00\xff"
               + struct.pack("<H", 6) + b"BC" + struct.pack("<H", 2)
               + struct.pack("<H", bsize - 1))
        return (hdr + cdata + struct.pack("<I", zlib.crc32(piece))
                + struct.pack("<I", len(piece) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        for off in range(0, len(data), block_bytes):
            f.write(block(data[off:off + block_bytes]))
        f.write(block(b""))   # EOF marker
