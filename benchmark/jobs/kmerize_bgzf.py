"""The kmerize job over bgzip-compressed lanes: the cell's FASTQ files as
BGZF ``.fastq.gz`` files, as a sequencer or an archive hands them over,
through the entry the CLI's ``kmerize`` calls.

At set-up (the first job, the warm-up; the control makes its job after
the reads' directory is gone, and needs only the reference) each FASTQ
file of the fixture is rewritten:

1. its records are ``14 + 2 * read_len`` bytes each (``fixture.
   fastq_records``); the layout is checked, ``@``, ``+`` and the newlines
   where it puts them;
2. its quality columns are overwritten with draws from
   ``cfg["quality_bins"]`` (the four binned Q-scores of NovaSeq-style
   output), each position drawn independently from a generator seeded
   from the reads, since a job is not handed the run's seed;
3. it is compressed to ``readsNN.fastq.gz`` by this file's own BGZF
   writer (``write_bgzf``: SAMv1 section 4.1, as htslib's bgzip writes
   it), so that the cell's input does not depend on the code under test;
   the files are compressed on a thread pool;
4. the standard library's gzip reader must give the FASTQ bytes back
   (``gzip.open``, which streams the members: ``gzip.decompress`` copies
   the rest of the buffer once a member, which is quadratic in the ~280
   members of a file and held the set-up's threads on the GIL);
5. the plain file is deleted, and the job reads the ``.gz`` paths.

Ids and bases are untouched, so the reads, the reference and the judging
are the kmerize job's (``jobs/kmerize.py``), with the same ``LIMITS``.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark import fixture
from benchmark.jobs import kmerize

LIMITS = kmerize.LIMITS
# the empty member that ends a BGZF file (SAMv1 section 4.1.2)
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
# draws a quality position: a bin's share is its count of these
QUALITY_STEPS = 10_000


def bgzf_block(piece, level: int) -> bytes:
    """One BGZF block: a gzip member of ``piece`` (raw deflate at
    ``level``) whose extra field is the BC subfield with BSIZE, the
    block's size less 1."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(piece) + c.flush()
    bsize = 18 + len(body) + 8 - 1
    if bsize > 0xFFFF:
        raise ValueError(f"a block of {len(piece)} bytes compresses to "
                         f"{bsize + 1}, over BGZF's 65536")
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<HBBHH", 6, 66, 67, 2, bsize) + body
            + struct.pack("<II", zlib.crc32(piece), len(piece)))


def write_bgzf(path: str, data, level: int, block_bytes: int) -> None:
    """``data`` as a BGZF file: blocks of at most ``block_bytes`` input
    bytes, then the EOF block."""
    view = memoryview(data)
    with open(path, "wb") as f:
        for off in range(0, len(view), block_bytes):
            f.write(bgzf_block(view[off:off + block_bytes], level))
        f.write(EOF_BLOCK)


def quality_table(bins: dict) -> np.ndarray:
    """The quality byte of each of ``QUALITY_STEPS`` equal draws."""
    counts = {q: round(share * QUALITY_STEPS) for q, share in bins.items()}
    if sum(counts.values()) != QUALITY_STEPS or any(
            abs(counts[q] - bins[q] * QUALITY_STEPS) > 1e-6 for q in bins):
        raise ValueError(f"quality shares {bins} are not whole steps of "
                         f"1/{QUALITY_STEPS} summing to 1")
    return np.concatenate([np.full(n, ord(q), np.uint8)
                           for q, n in counts.items()])


def record_layout(read_len: int) -> dict:
    """{column: byte} of the fixed columns of a fixture record, and the
    record's width and quality columns."""
    L, i = read_len, 2 + fixture.ID_DIGITS
    return {"width": 14 + 2 * L, "qual": (13 + L, 13 + 2 * L),
            "fixed": {0: ord("@"), 1: ord("r"), i: 10, 10 + L: 10,
                      11 + L: ord("+"), 12 + L: 10, 13 + 2 * L: 10}}


def binned_fastq(path: str, read_len: int, table: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
    """The records of the fixture file ``path`` with their qualities drawn
    from ``table``, as one u8 array; raises where a record breaks the
    layout."""
    lay = record_layout(read_len)
    buf = np.fromfile(path, np.uint8)
    if len(buf) % lay["width"]:
        raise ValueError(f"{path}: {len(buf)} bytes are not whole "
                         f"{lay['width']}-byte records")
    rec = buf.reshape(-1, lay["width"])
    for col, byte in lay["fixed"].items():
        if not (rec[:, col] == byte).all():
            raise ValueError(f"{path}: a record lacks {chr(byte)!r} at "
                             f"column {col}")
    a, b = lay["qual"]
    rec[:, a:b] = table[rng.integers(0, len(table), (len(rec), b - a),
                                     dtype=np.uint16)]
    return buf


def compress_inputs(cfg: dict, inputs):
    """The fixture's FASTQ files rewritten as BGZF files with binned
    qualities (module docstring); returns ``inputs`` with their paths."""
    table = quality_table(cfg["quality_bins"])
    seed = int.from_bytes(hashlib.blake2b(
        np.ascontiguousarray(inputs.codes[:4096]).tobytes(),
        digest_size=8).digest(), "little")

    def one(i, path):
        data = binned_fastq(path, cfg["read_len"], table,
                            np.random.default_rng([seed, i]))
        gz = path + ".gz"
        write_bgzf(gz, data, cfg["bgzf_level"], cfg["bgzf_block_bytes"])
        with gzip.open(gz, "rb") as f:
            if f.read() != data.tobytes():
                raise ValueError(f"{gz} does not give its FASTQ back")
        os.remove(path)
        return gz

    with ThreadPoolExecutor(min(len(inputs.paths),
                                os.cpu_count() or 1)) as ex:
        paths = list(ex.map(one, range(len(inputs.paths)), inputs.paths))
    return dataclasses.replace(inputs, paths=paths)


class Job(kmerize.Job):
    def __init__(self, cfg: dict, inputs, devices):
        super().__init__(cfg, inputs, devices)
        self.compressed = False

    def _compress(self) -> None:
        if not self.compressed:
            self.inputs = compress_inputs(self.cfg, self.inputs)
            self.compressed = True

    def run(self, span) -> dict:
        self._compress()
        return super().run(span)
