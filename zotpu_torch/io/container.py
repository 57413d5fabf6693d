"""On-disk container for k-mer sets (ZKF format).

A copy of zotpu/io/container.py: a file written by either package is read
by the other.

Reference analog: zotmer/library/container/ kset/kfset read/write with JSON
metadata including K (unverified -- reference mount empty, SURVEY.md section 0).

Layout (little-endian):
    bytes 0..4   magic  b"ZKF1"
    bytes 4..8   u32 header JSON length H
    bytes 8..8+H JSON header: {"k", "n", "has_counts", "codec", "meta": {...}}
    then         keys blob:   n * u64 sorted canonical k-mers
    then         counts blob: n * u32 (iff has_counts)

codec is "raw" (default), "zlib" (each blob deflate-compressed and
length-prefixed with a u64), or "delta" -- the analog of the reference's
compressed int-vector encodings: keys are stored as zlib'd u32 deltas and
counts as zlib'd u16, plus a small exception table for u32-overflowing
gaps / u16-overflowing counts (exact reconstruction; io/delta.py, the same
scheme as the D2H wire codec). On real k-mer sets "delta" is both smaller
and faster to write than "zlib" (it deflates 6 B/key of low-entropy deltas
instead of 12 B/key of high-entropy raw keys). Caveat: "delta" suits DENSE
sets (mean key gap < 2^32 -- any real WGS-scale set); a tiny set spread
over the full key space turns every row into a 20 B exception and comes
out larger than raw. Decoding is exact in every regime.

The file doubles as the checkpoint format: per-batch sorted runs written with
``write`` can be resumed/merged at any time (SURVEY.md section 5,
checkpoint/resume philosophy of the reference: output files ARE checkpoints).

CASKETS (ZKC): the reference's container layer is a named-blob "casket"
holding several k-mer sets/vectors in one file (SURVEY.md section 2a
"container format"; unverified -- empty reference mount). The analog here:

    bytes 0..4   magic b"ZKC1"
    bytes 4..8   u32 TOC JSON length T
    bytes 8..8+T TOC: {"members": [{"name", "offset", "length"}...],
                       "meta": {...}}   (offsets relative to 8+T)
    then         member blobs, each a COMPLETE ZKF stream

Every reading surface accepts ``casket.zkc#member`` wherever a set path is
expected (read/read_header parse the suffix), so dump/info/verify/set-ops/
hist/scan all address casket members for free; `zotpu casket` builds,
lists, extends, and extracts them.
"""

from __future__ import annotations

import json
import zlib
import os
from dataclasses import dataclass, field

import numpy as np

from zotpu_torch import metrics
from zotpu_torch import semantics as S

MAGIC = b"ZKF1"


@dataclass
class KmerSet:
    k: int
    keys: np.ndarray                      # (n,) u64 sorted unique
    counts: np.ndarray | None = None      # (n,) u32 or None for a bare kset
    meta: dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.keys)

    def validate(self) -> None:
        S.check_k(self.k)
        if self.n and not np.all(self.keys[1:] > self.keys[:-1]):
            raise ValueError("keys not strictly sorted")
        if self.n and int(self.keys[-1]) > int(S.key_mask(self.k)):
            raise ValueError("key exceeds 2k bits")
        if self.counts is not None and len(self.counts) != self.n:
            raise ValueError("counts length mismatch")


def _write_zblob(f, blob: bytes) -> None:
    z = zlib.compress(blob, level=1)
    f.write(np.uint64(len(z)).tobytes())
    f.write(z)


def write_stream(f, ks: KmerSet, codec: str = "raw") -> None:
    """Write one complete ZKF stream to an open binary file object."""
    ks.validate()
    if codec not in ("raw", "zlib", "delta"):
        raise ValueError(f"unknown codec {codec!r}")
    hdr = json.dumps({
        "k": ks.k, "n": int(ks.n),
        "has_counts": ks.counts is not None,
        "codec": codec,
        "meta": ks.meta,
    }).encode("utf-8")
    f.write(MAGIC)
    f.write(np.uint32(len(hdr)).tobytes())
    f.write(hdr)
    if codec == "delta":
        from zotpu_torch.io import delta as D
        d32, c16, exc_pos, exc_key, exc_cnt = D.encode(ks.keys, ks.counts)
        _write_zblob(f, np.ascontiguousarray(d32, "<u4").tobytes())
        if c16 is not None:
            _write_zblob(f, np.ascontiguousarray(c16, "<u2").tobytes())
        f.write(np.uint32(len(exc_pos)).tobytes())
        f.write(np.ascontiguousarray(exc_pos, "<u8").tobytes())
        f.write(np.ascontiguousarray(exc_key, "<u8").tobytes())
        f.write(np.ascontiguousarray(exc_cnt, "<u4").tobytes())
    else:
        blobs = [np.ascontiguousarray(ks.keys, dtype="<u8").tobytes()]
        if ks.counts is not None:
            blobs.append(np.ascontiguousarray(ks.counts, dtype="<u4").tobytes())
        for blob in blobs:
            if codec == "zlib":
                _write_zblob(f, blob)
            else:
                f.write(blob)


def write(path: str, ks: KmerSet, codec: str = "raw") -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_stream(f, ks, codec)
    os.replace(tmp, path)


def _read_header_stream(f, label: str) -> dict:
    if f.read(4) != MAGIC:
        raise ValueError(f"{label}: not a ZKF stream")
    (hlen,) = np.frombuffer(f.read(4), dtype="<u4")
    return json.loads(f.read(int(hlen)).decode("utf-8"))


def _read_into(f, n: int, dtype: str, label: str) -> np.ndarray:
    """A raw blob of ``n`` entries read from ``f`` straight into a fresh
    array of its own dtype: one copy, from the file to the array."""
    arr = np.empty(n, dtype)
    buf = memoryview(arr).cast("B")
    got = 0
    while got < len(buf):
        step = f.readinto(buf[got:])
        if not step:
            raise ValueError(f"{label}: truncated container (expected {n} "
                             f"entries, got {got // arr.itemsize})")
        got += step
    return arr


def read_stream(f, label: str = "<stream>") -> KmerSet:
    """Read one complete ZKF stream from an open binary file positioned at
    its magic (a standalone file or a casket member region).

    A zlib or delta stream is read, decoded, then copied; a raw stream is
    read straight into the arrays returned, which the counter
    ``container.read_direct_bytes`` counts."""
    hdr = _read_header_stream(f, label)
    n = int(hdr["n"])
    codec = hdr.get("codec", "raw")
    meta = hdr.get("meta", {})

    def zblob(dtype):
        (zlen,) = np.frombuffer(f.read(8), dtype="<u8")
        return np.frombuffer(zlib.decompress(f.read(int(zlen))), dtype=dtype)

    if codec == "delta":
        from zotpu_torch.io import delta as D
        d32 = zblob("<u4")
        c16 = zblob("<u2") if hdr["has_counts"] else None
        (n_exc,) = np.frombuffer(f.read(4), dtype="<u4")
        n_exc = int(n_exc)
        exc_pos = np.frombuffer(f.read(8 * n_exc), dtype="<u8")
        exc_key = np.frombuffer(f.read(8 * n_exc), dtype="<u8")
        exc_cnt = np.frombuffer(f.read(4 * n_exc), dtype="<u4")
        if len(d32) != n or len(exc_cnt) != n_exc:
            raise ValueError(f"{label}: truncated container "
                             f"(expected {n} entries, got {len(d32)})")
        keys, counts = D.decode(d32, c16, exc_pos, exc_key, exc_cnt, n)
    elif codec == "zlib":
        keys = zblob("<u8")
        counts = zblob("<u4") if hdr["has_counts"] else None
    else:
        keys = _read_into(f, n, "<u8", label)
        counts = (_read_into(f, n, "<u4", label) if hdr["has_counts"]
                  else None)
        metrics.count("container.read_direct_bytes",
                      keys.nbytes + (0 if counts is None else counts.nbytes))
        return KmerSet(k=int(hdr["k"]), keys=keys, counts=counts, meta=meta)
    if len(keys) != n or (counts is not None and len(counts) != n):
        raise ValueError(f"{label}: truncated container "
                         f"(expected {n} entries, got {len(keys)})")
    return KmerSet(k=int(hdr["k"]), keys=keys.copy(),
                   counts=None if counts is None else counts.copy(),
                   meta=meta)


# ---------------------------------------------------------------------------
# caskets: named-member containers (see module docstring for the layout)

CASKET_MAGIC = b"ZKC1"


def split_member(path: str) -> tuple[str, str | None]:
    """'casket.zkc#name' -> ('casket.zkc', 'name'); plain paths -> (p, None)."""
    if "#" in path:
        file, _, member = path.rpartition("#")
        return file, member
    return path, None


def is_casket(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == CASKET_MAGIC
    except OSError:
        return False


def casket_toc(path: str) -> dict:
    with open(path, "rb") as f:
        if f.read(4) != CASKET_MAGIC:
            raise ValueError(f"{path}: not a ZKC casket")
        (tlen,) = np.frombuffer(f.read(4), dtype="<u4")
        return json.loads(f.read(int(tlen)).decode("utf-8"))


def _casket_member_entry(path: str, name: str) -> tuple[dict, int]:
    toc = casket_toc(path)
    for m in toc["members"]:
        if m["name"] == name:
            with open(path, "rb") as f:
                f.seek(4)
                (tlen,) = np.frombuffer(f.read(4), dtype="<u4")
            return m, 8 + int(tlen)
    names = [m["name"] for m in toc["members"]]
    raise ValueError(f"{path}: no member {name!r} (has {names})")


def casket_write(path: str, members, meta: dict | None = None,
                 codec: str = "raw") -> None:
    """Write a casket from [(name, KmerSet)] pairs (atomic)."""
    import io as _io

    blobs, entries, off = [], [], 0
    seen = set()
    for name, ks in members:
        if name in seen:
            raise ValueError(f"duplicate casket member {name!r}")
        seen.add(name)
        buf = _io.BytesIO()
        write_stream(buf, ks, codec)
        b = buf.getvalue()
        entries.append({"name": name, "offset": off, "length": len(b),
                        "k": ks.k, "n": int(ks.n),
                        "has_counts": ks.counts is not None})
        blobs.append(b)
        off += len(b)
    toc = json.dumps({"members": entries, "meta": meta or {}}).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(CASKET_MAGIC)
        f.write(np.uint32(len(toc)).tobytes())
        f.write(toc)
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)


def casket_read(path: str, name: str) -> KmerSet:
    m, base = _casket_member_entry(path, name)
    with open(path, "rb") as f:
        f.seek(base + int(m["offset"]))
        return read_stream(f, f"{path}#{name}")


def casket_add(path: str, name: str, ks: KmerSet, codec: str = "raw") -> None:
    """Add (or replace) one member; existing member bytes copy verbatim."""
    import io as _io

    members, blobs = [], []
    if os.path.exists(path):
        toc = casket_toc(path)
        with open(path, "rb") as f:
            f.seek(4)
            (tlen,) = np.frombuffer(f.read(4), dtype="<u4")
            base = 8 + int(tlen)
            for m in toc["members"]:
                if m["name"] == name:
                    continue
                f.seek(base + int(m["offset"]))
                members.append(m)
                blobs.append(f.read(int(m["length"])))
        meta = toc.get("meta", {})
    else:
        meta = {}
    buf = _io.BytesIO()
    write_stream(buf, ks, codec)
    off, entries = 0, []
    for m, b in zip(members, blobs):
        entries.append({**m, "offset": off})
        off += len(b)
    b = buf.getvalue()
    entries.append({"name": name, "offset": off, "length": len(b),
                    "k": ks.k, "n": int(ks.n),
                    "has_counts": ks.counts is not None})
    toc_b = json.dumps({"members": entries, "meta": meta}).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(CASKET_MAGIC)
        f.write(np.uint32(len(toc_b)).tobytes())
        f.write(toc_b)
        for blob in blobs:
            f.write(blob)
        f.write(b)
    os.replace(tmp, path)


def read_header(path: str) -> dict:
    """Header of a set: a ZKF path, a 'casket#member', or a bare casket
    (returns the TOC summary with 'casket': True)."""
    file, member = split_member(path)
    if member is not None:
        m, base = _casket_member_entry(file, member)
        with open(file, "rb") as f:
            f.seek(base + int(m["offset"]))
            return _read_header_stream(f, path)
    with open(file, "rb") as f:
        magic = f.read(4)
        if magic == CASKET_MAGIC:
            return {"casket": True, **casket_toc(file)}
        if magic != MAGIC:
            raise ValueError(f"{path}: not a ZKF file")
        (hlen,) = np.frombuffer(f.read(4), dtype="<u4")
        return json.loads(f.read(int(hlen)).decode("utf-8"))


class _ZChunkStream:
    """Incremental inflate of one length-prefixed zlib blob in a file
    region: read(nbytes) yields exactly nbytes (fewer at EOF) while holding
    only O(nbytes + 1 MB) in memory."""

    def __init__(self, f, start: int):
        f.seek(start)
        (zlen,) = np.frombuffer(f.read(8), dtype="<u8")
        self._f = f
        self._pos = start + 8
        self._end = self._pos + int(zlen)
        self.next_offset = self._end          # where the following blob starts
        self._d = zlib.decompressobj()
        self._buf = b""

    def read(self, nbytes: int) -> bytes:
        while len(self._buf) < nbytes:
            if self._pos >= self._end:
                self._buf += self._d.flush()
                break
            take = min(1 << 20, self._end - self._pos)
            self._f.seek(self._pos)
            raw = self._f.read(take)
            self._pos += len(raw)
            self._buf += self._d.decompress(raw)
        out, self._buf = self._buf[:nbytes], self._buf[nbytes:]
        return out


class ChunkReader:
    """Stream a set's (keys, counts) in fixed-size chunks with O(chunk)
    host RSS -- every codec, plain files and casket members alike. This is
    what lets `zotpu merge` combine N multi-GB runs without materializing
    any of them.

    Usage::

        r = ChunkReader(path)            # header only; no blob bytes read
        for keys, counts in r.chunks(1 << 22):
            ...                          # counts is None for a bare kset
    """

    def __init__(self, path: str):
        file, member = split_member(path)
        if member is not None:
            m, base = _casket_member_entry(file, member)
            off = base + int(m["offset"])
        else:
            off = 0
        with open(file, "rb") as f:
            f.seek(off)
            if member is None and f.read(4) == CASKET_MAGIC:
                names = [m["name"] for m in casket_toc(file)["members"]]
                raise ValueError(
                    f"{path} is a casket; address a member as "
                    f"{path}#<name> (members: {names})")
            f.seek(off)
            hdr = _read_header_stream(f, path)
            self._data0 = f.tell()
        self._file, self._label = file, path
        self.k = int(hdr["k"])
        self.n = int(hdr["n"])
        self.has_counts = bool(hdr["has_counts"])
        self.codec = hdr.get("codec", "raw")
        self.meta = hdr.get("meta", {})

    def chunks(self, chunk: int):
        if self.n == 0:
            return
        with open(self._file, "rb") as f:
            if self.codec == "raw":
                kpos, cpos = self._data0, self._data0 + 8 * self.n
                for lo in range(0, self.n, chunk):
                    m = min(chunk, self.n - lo)
                    f.seek(kpos)
                    keys = np.frombuffer(f.read(8 * m), dtype="<u8")
                    kpos += 8 * m
                    counts = None
                    if self.has_counts:
                        f.seek(cpos)
                        counts = np.frombuffer(f.read(4 * m), dtype="<u4")
                        cpos += 4 * m
                    self._check(keys, counts, m)
                    yield keys, counts
            elif self.codec == "zlib":
                ks = _ZChunkStream(f, self._data0)
                cs = (_ZChunkStream(f, ks.next_offset) if self.has_counts
                      else None)
                for lo in range(0, self.n, chunk):
                    m = min(chunk, self.n - lo)
                    keys = np.frombuffer(ks.read(8 * m), dtype="<u8")
                    counts = (np.frombuffer(cs.read(4 * m), dtype="<u4")
                              if cs is not None else None)
                    self._check(keys, counts, m)
                    yield keys, counts
            elif self.codec == "delta":
                ds = _ZChunkStream(f, self._data0)
                cs = (_ZChunkStream(f, ds.next_offset) if self.has_counts
                      else None)
                exc_at = cs.next_offset if cs is not None else ds.next_offset
                f.seek(exc_at)
                (n_exc,) = np.frombuffer(f.read(4), dtype="<u4")
                n_exc = int(n_exc)
                exc_pos = np.frombuffer(f.read(8 * n_exc),
                                        dtype="<u8").astype(np.int64)
                exc_key = np.frombuffer(f.read(8 * n_exc), dtype="<u8")
                exc_cnt = np.frombuffer(f.read(4 * n_exc), dtype="<u4")
                prev = np.uint64(0)
                for lo in range(0, self.n, chunk):
                    m = min(chunk, self.n - lo)
                    d32 = np.frombuffer(ds.read(4 * m), dtype="<u4")
                    if len(d32) != m:
                        raise ValueError(f"{self._label}: truncated container")
                    # per-chunk form of delta.decode: carry the running key,
                    # apply this chunk's exceptions with the same telescoping
                    # correction (patching row j shifts all later cumsums)
                    computed = prev + np.cumsum(d32, dtype=np.uint64)
                    counts = (np.frombuffer(cs.read(2 * m),
                                            dtype="<u2").astype(np.uint32)
                              if cs is not None else None)
                    sel = (exc_pos >= lo) & (exc_pos < lo + m)
                    if sel.any():
                        ep = exc_pos[sel] - lo
                        t = exc_key[sel] - computed[ep]      # wrapping u64
                        steps = np.diff(t, prepend=np.uint64(0))
                        corr = np.zeros(m, np.uint64)
                        corr[ep] = steps
                        computed = computed + np.cumsum(corr)
                        if counts is not None:
                            counts[ep] = exc_cnt[sel]
                    prev = computed[-1]
                    self._check(computed, counts, m)
                    yield computed, counts
            else:
                raise ValueError(f"{self._label}: unknown codec "
                                 f"{self.codec!r}")

    def _check(self, keys, counts, m):
        if len(keys) != m or (counts is not None and len(counts) != m):
            raise ValueError(f"{self._label}: truncated container")


def read(path: str) -> KmerSet:
    """Read a set: a ZKF path or 'casket.zkc#member'."""
    file, member = split_member(path)
    if member is not None:
        return casket_read(file, member)
    with open(file, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == CASKET_MAGIC:
            names = [m["name"] for m in casket_toc(file)["members"]]
            raise ValueError(
                f"{path} is a casket; address a member as "
                f"{path}#<name> (members: {names})")
        return read_stream(f, path)
