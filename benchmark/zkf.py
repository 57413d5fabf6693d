"""The raw ZKF layout, read and written by the benchmark itself.

    bytes 0..4   magic b"ZKF1"
    bytes 4..8   u32 little-endian length H of the JSON header
    bytes 8..8+H JSON header {"k", "n", "has_counts", "codec", "meta"}
    then         n u64 little-endian keys
    then         n u32 little-endian counts, iff has_counts

Only the "raw" codec: the configurations name it. The reader works on a
bytes-like object and returns views, so a 179 MB container is judged
without a copy.
"""

from __future__ import annotations

import json

import numpy as np

MAGIC = b"ZKF1"


def write(f, k: int, keys: np.ndarray, counts: np.ndarray | None = None,
          meta: dict | None = None) -> None:
    """Write one raw ZKF stream of sorted unique u64 ``keys`` (and u32
    ``counts``) to an open binary file."""
    hdr = json.dumps({"k": k, "n": int(len(keys)),
                      "has_counts": counts is not None, "codec": "raw",
                      "meta": meta or {}}).encode()
    f.write(MAGIC)
    f.write(np.uint32(len(hdr)).tobytes())
    f.write(hdr)
    f.write(np.ascontiguousarray(keys, "<u8").tobytes())
    if counts is not None:
        f.write(np.ascontiguousarray(counts, "<u4").tobytes())


def read(buf) -> tuple[dict, memoryview, memoryview | None]:
    """(header, keys bytes, counts bytes or None) of one raw ZKF stream
    held in ``buf``; raises ValueError on any other layout or length."""
    mv = memoryview(buf).cast("B")
    if bytes(mv[:4]) != MAGIC:
        raise ValueError("not a ZKF stream")
    hlen = int(np.frombuffer(mv[4:8], "<u4")[0])
    hdr = json.loads(bytes(mv[8:8 + hlen]))
    if hdr.get("codec") != "raw":
        raise ValueError(f"codec {hdr.get('codec')!r} is not raw")
    n = int(hdr["n"])
    at = 8 + hlen
    keys = mv[at:at + 8 * n]
    at += 8 * n
    counts = None
    if hdr["has_counts"]:
        counts = mv[at:at + 4 * n]
        at += 4 * n
    if len(keys) != 8 * n or (counts is not None and len(counts) != 4 * n) \
            or at != len(mv):
        raise ValueError(f"stream of {len(mv)} bytes does not hold the "
                         f"{n} entries its header states")
    return hdr, keys, counts
