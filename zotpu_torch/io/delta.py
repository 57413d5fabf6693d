"""Host-side delta codec for sorted u64 key arrays (+ optional counts).

A copy of zotpu/io/delta.py.

The container's "delta" codec (io/container.py, host encodes and decodes).
In the JAX package it is shared with a D2H wire format (io/wire_result.py),
which the port does not carry: a plain D2H copy serves.

Scheme: keys are sorted, so consecutive deltas almost always fit u32
(mean gap of a 33M-key k=25 set over 2^50 is ~2^25) and counts almost
always fit u16. Store truncated u32 deltas + clamped u16 counts, plus an
exception list (position, true key, true count) for rows whose delta
overflows u32 or whose count exceeds 65535. Decoding cumsums the deltas
and applies a telescoping correction at each exception: patching
exception j's key shifts every later cumsum by the same amount, so one
diff + one extra cumsum reconstructs exactly (wrapping u64 arithmetic).

Reference analog: zotmer's container stores compressed int-vector
encodings of sorted k-mer arrays (SURVEY.md section 2a container row,
unverified -- reference mount empty). Numpy only (container tooling runs
host-side).
"""

from __future__ import annotations

import numpy as np


def encode(keys: np.ndarray, counts: np.ndarray | None):
    """Sorted u64 keys (+ optional u32 counts) -> delta arrays + exceptions.

    Returns (d32, c16, exc_pos, exc_key, exc_cnt):
      d32   u32[n]  truncated deltas (keys[i] - keys[i-1], keys[-1] := 0)
      c16   u16[n]  clamped counts, or None when counts is None
      exc_pos u64[e] positions needing patching
      exc_key u64[e] true keys at those positions
      exc_cnt u32[e] true counts there (zeros when counts is None)
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    prev = np.concatenate([np.zeros(1, np.uint64), keys[:-1]])
    d = keys - prev
    is_exc = (d >> np.uint64(32)) != 0
    if counts is not None:
        counts = np.ascontiguousarray(counts, dtype=np.uint32)
        is_exc = is_exc | (counts > 65535)
        c16 = np.minimum(counts, 65535).astype(np.uint16)
    else:
        c16 = None
    d32 = d.astype(np.uint32)  # truncating; exceptions carry the true key
    exc_pos = np.nonzero(is_exc)[0].astype(np.uint64)
    exc_key = keys[exc_pos.astype(np.int64)]
    exc_cnt = (counts[exc_pos.astype(np.int64)] if counts is not None
               else np.zeros(len(exc_pos), np.uint32))
    return d32, c16, exc_pos, exc_key, exc_cnt


def decode(d32, c16, exc_pos, exc_key, exc_cnt, n: int):
    """Exact inverse of encode for the first n rows.

    c16 may be None (bare kset); then the returned counts are None.
    exc arrays may extend past n (wire padding) -- rows >= n are ignored.
    """
    if n == 0:
        return (np.empty(0, np.uint64),
                None if c16 is None else np.empty(0, np.uint32))
    computed = np.cumsum(d32[:n], dtype=np.uint64)
    counts = None if c16 is None else c16[:n].astype(np.uint32)
    ep = np.asarray(exc_pos).astype(np.int64)
    keep = ep < n
    ep = ep[keep]
    if len(ep):
        ekey = np.asarray(exc_key, np.uint64)[keep]
        t = ekey - computed[ep]                 # wrapping u64
        steps = np.diff(t, prepend=np.uint64(0))
        corr = np.zeros(n, np.uint64)
        corr[ep] = steps
        computed = computed + np.cumsum(corr)   # wrapping u64
        if counts is not None:
            counts[ep] = np.asarray(exc_cnt, np.uint32)[keep]
    return computed, counts
