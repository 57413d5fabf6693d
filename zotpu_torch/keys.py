"""The port's key and count representation, and conversion to and from the
JAX package's.

Keys are int64 packed canonical k-mers. Valid keys stay below 2**62
(``semantics.K_MAX`` = 31), so int64 order is u64 order. Padding is
``SENTINEL`` = INT64_MAX, which sorts last (a sentinel of -1 would sort
first). It stands for the JAX package's (0xFFFFFFFF, 0xFFFFFFFF) (hi, lo)
pair and ``semantics.SENTINEL_KEY``. Counts are int64 on the device and
hold u32 values saturating at ``COUNT_MAX``.
"""

from __future__ import annotations

import numpy as np
import torch

from zotpu import semantics as S

SENTINEL = (1 << 63) - 1
COUNT_MAX = int(S.COUNT_MAX)


def from_hi_lo(hi, lo, cnt=None, device="cpu"):
    """(hi, lo) u32 key words (and u32 counts) -> int64 tensors on device.
    The (0xFFFFFFFF, 0xFFFFFFFF) sentinel becomes ``SENTINEL``."""
    k = S.join_hi_lo(np.asarray(hi), np.asarray(lo))
    sent = k == S.SENTINEL_KEY
    if np.any(k[~sent] >= np.uint64(1 << 62)):
        raise ValueError("key >= 2**62 that is not the sentinel")
    keys = torch.from_numpy(np.where(sent, np.uint64(SENTINEL), k)
                            .astype(np.int64)).to(device)
    if cnt is None:
        return keys
    counts = torch.from_numpy(np.asarray(cnt, np.uint32).astype(np.int64))
    return keys, counts.to(device)


def to_hi_lo(keys, counts=None):
    """Inverse of from_hi_lo: int64 keys (and counts) -> numpy u32 arrays."""
    k = keys.cpu().numpy().astype(np.uint64)
    k = np.where(k == np.uint64(SENTINEL), S.SENTINEL_KEY, k)
    hi, lo = S.split_hi_lo(k)
    if counts is None:
        return hi, lo
    return hi, lo, counts.cpu().numpy().astype(np.uint32)


def to_numpy_set(keys, counts, n: int):
    """The dense prefix [:n] as the (u64 keys, u32 counts) pair that
    ``container.KmerSet`` takes."""
    n = int(n)
    return (keys[:n].cpu().numpy().astype(np.uint64),
            counts[:n].cpu().numpy().astype(S.COUNT_DTYPE))
