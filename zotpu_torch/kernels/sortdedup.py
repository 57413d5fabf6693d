"""K2: sort + dense dedup-compact of a batch's keys.

Port of zotpu/kernels/sortdedup.py ``kmer_sort_dedup`` /
``dedup_count_sorted`` and of the Pallas kernel
``dedup_pallas.dedup_compact_pallas``. ``lax.sort`` sat outside every Pallas
kernel, so its counterpart is ``torch.sort``. The sentinel-MARKED form
(``dedup_mark_sorted`` / ``compact_sorted``) is not ported: it existed to
skip a second XLA sort, and the port emits dense runs everywhere.

Output is dense: unique keys up front with their counts in
``[:n_unique]`` (a 0-d int64 device tensor), capacity = input length. Every
consumer (the accumulators, the receive tree) carries ``n_unique`` along
and reads only that prefix, so the CUDA kernel leaves the slots at or past
``n_unique`` unwritten: treat them as unspecified. The plain version fills
them with the sentinel / 0.
"""

from __future__ import annotations

import torch

from zotpu_torch import _build
from zotpu_torch.keys import SENTINEL


def dedup_compact_plain(keys):
    """Plain PyTorch version of dedup_compact (any device)."""
    n = keys.shape[0]
    valid = keys != SENTINEL
    first = valid.clone()
    first[1:] &= keys[1:] != keys[:-1]
    starts = torch.nonzero(first).reshape(-1)
    nu = starts.shape[0]
    ends = torch.cat([starts[1:], valid.sum().reshape(1)])
    ukeys = torch.full_like(keys, SENTINEL)
    counts = torch.zeros_like(keys)
    ukeys[:nu] = keys[starts]
    counts[:nu] = ends - starts
    return ukeys, counts, torch.tensor(nu, dtype=torch.int64,
                                       device=keys.device)


def dedup_compact(keys):
    """Sorted int64 keys with duplicates and a sentinel tail -> dense
    (ukeys, counts, n_unique), defined in ``[:n_unique]`` (see the module
    docstring). One pass over the keys, no sort."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"keys must be 1-D int64, got {tuple(keys.shape)} "
                         f"{keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if keys.device.type == "cpu":
        return dedup_compact_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    n = keys.shape[0]
    ukeys = torch.empty_like(keys)
    counts = torch.empty_like(keys)
    n_unique = torch.zeros((), dtype=torch.int64, device=keys.device)
    if n == 0:
        return ukeys, counts, n_unique
    lib = _build.lib()
    scratch = torch.empty(lib.zt_dedup_scratch_elems(n), dtype=torch.int64,
                          device=keys.device)
    _build.launch(keys.device, "zt_dedup_compact", keys.data_ptr(), n,
                  ukeys.data_ptr(), counts.data_ptr(), n_unique.data_ptr(),
                  scratch.data_ptr())
    dedup_compact.launches += 1
    return ukeys, counts, n_unique


def kmer_sort_dedup(keys):
    """A batch's pack output (any order, sentinel for invalid windows) ->
    dense sorted (ukeys, counts, n_unique)."""
    return dedup_compact(torch.sort(keys).values)


dedup_compact.launches = 0
