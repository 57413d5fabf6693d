"""K6: merge of two sorted runs with a dense dedup-compact after it.

Port of the Pallas kernel ``dedup_pallas.merged_dedup_compact_pass`` /
``merged_dedup_compact_pair`` (reached through ``_call_merged_dedup``),
the last level of the sharded kmerize receive tree
(``dist.shuffle.merge_received_runs(dedup=True)``). The inputs are raw
routed keys, ascending runs A = [:nA] and B = [nA:] with duplicates on
both sides and INT64_MAX pads; an equal-key segment may be any length.
The output is dense: the unique keys up front with int64 occurrence counts
in ``[:n_out]`` (a 0-d int64 device tensor); as with K2, the slots at or
past ``n_out`` are unspecified on a CUDA tensor and INT64_MAX / 0 from
the plain version. Its capacity is the input
length: the TPU's append slack (``dedup_out_cap``) is not kept. ``nB = 0``
is a single-run dedup.

The CUDA kernel (csrc/merge_runs.cu) is one pass: it merges tiles of the
valid elements in registers, marks the segment starts, and writes the
unique keys and counts dense, so the merged array never reaches device
memory and the sentinel capacity is not read; K2's closing kernel then
ends each tile's last segment. The scratch is a few words per tile. On a
CPU tensor the wrapper runs the plain version: a stable sort, then K2's
plain version. A call counts its unique keys out as ``tree.k6_keys_out``
(metrics.count_device); its valid keys in are found on the device, so
the caller that knows them counts them (``dist/shuffle``).
"""

from __future__ import annotations

import torch

from zotpu_torch import _build, metrics
from zotpu_torch.kernels.sortdedup import dedup_compact_plain


def merge_dedup_plain(keys, nA: int):
    """Plain PyTorch version of merge_dedup_pair (any device)."""
    return dedup_compact_plain(torch.sort(keys, stable=True).values)


def merge_dedup_pair(keys, nA: int):
    """Ascending A = [:nA] and B = [nA:] -> dense (ukeys, counts, n_out) of
    their merge."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"keys must be 1-D int64, got {tuple(keys.shape)} "
                         f"{keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    n = keys.shape[0]
    if not 0 <= nA <= n:
        raise ValueError(f"nA={nA} outside [0, {n}]")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    out = (merge_dedup_plain(keys, nA) if keys.device.type == "cpu"
           else _merge_dedup_cuda(keys, nA))
    metrics.count_device("tree.k6_keys_out", out[2])
    return out


def _merge_dedup_cuda(keys, nA: int):
    n = keys.shape[0]
    ukeys = torch.empty_like(keys)
    counts = torch.empty_like(keys)
    n_out = torch.zeros((), dtype=torch.int64, device=keys.device)
    if n == 0:
        return ukeys, counts, n_out
    lib = _build.lib()
    scratch = torch.empty(lib.zt_merge_dedup_scratch_elems(n),
                          dtype=torch.int64, device=keys.device)
    _build.launch(keys.device, "zt_merge_dedup", keys.data_ptr(), n, nA,
                  ukeys.data_ptr(), counts.data_ptr(), n_out.data_ptr(),
                  scratch.data_ptr())
    merge_dedup_pair.launches += 1
    return ukeys, counts, n_out


def merge_dedup_pass(keys, run: int):
    """One pair of equal runs of ``run`` (the length is 2 * run), merged
    and deduplicated: ``merged_dedup_compact_pass``'s contract."""
    if keys.shape[0] != 2 * run:
        raise ValueError(f"merge_dedup_pass takes one pair: length "
                         f"{keys.shape[0]} != 2 * {run}")
    return merge_dedup_pair(keys, run)


merge_dedup_pair.launches = 0
