"""The plain reference of the set-op cell: union, intersect, diff and the
cardinalities of two k-mer sets, in plain PyTorch with integer arithmetic
only.

It imports nothing of zotpu_torch and reads nothing the program made. Its
two sets are ``benchmark/reference.kmer_set`` of two groups of the
generated reads. The count policy is the project's: ``union`` keeps every
key of either set with the counts summed, ``intersect`` the keys of both
with the counts summed, each sum saturating at 2**32 - 1; ``diff`` keeps
the keys only in A with A's count. The cardinalities are |A|, |B|, |A^B|
and |AvB|.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference

COUNT_MAX = (1 << 32) - 1


def group_sets(codes: np.ndarray, bounds: np.ndarray, groups: dict, k: int,
               device, key_bits: int = 64) -> dict:
    """{group name: (u64 keys, u32 counts)}: each group the reads of its
    files (file i holds reads [bounds[i], bounds[i+1]))."""
    out = {}
    for name, files in groups.items():
        lo, hi = int(bounds[min(files)]), int(bounds[max(files) + 1])
        if list(files) != list(range(min(files), max(files) + 1)):
            raise ValueError(f"group {name}: files {files} are not a run")
        out[name] = reference.kmer_set(codes[lo:hi], k, device,
                                       key_bits=key_bits)
    return out


def _tensors(s, device):
    keys, counts = s
    return (torch.from_numpy(np.asarray(keys, np.uint64).view(np.int64))
            .to(device),
            torch.from_numpy(np.asarray(counts, np.uint32).astype(np.int64))
            .to(device))


def _numpy(keys, counts):
    return (keys.cpu().numpy().view(np.uint64).copy(),
            counts.cpu().numpy().astype(np.uint32))


def set_ops(a, b, device) -> dict:
    """{"union", "intersect", "diff": (u64 keys, u32 counts), "cards":
    {a, b, intersect, union}} of two sorted unique (u64 keys, u32 counts)
    sets with keys below 2**63."""
    ka, ca = _tensors(a, device)
    kb, cb = _tensors(b, device)
    at = torch.searchsorted(kb, ka)
    hit = torch.zeros_like(ka, dtype=torch.bool)
    if kb.numel():
        hit = kb[at.clamp(max=kb.numel() - 1)] == ka
    keys, inv = torch.unique(torch.cat([ka, kb]), sorted=True,
                             return_inverse=True)
    summed = torch.zeros_like(keys).index_add_(0, inv, torch.cat([ca, cb]))
    both = at[hit]
    n_int = int(hit.sum())
    return {
        "union": _numpy(keys, summed.clamp(max=COUNT_MAX)),
        "intersect": _numpy(ka[hit], (ca[hit] + cb[both]).clamp(
            max=COUNT_MAX)),
        "diff": _numpy(ka[~hit], ca[~hit]),
        "cards": {"a": len(ka), "b": len(kb), "intersect": n_int,
                  "union": len(ka) + len(kb) - n_int},
    }
