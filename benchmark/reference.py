"""The plain reference: what a kmerize and a scan of the generated reads
must give, in plain PyTorch, from the codes the benchmark made.

It imports nothing of zotpu_torch and reads nothing the program made. The
semantics are the project's byte-level policy: bases A=0, C=1, G=2, T=3,
any other code (4, N) invalidates every window over it; a k-mer packs its
first base into the most significant two bits; its canonical form is the
smaller of the forward key and the reverse complement's; a set is the
sorted unique canonical keys with their u32 occurrence counts.

``key_bits=32`` is the control: the same computation with every key held
in its low 32 bits, as a narrower packing would hold it. Keys that share
those bits then count as one (kmerize) or hit where they should not
(scan), which breaks the exactness the configurations state.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_READS = 1 << 16
LOW32 = (1 << 32) - 1


def canonical_windows(codes, k: int):
    """(R, L) uint8 codes -> (R, L - k + 1) int64 canonical keys, -1 where
    a window holds an invalid code."""
    R, L = codes.shape
    W = L - k + 1
    c = codes.to(torch.int64)
    bad = torch.zeros((R, L + 1), dtype=torch.int64, device=codes.device)
    bad[:, 1:] = torch.cumsum(c > 3, dim=1)
    c = c.clamp(max=3)
    fwd = torch.zeros((R, W), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        x = c[:, j:j + W]
        fwd = fwd * 4 + x
        rc += (3 - x) << (2 * j)
    key = torch.minimum(fwd, rc)
    key[bad[:, k:] - bad[:, :W] > 0] = -1
    return key


def _narrow(keys, key_bits: int):
    return keys if key_bits == 64 else keys & LOW32


def kmer_set(codes: np.ndarray, k: int, device, key_bits: int = 64):
    """The k-mer set of every read: (u64 keys, u32 counts) numpy arrays.

    With ``key_bits=32`` keys that agree in their low 32 bits are counted
    as one, under the smallest full key among them."""
    parts = []
    for lo in range(0, len(codes), BLOCK_READS):
        key = canonical_windows(
            torch.from_numpy(codes[lo:lo + BLOCK_READS]).to(device), k)
        parts.append(key[key >= 0])
    full = torch.cat(parts)
    del parts
    if key_bits == 64:
        keys, counts = torch.unique(full, sorted=True, return_counts=True)
    else:
        narrow, inv, counts = torch.unique(full & LOW32, sorted=True,
                                           return_inverse=True,
                                           return_counts=True)
        keys = torch.full_like(narrow, torch.iinfo(torch.int64).max)
        keys.scatter_reduce_(0, inv, full, reduce="amin")
        keys, order = torch.sort(keys)
        counts = counts[order]
    return (keys.cpu().numpy().astype(np.uint64),
            counts.cpu().numpy().astype(np.uint32))


def read_hits(codes: np.ndarray, panel: np.ndarray, k: int, device,
              key_bits: int = 64) -> np.ndarray:
    """Per read, the number of its valid windows whose canonical key is in
    the sorted u64 ``panel``: an (R,) int64 numpy array."""
    p = torch.unique(_narrow(torch.from_numpy(panel.astype(np.int64))
                             .to(device), key_bits))
    out = []
    for lo in range(0, len(codes), BLOCK_READS):
        key = canonical_windows(
            torch.from_numpy(codes[lo:lo + BLOCK_READS]).to(device), k)
        q = _narrow(key, key_bits)
        at = torch.searchsorted(p, q).clamp(max=p.shape[0] - 1)
        hit = (p[at] == q) & (key >= 0)
        out.append(hit.sum(dim=1).cpu())
    return torch.cat(out).numpy()
