"""k-mer frequency spectrum (count of counts) on the device.

Port of zotpu/kernels/hist.py ``spectrum``, which is XLA code, not a Pallas
kernel: it sorts the clamped counts and reads the bin edges with
``searchsorted`` because the TPU has no fast scatter-add. A GPU has one, so
the port is ``torch.bincount`` over the same clamp; no kernel is written by
hand for it. Held equal to the JAX function and to ``golden.spectrum``.
"""

from __future__ import annotations

import torch


def spectrum(counts: torch.Tensor, max_count: int = 1024) -> torch.Tensor:
    """int64 counts (0 = padding) -> int32 histogram of length max_count+1.

    hist[v] = number of k-mers with count v (v in 1..max_count-1);
    hist[max_count] accumulates every count >= max_count; hist[0] is 0
    (padding rows are excluded, matching golden.spectrum on real counts)."""
    if counts.dtype != torch.int64 or counts.dim() != 1:
        raise ValueError("counts must be a 1-D int64 tensor")
    hist = torch.bincount(torch.clamp(counts, max=max_count),
                          minlength=max_count + 1).to(torch.int32)
    hist[0] = 0
    return hist
