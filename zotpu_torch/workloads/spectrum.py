"""Spectrum workload (BASELINE config 4): k-mer frequency histogram with
error-peak cutoff and genome-size estimate over a full run.

Port of zotpu/workloads/spectrum.py: the counts go up to the device, the
count-of-counts histogram (kernels/hist.py) comes back, and the mixture fit
(stats.py) runs on the host over the histogram.
"""

from __future__ import annotations

import numpy as np
import torch

from zotpu_torch import stats as ST
from zotpu_torch.kernels import hist as K


def spectrum(counts: np.ndarray, max_count: int = 1024,
             device="cuda") -> np.ndarray:
    """Device count-of-counts histogram (tail accumulates in the last bin)."""
    c = torch.from_numpy(np.asarray(counts).astype(np.int64)).to(device)
    return K.spectrum(c, max_count=max_count).cpu().numpy()


def spectrum_with_cutoff(counts: np.ndarray, max_count: int = 1024,
                         device="cuda") -> dict:
    h = spectrum(counts, max_count=max_count, device=device)
    cut, lam_g, gsize = ST.spectrum_mixture_fit(h.astype(np.float64))
    return {"hist": h, "cutoff": int(cut), "coverage_peak": float(lam_g),
            "genome_size_estimate": int(gsize),
            "solid_kmers": int(h[int(cut):].sum())}
