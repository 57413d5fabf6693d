"""K4: membership join of read windows against a sorted k-mer panel,
summed per read row.

Port of zotpu/kernels/join.py ``row_hits_sorted_join`` and of the Pallas
kernel ``sort_pallas.stream_join_pair_pallas`` (reached through
``join._join_pallas_star``), together with the stable probe sort before it
and the row sums after it. The panel is a sorted, unique, SENTINEL-padded
int64 tensor; the probes are the pack kernel's int64 keys in window order,
``m_per_row`` windows for each of ``n_rows`` rows. Every valid window
counts: repeats within a read, and both strands of one canonical key.

On a CPU tensor the wrapper runs the plain version, which keeps the JAX
package's sort-merge formulation (``_transform_keys``, ``_join_xla_star``,
``_hits_from_merged_star``, ``_rowsum_by_idx``). On a CUDA tensor it
launches the kernel of csrc/join.cu, one binary search per window, or
raises; so the kernel is held against an independent algorithm. The sparse
hit-tag path and its dense fallback (join.py:262-273) are not ported: they
worked around the TPU's lack of gather and scatter, and the kernel has no
capacity that could truncate.
"""

from __future__ import annotations

import torch

from zotpu_torch import _build
from zotpu_torch.keys import SENTINEL


def _check(panel, probes, n_rows: int, m_per_row: int) -> None:
    for name, t in (("panel", panel), ("probes", probes)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int64, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if panel.device != probes.device:
        raise ValueError("panel and probes must be on one device")
    m = probes.shape[0]
    if n_rows * m_per_row != m:
        raise ValueError(f"query length {m} != {n_rows} x {m_per_row}")
    if n_rows >= 1 << 30:
        raise ValueError(f"batch of {n_rows} rows exceeds the 2^30 "
                         f"row*2+hit key budget; split the batch")
    if m_per_row >= 1 << 31:
        raise ValueError(f"{m_per_row} windows a row exceed the kernel's "
                         f"int32 row width")


def row_hits_plain(panel, probes, n_rows: int, m_per_row: int):
    """Plain PyTorch version of row_hits_sorted_join (any device): the JAX
    package's sort-merge join.

    key* = key*2 + is_probe puts the panel key first in its equal-key
    segment, and a probe hits iff its segment starts with a panel key
    (one cummax of the segment leads). Validity comes from the original
    key, not from key*: a valid key of 2**62 - 1 has a probe key* of
    2**63 - 1, which is SENTINEL itself, so every sentinel maps to SENTINEL
    too and carries a flag that it is not a valid key."""
    dev = probes.device
    n_p = panel.shape[0]
    p_ok, q_ok = panel != SENTINEL, probes != SENTINEL
    star = torch.cat([torch.where(p_ok, panel * 2, SENTINEL),
                      torch.where(q_ok, probes * 2 + 1, SENTINEL)])
    # row-id tags; panel rows carry n_rows and sink past every probe row
    tag = torch.cat([torch.full((n_p,), n_rows, dtype=torch.int64,
                                device=dev),
                     torch.arange(n_rows, device=dev).repeat_interleave(
                         m_per_row)])
    is_panel = torch.cat([p_ok, torch.zeros_like(q_ok)])
    is_probe = torch.cat([torch.zeros_like(p_ok), q_ok])
    star, order = torch.sort(star, stable=True)
    tag, is_panel, is_probe = tag[order], is_panel[order], is_probe[order]
    key = star >> 1
    first = torch.ones_like(is_panel)
    first[1:] = key[1:] != key[:-1]
    pos = torch.arange(star.shape[0], device=dev)
    lead = torch.where(first, pos * 2 + is_panel.to(torch.int64), -1)
    lead = torch.cummax(lead, dim=0).values
    hit = is_probe & ((lead & 1) == 1)
    # _rowsum_by_idx: each row id appears m_per_row times, so after one
    # sort of row*2+hit row r owns [r*m_per_row, (r+1)*m_per_row)
    bkey = torch.sort(tag * 2 + hit.to(torch.int64)).values
    hits = (bkey[:n_rows * m_per_row] & 1).to(torch.int32)
    return hits.reshape(n_rows, m_per_row).sum(dim=1, dtype=torch.int32)


def row_hits_sorted_join(panel, probes, n_rows: int, m_per_row: int):
    """Per-row panel-hit counts: (n_rows,) int32, where row r counts the
    windows probes[r*m_per_row:(r+1)*m_per_row] that are not SENTINEL and
    are in the panel."""
    _check(panel, probes, n_rows, m_per_row)
    if probes.device.type == "cpu":
        return row_hits_plain(panel, probes, n_rows, m_per_row)
    if probes.device.type != "cuda":
        raise ValueError(f"unsupported device {probes.device}")
    out = torch.empty(n_rows, dtype=torch.int32, device=probes.device)
    if n_rows:
        lib = _build.lib()
        _build.check(lib.zt_join_row_hits(
            panel.data_ptr(), panel.shape[0], probes.data_ptr(), n_rows,
            m_per_row, out.data_ptr(),
            torch.cuda.current_stream(probes.device).cuda_stream),
            "zt_join_row_hits")
        row_hits_sorted_join.launches += 1
    return out


row_hits_sorted_join.launches = 0
