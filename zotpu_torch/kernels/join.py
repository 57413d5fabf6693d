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
launches the kernels of csrc/join.cu (a bucket directory over the panel,
built on every call, then one short search per window) or raises; so the
kernel is held against an independent algorithm. The sparse
hit-tag path and its dense fallback (join.py:262-273) are not ported: they
worked around the TPU's lack of gather and scatter, and the kernel has no
capacity that could truncate.

``row_hits_tagged`` is the entry of the sharded pulldown, whose routed
probe streams hold any population of rows: each probe carries its row id
(``shuffle.make_pulldown_step``'s ``_join_pallas_star`` then
``_rowsum_by_key``). Its kernel searches one probe a thread and adds each
hit into its row atomically; its plain version keeps the same sort-merge
join, then ``_rowsum_by_key``.
"""

from __future__ import annotations

import torch

from zotpu_torch import _build
from zotpu_torch.keys import SENTINEL


def _check_keys(panel, probes) -> None:
    for name, t in (("panel", panel), ("probes", probes)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int64, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if panel.device != probes.device:
        raise ValueError("panel and probes must be on one device")
    if panel.shape[0] >= 1 << 31:
        raise ValueError(f"a panel of {panel.shape[0]} slots exceeds the "
                         f"kernel's int32 directory; shard the panel")


def _check(panel, probes, n_rows: int, m_per_row: int) -> None:
    _check_keys(panel, probes)
    m = probes.shape[0]
    if n_rows * m_per_row != m:
        raise ValueError(f"query length {m} != {n_rows} x {m_per_row}")
    if n_rows >= 1 << 30:
        raise ValueError(f"batch of {n_rows} rows exceeds the 2^30 "
                         f"row*2+hit key budget; split the batch")
    if m_per_row >= 1 << 31:
        raise ValueError(f"{m_per_row} windows a row exceed the kernel's "
                         f"int32 row width")


def _join_star(panel, probes, tags, n_rows: int):
    """The JAX package's sort-merge join (``_transform_keys``,
    ``_join_xla_star``, ``_hits_from_merged_star``): bkey =
    min(tag, n_rows) * 2 + hit for every element of the merged stream.

    key* = key*2 + is_probe puts the panel key first in its equal-key
    segment, and a probe hits iff its segment starts with a panel key
    (one cummax of the segment leads). Validity comes from the original
    key, not from key*: a valid key of 2**62 - 1 has a probe key* of
    2**63 - 1, which is SENTINEL itself, so every sentinel maps to SENTINEL
    too and carries a flag that it is not a valid key. Panel rows carry
    the tag n_rows and sink past every probe row."""
    dev = probes.device
    n_p = panel.shape[0]
    p_ok, q_ok = panel != SENTINEL, probes != SENTINEL
    star = torch.cat([torch.where(p_ok, panel * 2, SENTINEL),
                      torch.where(q_ok, probes * 2 + 1, SENTINEL)])
    tag = torch.cat([torch.full((n_p,), n_rows, dtype=torch.int64,
                                device=dev),
                     torch.clamp(tags, max=n_rows)])
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
    return tag * 2 + hit.to(torch.int64)


def _scratch(panel):
    """The words the kernels' bucket directory takes for this panel."""
    return torch.empty(_build.lib().zt_join_scratch_elems(panel.shape[0]),
                       dtype=torch.int64, device=panel.device)


def row_hits_plain(panel, probes, n_rows: int, m_per_row: int):
    """Plain PyTorch version of row_hits_sorted_join (any device): the JAX
    package's sort-merge join, then ``_rowsum_by_idx``: each row id appears
    m_per_row times, so after one sort of row*2+hit row r owns
    [r*m_per_row, (r+1)*m_per_row)."""
    tags = torch.arange(n_rows, device=probes.device).repeat_interleave(
        m_per_row)
    bkey = torch.sort(_join_star(panel, probes, tags, n_rows)).values
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
        _build.launch(probes.device, "zt_join_row_hits", panel.data_ptr(),
                      panel.shape[0], probes.data_ptr(), n_rows, m_per_row,
                      out.data_ptr(), _scratch(panel).data_ptr())
        row_hits_sorted_join.launches += 1
    return out


row_hits_sorted_join.launches = 0


def row_hits_tagged_plain(panel, probes, tags, n_rows: int):
    """Plain PyTorch version of row_hits_tagged (any device): the JAX
    package's sort-merge join, then ``_rowsum_by_key``: one sort of
    bkey, and row r's hits are the span between the searchsorted edges of
    2r + 1 and 2r + 2."""
    s = torch.sort(_join_star(panel, probes, tags, n_rows)).values
    bins = torch.arange(n_rows, device=probes.device)
    left = torch.searchsorted(s, bins * 2 + 1)
    right = torch.searchsorted(s, bins * 2 + 2)
    return (right - left).to(torch.int32)


def row_hits_tagged(panel, probes, tags, n_rows: int):
    """Per-row panel-hit counts of a probe stream whose rows are given
    explicitly: (n_rows,) int32, where row r counts the probes with tag r
    that are not SENTINEL and are in the panel. Tags outside [0, n_rows)
    never count. The probes need not be sorted and a row may hold any
    number of them (the routed streams of the sharded pulldown)."""
    if tags.dtype != torch.int64 or tags.shape != probes.shape:
        raise ValueError(f"tags must be int64 of the probes' shape, got "
                         f"{tuple(tags.shape)} {tags.dtype}")
    if tags.device != probes.device or not tags.is_contiguous():
        raise ValueError("tags must be contiguous on the probes' device")
    _check_keys(panel, probes)
    if probes.device.type == "cpu":
        return row_hits_tagged_plain(panel, probes, tags, n_rows)
    if probes.device.type != "cuda":
        raise ValueError(f"unsupported device {probes.device}")
    out = torch.zeros(n_rows, dtype=torch.int32, device=probes.device)
    if n_rows and probes.shape[0]:
        _build.launch(probes.device, "zt_join_row_hits_tagged",
                      panel.data_ptr(), panel.shape[0], probes.data_ptr(),
                      tags.data_ptr(), probes.shape[0], n_rows,
                      out.data_ptr(), _scratch(panel).data_ptr())
        row_hits_tagged.launches += 1
    return out


row_hits_tagged.launches = 0
