"""A cell's inputs, made from ``--seed`` on the device: a genome, the reads
of a sequencing run of it, their FASTQ files and, for a scan, the panel.

A frozen copy of the coverage recipe of ``chip_smoke.py`` (``make_reads``,
``write_fastq``, ``make_panel``, ``write_fixture``, itself the recipe of
``zotpu/bench/harness.py`` ``_Fixture``), moved onto the device's
``torch.Generator`` so that set-up draws 139M bases in a few large calls:

- the genome: ``genome_bp`` uniform random bases;
- ``round(coverage * genome_bp / read_len)`` reads of ``read_len`` bases at
  uniform random offsets; then ``int(bases * sub_rate)`` substitutions to a
  uniform random base and ``int(bases * n_rate)`` N codes, at uniform
  random positions. The copy draws each position once (a position drawn
  twice is set once), so that a seed gives the same reads on every run;
- FASTQ records ``@r<7-digit read number>``, the bases, ``+``, and ``I``
  qualities; ``files`` files of consecutive reads (the split of
  ``write_fixture``: ``linspace`` bounds);
- the panel: the canonical k-mers of the genome's first ``panel_bp``
  bases, sorted unique, written as a raw ZKF set without counts (the
  copy leaves out ``make_panel``'s uniform random keys: no genome holds
  them).

Every seed gets the same sizes; the seed moves only what is drawn.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from benchmark import reference, zkf

FASTQ_CHUNK_READS = 1 << 17
ID_DIGITS = 7


@dataclasses.dataclass
class Inputs:
    codes: np.ndarray            # (n_reads, read_len) uint8, 4 = N
    paths: list                  # FASTQ files, consecutive reads each
    bounds: np.ndarray           # file i holds reads [bounds[i], bounds[i+1])
    panel: np.ndarray | None     # sorted unique u64 panel keys
    panel_path: str | None

    @property
    def bases(self) -> int:
        return int(self.codes.size)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed & ((1 << 64) - 1))
    return g


def _unique_positions(g, n_draw: int, size: int, device):
    return torch.unique(torch.randint(0, size, (n_draw,), generator=g,
                                      device=device))


def make_reads(cfg: dict, g, device):
    """(genome, codes) uint8 device tensors by the recipe above."""
    G, L = cfg["genome_bp"], cfg["read_len"]
    n = round(cfg["coverage"] * G / L)
    if n >= 10 ** ID_DIGITS:
        raise ValueError(f"{n} reads do not fit {ID_DIGITS}-digit read ids")
    genome = torch.randint(0, 4, (G,), generator=g, device=device,
                           dtype=torch.uint8)
    offs = torch.randint(0, G - L, (n,), generator=g, device=device)
    codes = genome[offs[:, None] + torch.arange(L, device=device)]
    flat = codes.view(-1)
    pos = _unique_positions(g, int(n * L * cfg["sub_rate"]), n * L, device)
    flat[pos] = torch.randint(0, 4, pos.shape, generator=g, device=device,
                              dtype=torch.uint8)
    flat[_unique_positions(g, int(n * L * cfg["n_rate"]), n * L, device)] = 4
    return genome, codes


def fastq_records(codes, first_id: int):
    """FASTQ records of (n, L) uint8 device codes as one (n, 14 + 2L)
    uint8 device tensor, read ids from ``first_id``."""
    n, L = codes.shape
    dev = codes.device
    rec = torch.empty((n, 10 + 2 * L + 4), dtype=torch.uint8, device=dev)
    ids = torch.arange(first_id, first_id + n, device=dev)
    pow10 = 10 ** torch.arange(ID_DIGITS - 1, -1, -1, device=dev)
    rec[:, 0] = ord("@")
    rec[:, 1] = ord("r")
    rec[:, 2:9] = ((ids[:, None] // pow10) % 10 + ord("0")).to(torch.uint8)
    rec[:, 9] = ord("\n")
    lut = torch.tensor(list(b"ACGTN"), dtype=torch.uint8, device=dev)
    rec[:, 10:10 + L] = lut[codes.to(torch.int64)]
    rec[:, 10 + L] = ord("\n")
    rec[:, 11 + L] = ord("+")
    rec[:, 12 + L] = ord("\n")
    rec[:, 13 + L:13 + 2 * L] = ord("I")
    rec[:, 13 + 2 * L] = ord("\n")
    return rec


def write_fastqs(codes, n_files: int, tmp: str):
    """``n_files`` FASTQ files of consecutive reads; (paths, bounds)."""
    n = codes.shape[0]
    bounds = np.linspace(0, n, n_files + 1).astype(np.int64)
    paths = []
    for i in range(n_files):
        path = os.path.join(tmp, f"reads{i:02d}.fastq")
        with open(path, "wb") as f:
            for lo in range(bounds[i], bounds[i + 1], FASTQ_CHUNK_READS):
                hi = min(lo + FASTQ_CHUNK_READS, bounds[i + 1])
                f.write(fastq_records(codes[lo:hi], lo).cpu().numpy())
        paths.append(path)
    return paths, bounds


def make_panel(cfg: dict, genome) -> np.ndarray:
    keys = reference.canonical_windows(genome[None, :cfg["panel_bp"]],
                                       cfg["k"])
    return torch.unique(keys).cpu().numpy().astype(np.uint64)


def make_inputs(cfg: dict, traffic: dict, seed: int, device,
                tmp: str) -> Inputs:
    """Everything a cell's jobs and its reference read, from the seed."""
    g = generator(seed, device)
    genome, codes = make_reads(cfg, g, device)
    paths, bounds = write_fastqs(codes, traffic["files"], tmp)
    panel = panel_path = None
    if "panel_bp" in cfg:
        panel = make_panel(cfg, genome)
        panel_path = os.path.join(tmp, "panel.zkf")
        with open(panel_path, "wb") as f:
            zkf.write(f, cfg["k"], panel)
    return Inputs(codes=codes.cpu().numpy(), paths=paths, bounds=bounds,
                  panel=panel, panel_path=panel_path)
