"""The scan job: a sequencing run's samples screened against a k-mer panel
through the calls the CLI's ``scan`` makes.

One job is ``io.container.read`` of the panel's ZKF file, then
``workloads.pulldown.pulldown_paths`` of its keys over every sample file
of the cell: per sample its total hits, its reads with hits and its
per-read hits.

Judged: every job's per-sample results against the reference's per-read
hits of the generated reads. Each number compared is the largest over the
window's jobs and must be 0:

- ``reads_off``: reads whose hits differ, a read missing or extra
  counting as one;
- ``totals_off``: the sum over samples of the gaps in total hits and in
  reads with hits.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference

LIMITS = {"reads_off": 0, "totals_off": 0}


class Job:
    def __init__(self, cfg: dict, inputs, devices):
        self.cfg, self.inputs = cfg, inputs
        self.devices = devices
        sizes = np.diff(inputs.bounds)
        self.batches = int(sum(-(-s // cfg["batch_reads"]) for s in sizes))

    def run(self, span) -> dict:
        from zotpu_torch.io import container
        from zotpu_torch.workloads import pulldown
        cfg = self.cfg
        with span("container"):
            panel = container.read(self.inputs.panel_path)
        results = pulldown.pulldown_paths(
            panel.keys, self.inputs.paths, panel.k,
            batch_reads=cfg["batch_reads"], max_len=cfg["max_len"],
            device=self.devices[0])
        return {"bases": self.inputs.bases, "batches": self.batches,
                "output": results}

    def host_pipeline(self) -> int:
        """Drain the host iterator a job drives (parse, wire pack, pin)
        with no device step; returns the bases it parsed."""
        from zotpu_torch.workloads import pulldown
        cfg = self.cfg
        bases = 0
        for _, batch, _ in pulldown._iter_scan_batches(
                self.inputs.paths, cfg["batch_reads"], cfg["max_len"],
                cfg["k"], cfg["max_len"] % 32 == 0,
                self.devices[0].type == "cuda"):
            bases += batch.bases
        return bases

    def expected(self, device, key_bits: int = 64):
        hits = reference.read_hits(self.inputs.codes, self.inputs.panel,
                                   self.cfg["k"], device, key_bits=key_bits)
        b = self.inputs.bounds
        return [hits[b[i]:b[i + 1]] for i in range(len(b) - 1)]

    def render(self, result) -> list:
        """A reference result in a job's output form (the control)."""
        return [(int(h.sum()), int((h > 0).sum()), h.tolist())
                for h in result]

    def compare(self, outputs, want) -> list:
        """One reading a job's output: {number compared: value}."""
        readings = []
        for out in outputs:
            reads_off = totals_off = 0
            for i, w in enumerate(want):
                if i >= len(out):
                    reads_off += len(w)
                    totals_off += int(w.sum()) + int((w > 0).sum())
                    continue
                total, with_hits, per_read = out[i]
                got = np.asarray(per_read, np.int64)
                n = min(len(got), len(w))
                reads_off += (int((got[:n] != w[:n]).sum())
                              + abs(len(got) - len(w)))
                totals_off += (abs(total - int(w.sum()))
                               + abs(with_hits - int((w > 0).sum())))
            reads_off += sum(len(r[2]) for r in out[len(want):])
            readings.append({"reads_off": reads_off,
                             "totals_off": totals_off})
        return readings
