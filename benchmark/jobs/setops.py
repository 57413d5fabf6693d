"""The set-op job: two k-mer sets compared through the entries the CLI's
``union``, ``intersect``, ``diff`` and ``jaccard`` call, one command after
another.

At set-up the plain reference counts the reads of each group of files
(``cfg["groups"]``: A and B) into a set, and the first job writes both as
raw ZKF files beside the reads (``benchmark/zkf.py``). One job is then, in
turn, ``workloads.setops.set_op_paths(A, B, op)`` for op in union,
intersect and diff, each followed by ``io.container.write_stream`` of the
result with the CLI's meta into the kmerize job's ``Sink``, and
``workloads.setops.jaccard_paths(A, B)``: each command reads both files, so
a job reads them four times. A job's bases are the cell's sequenced bases,
which the two sets summarise.

Judged: every job's three containers and its cardinalities against
``benchmark/setops_reference.py``. Each number compared is the largest
over the window's jobs and must be 0:

- ``header_off``, ``keys_off``, ``counts_off``: as the kmerize job judges
  one container, summed over the three;
- ``cards_off``: the sum of the absolute gaps in a, b, intersect and
  union.
"""

from __future__ import annotations

import os

from benchmark import setops_reference, zkf
from benchmark.jobs import kmerize

LIMITS = {"header_off": 0, "keys_off": 0, "counts_off": 0, "cards_off": 0}
# the traffic's order: the three set-writing commands, then jaccard
SET_OPS = ("union", "intersect", "diff")
OPS = SET_OPS + ("jaccard",)
CARDS = ("a", "b", "intersect", "union")


class Job:
    def __init__(self, cfg: dict, inputs, devices):
        # a program without the entries stops here, before any set-up
        from zotpu_torch.workloads.setops import (  # noqa: F401
            jaccard_paths, set_op_paths)
        self.cfg, self.inputs = cfg, inputs
        self.devices = devices
        self.sets = self._sets(devices[0])
        self.paths = None
        self.last = [()] * len(SET_OPS)    # the previous job's chunks

    def _sets(self, device, key_bits: int = 64):
        s = setops_reference.group_sets(
            self.inputs.codes, self.inputs.bounds, self.cfg["groups"],
            self.cfg["k"], device, key_bits=key_bits)
        return s["A"], s["B"]

    def _files(self):
        """The two sets as raw ZKF files beside the reads, written once."""
        if self.paths is None:
            d = os.path.dirname(self.inputs.paths[0])
            paths = [os.path.join(d, f"{name}.zkf") for name in "AB"]
            for path, s in zip(paths, self.sets):
                with open(path, "wb") as f:
                    zkf.write(f, self.cfg["k"], *s)
            self.paths = paths
        return self.paths

    def run(self, span) -> dict:
        from zotpu_torch.io import container
        from zotpu_torch.workloads import setops as W
        a, b = self._files()
        dev = self.devices[0]
        outs = []
        for op, like in zip(SET_OPS, self.last):
            k, keys, counts = W.set_op_paths(a, b, op, device=dev)
            sink = kmerize.Sink(like)
            with span("container"):
                container.write_stream(sink, container.KmerSet(
                    k=k, keys=keys, counts=counts,
                    meta={"tool": f"zotpu_torch {op}"}),
                    codec=self.cfg["codec"])
            outs.append(sink.chunks)
        cards = W.jaccard_paths(a, b, device=dev)
        self.last = outs
        return {"bases": self.inputs.bases, "batches": len(OPS),
                "output": (outs, cards)}

    def expected(self, device, key_bits: int = 64):
        a, b = self.sets if key_bits == 64 else self._sets(device, key_bits)
        return setops_reference.set_ops(a, b, device)

    def render(self, result) -> tuple:
        """A reference result in a job's output form (the control)."""
        outs = []
        for op in SET_OPS:
            f = kmerize.Sink()
            zkf.write(f, self.cfg["k"], *result[op])
            outs.append(f.chunks)
        return outs, dict(result["cards"])

    def compare(self, outputs, want) -> list:
        """One reading a job's output: {number compared: value}. A
        container made of the same chunk objects as one judged before (see
        ``Sink``) is judged once."""
        judged = {}

        def judge(chunks, op):
            key = (op,) + tuple(map(id, chunks))
            if key not in judged:
                # the kmerize job's judge of one container: it reads only
                # cfg["k"] of the job it is given
                judged[key] = kmerize.Job._judge(self, b"".join(chunks),
                                                 *want[op])
            return judged[key]

        readings = []
        for out in outputs:
            if not out:                  # a job that raised
                out = ([[]] * len(SET_OPS), {})
            sets, cards = out
            r = dict.fromkeys(LIMITS, 0)
            for op, chunks in zip(SET_OPS, sets):
                for name, v in judge(chunks, op).items():
                    r[name] += v
            r["cards_off"] = sum(abs(int(cards.get(n, 0)) - want["cards"][n])
                                 for n in CARDS)
            readings.append(r)
        return readings
