"""The kmerize job: a sequencing run through the entry the CLI's
``kmerize`` calls, then its container serialised into memory.

One job is ``workloads.kmerize.kmerize_paths`` over every FASTQ file of
the cell, then ``io.container.write_stream`` of the result with the CLI's
meta into a sink that keeps the bytes: the raw set is 12 B a key, 179 MB
a job at the configurations' size, and a window writes tens of them. A
chunk equal to the previous job's chunk at its place is kept as that
object, so the window holds one copy of an output that repeats, and
each distinct output is judged once.

Judged: every job's container bytes, decoded by ``benchmark/zkf.py``,
against the reference's set of the generated reads. Each number compared
is the largest over the window's jobs and must be 0:

- ``header_off``: 1 where the stream is not a raw ZKF set of k with counts;
- ``keys_off``: keys in one set and not in the other;
- ``counts_off``: keys in both whose counts differ.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference, zkf

LIMITS = {"header_off": 0, "keys_off": 0, "counts_off": 0}


class Sink:
    """A binary file object that keeps what is written, chunk by chunk. A
    chunk equal to the one at its place in ``like`` (an earlier job's
    chunks) is kept as that object, not as a second copy."""

    def __init__(self, like=()):
        self.like, self.chunks = like, []

    def write(self, b) -> int:
        i = len(self.chunks)
        if i < len(self.like) and b == self.like[i]:
            b = self.like[i]
        self.chunks.append(b)
        return len(b)


class Job:
    def __init__(self, cfg: dict, inputs, devices):
        self.cfg, self.inputs = cfg, inputs
        self.devices = devices
        self.last = ()                 # the previous job's chunks

    def run(self, span) -> dict:
        from zotpu_torch.io import container
        from zotpu_torch.workloads import kmerize as W
        cfg, dev = self.cfg, self.devices[0]
        stats = W.Stats()
        common = dict(batch_reads=cfg["batch_reads"], max_len=cfg["max_len"],
                      stats=stats, merge_capacity=cfg["merge_capacity"])
        keys, counts = W.kmerize_paths(self.inputs.paths, cfg["k"],
                                       device=dev, **common)
        sink = Sink(self.last)
        with span("container"):
            container.write_stream(sink, container.KmerSet(
                k=cfg["k"], keys=keys, counts=counts,
                meta={"tool": "zotpu_torch kmerize",
                      "inputs": self.inputs.paths,
                      "stats": stats.as_dict()}), codec=cfg["codec"])
        self.last = sink.chunks
        return {"bases": self.inputs.bases, "batches": stats.batches,
                "output": sink.chunks}

    def host_pipeline(self) -> int:
        """Drain the host iterator a job drives (parse, wire pack, pin)
        with no device step; returns the bases it parsed."""
        from zotpu_torch.workloads import kmerize as W
        cfg = self.cfg
        stats = W.Stats()
        for _ in W._iter_batches(
                self.inputs.paths, cfg["batch_reads"], cfg["max_len"],
                cfg["k"], stats, wire_pack=cfg["max_len"] % 32 == 0,
                pin=self.devices[0].type == "cuda", parallel=True):
            pass
        return stats.bases

    def expected(self, device, key_bits: int = 64):
        return reference.kmer_set(self.inputs.codes, self.cfg["k"], device,
                                  key_bits=key_bits)

    def render(self, result) -> list:
        """A reference result in a job's output form (the control)."""
        f = Sink()
        zkf.write(f, self.cfg["k"], *result)
        return f.chunks

    def compare(self, outputs, want) -> list:
        """One reading a job's output: {number compared: value}. Outputs
        made of the same chunk objects (see ``Sink``) are judged once."""
        keys_w, counts_w = want
        judged = {}
        for out in outputs:
            key = tuple(map(id, out))
            if key not in judged:
                judged[key] = self._judge(b"".join(out), keys_w, counts_w)
        return [judged[tuple(map(id, out))] for out in outputs]

    def _judge(self, buf, keys_w, counts_w) -> dict:
        try:
            hdr, keys, counts = zkf.read(buf)
        except (ValueError, KeyError):
            return {"header_off": 1, "keys_off": len(keys_w),
                    "counts_off": len(keys_w)}
        header = int(hdr["k"] != self.cfg["k"] or counts is None)
        ka = np.frombuffer(keys, "<u8")
        ca = None if counts is None else np.frombuffer(counts, "<u4")
        if np.array_equal(ka, keys_w) and np.array_equal(ca, counts_w):
            return {"header_off": header, "keys_off": 0, "counts_off": 0}
        keys_off = len(np.setxor1d(ka, keys_w))
        if counts is None:
            return {"header_off": header, "keys_off": keys_off,
                    "counts_off": len(keys_w)}
        _, ia, ib = np.intersect1d(ka, keys_w, return_indices=True)
        return {"header_off": header, "keys_off": keys_off,
                "counts_off": int((ca[ia] != counts_w[ib]).sum())}

