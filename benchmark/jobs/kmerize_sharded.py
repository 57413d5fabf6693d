"""The sharded kmerize job: a sequencing run through the entry the CLI's
``kmerize --shards N`` calls, over the cell's cards, then its container
serialised into memory.

One job is ``workloads.kmerize.kmerize_paths_sharded`` over every FASTQ
file of the cell with the configuration's ``shards``, ``shard_hash`` and
``capacity_factor``, one slot a card of the cell (``cuda:0..3`` on four
cards), then ``io.container.write_stream`` of the result with the CLI's
meta. Sharding changes no byte of the container, so everything else is
the one-card kmerize job's (``jobs/kmerize.py``): the sink, the host
pipeline that ``parse_bases_per_s`` drains (the sharded path parses the
same batches of ``batch_reads`` rows, then splits each over the slots),
the reference and the judging, with the same ``LIMITS``.
"""

from __future__ import annotations

from benchmark.jobs import kmerize

LIMITS = kmerize.LIMITS


class Job(kmerize.Job):
    def run(self, span) -> dict:
        from zotpu_torch.io import container
        from zotpu_torch.workloads import kmerize as W
        cfg = self.cfg
        stats = W.Stats()
        keys, counts = W.kmerize_paths_sharded(
            self.inputs.paths, cfg["k"], cfg["shards"],
            batch_reads=cfg["batch_reads"], max_len=cfg["max_len"],
            stats=stats, capacity_factor=cfg["capacity_factor"],
            merge_capacity=cfg["merge_capacity"],
            shard_hash=cfg["shard_hash"], devices=self.devices)
        sink = kmerize.Sink(self.last)
        with span("container"):
            container.write_stream(sink, container.KmerSet(
                k=cfg["k"], keys=keys, counts=counts,
                meta={"tool": "zotpu_torch kmerize",
                      "inputs": self.inputs.paths,
                      "stats": stats.as_dict()}), codec=cfg["codec"])
        self.last = sink.chunks
        return {"bases": self.inputs.bases, "batches": stats.batches,
                "output": sink.chunks}
