"""Command-line interface of the PyTorch/CUDA port.

    python -m zotpu_torch kmerize -k K [--batch-reads N] [--max-len L]
        [--merge-capacity N] [--shards N] [--shard-hash prefix|mixed]
        [--codec C] [--device cuda|cpu] OUT IN...
    python -m zotpu_torch scan [--per-read] [--out-reads FASTQ]
        [--min-hits N] [--host] [--batch-reads N] [--max-len L]
        [--shards N] [--shard-hash prefix|mixed] [--device cuda|cpu]
        PANEL SAMPLE...
    python -m zotpu_torch evidence [--out-reads DIR] [--min-hits N] [--host]
        [--batch-reads N] [--max-len L] [--device cuda|cpu] PANEL SAMPLE...
    python -m zotpu_torch probes -k K REFERENCE OUT VARIANT...
    python -m zotpu_torch query SET KMER... [--seq]
    python -m zotpu_torch verify A B

``kmerize`` writes the same ZKF container as ``python -m zotpu kmerize``
(keys and counts; the meta names this tool); ``scan`` and ``evidence``
print the same lines and write the same read files as their ``zotpu``
counterparts. ``--device`` defaults to cuda and never falls back: without
a CUDA device it exits 1. ``--device cpu`` runs the kernels' plain PyTorch
versions; ``--host`` runs the golden numpy reference. ``probes``, ``query``
and ``verify`` are host-only and are the JAX package's own commands.

``--shards N`` (a power of two) runs ``kmerize`` and ``scan`` sharded over
N device slots of one process: ``cuda:0 .. cuda:N-1`` (N above the visible
card count exits 1), or N CPU slots with ``--device cpu``. The multi-host
flags (``--coordinator``, ``--num-processes``, ``--process-id``) and
``kmerize --spill-dir/--resume`` are not yet ported and exit 1.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np
import torch

from zotpu import cli as zotpu_cli
from zotpu.io import container, fastq
from zotpu.reference_impl import golden as G


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise ValueError("--device cuda needs a CUDA device and "
                         "torch.cuda.is_available() is false (pass "
                         "--device cpu to run the plain PyTorch versions)")
    return torch.device(name)


def _no_multihost(args, command: str) -> None:
    if args.coordinator or args.num_processes or args.process_id is not None:
        raise NotImplementedError(
            f"the multi-host flags (--coordinator, --num-processes, "
            f"--process-id) are not yet ported to zotpu_torch (multi-device "
            f"runs across processes); run `python -m zotpu {command}` with "
            f"them")


def cmd_kmerize(args):
    from zotpu_torch.workloads import kmerize as W
    _no_multihost(args, "kmerize")
    device = _device(args.device)
    stats = W.Stats()
    if args.shards > 1:
        keys, counts = W.kmerize_paths_sharded(
            args.inputs, args.k, args.shards, batch_reads=args.batch_reads,
            max_len=args.max_len, stats=stats, spill_dir=args.spill_dir,
            resume=args.resume, merge_capacity=args.merge_capacity,
            shard_hash=args.shard_hash, device=device)
    else:
        keys, counts = W.kmerize_paths(
            args.inputs, args.k, batch_reads=args.batch_reads,
            max_len=args.max_len, spill_dir=args.spill_dir, stats=stats,
            merge_capacity=args.merge_capacity, device=device)
    container.write(args.output, container.KmerSet(
        k=args.k, keys=keys, counts=counts,
        meta={"tool": "zotpu_torch kmerize", "inputs": args.inputs,
              "stats": stats.as_dict()}),
        codec=args.codec or "raw")
    print(json.dumps({"command": "kmerize", **stats.as_dict()}))
    return 0


def cmd_scan(args):
    """Panel pulldown over read sets (zotpu/cli.py cmd_scan, single
    controller). Overlong reads are halo-chunked into several device rows,
    and the rows re-aggregate per input record, so totals, reads_with_hits
    and --per-read rows stay record-aligned."""
    _no_multihost(args, "scan")
    device = None if args.host else _device(args.device)
    panel, _ = zotpu_cli._load_padded(args.panel)
    if args.host:
        results = []
        for p in args.samples:
            hits = G.scan_panel(panel.k, panel.keys,
                                zotpu_cli._read_all_seqs([p]))
            results.append((int(hits.sum()), int((hits > 0).sum()),
                            [int(h) for h in hits]))
    elif args.shards > 1:
        from zotpu_torch.workloads import pulldown
        results = pulldown.pulldown_paths_sharded(
            panel.keys, args.samples, panel.k, args.shards,
            batch_reads=args.batch_reads, max_len=args.max_len,
            shard_hash=args.shard_hash, device=device)
    else:
        from zotpu_torch.workloads import pulldown
        results = pulldown.pulldown_paths(
            panel.keys, args.samples, panel.k, batch_reads=args.batch_reads,
            max_len=args.max_len, device=device)
    out_fh = open(args.out_reads, "w") if args.out_reads else None
    for path, (total, reads_hit, per_read) in zip(args.samples, results):
        print(json.dumps({"command": "scan", "sample": path,
                          "k": panel.k, "total_hits": total,
                          "reads_with_hits": reads_hit}))
        if args.per_read:
            for i, h in enumerate(per_read):
                print(f"{path}\t{i}\t{h}")
        if out_fh is not None:
            zotpu_cli._write_hit_reads(out_fh, path, per_read, args.min_hits)
    if out_fh is not None:
        out_fh.close()
    return 0


def _iter_records(path):
    """(name, seq, qual) of every record; FASTA records get 'I' qualities."""
    fmt = fastq.sniff_format(path)
    with fastq.open_file(path) as f:
        if fmt == "fastq":
            yield from fastq.read_fastq(f)
        else:
            yield from ((n, s, "I" * len(s)) for n, s in fastq.read_fasta(f))


def _write_variant_reads(args, meta, k, sample, device):
    """Per-variant pulldown of supporting reads (zotpu/cli.py
    _write_variant_reads): the sample reads carrying >= --min-hits of a
    variant's ALT probes go to OUT_DIR/<variant>.<sample>.fastq. One scan
    against the union of every variant's alt probes finds the candidate
    reads, one parse pass collects them, and each variant's per-read hits
    come from the golden scan over the candidates only."""
    from zotpu_torch.workloads import pulldown
    os.makedirs(args.out_reads, exist_ok=True)
    sanitize = lambda s: re.sub(r"[^A-Za-z0-9._-]", "_", s)
    sbase = sanitize(os.path.basename(sample))
    alt_sets = {m["spec"]: np.asarray([int(x, 16) for x in m["alt_probes"]],
                                      np.uint64)
                for m in meta["variants"]}
    if not alt_sets:
        return {}
    union = np.unique(np.concatenate(list(alt_sets.values())))

    if args.min_hits <= 0:
        # every read qualifies for every variant: stream the sample once
        # into all variant files instead of holding it in memory
        outs = {m["spec"]: open(os.path.join(
                    args.out_reads, f"{sanitize(m['spec'])}.{sbase}.fastq"),
                    "w") for m in meta["variants"]}
        nw = 0
        for rid, seq, qual in _iter_records(sample):
            rec = f"@{rid}\n{seq}\n+\n{qual}\n"
            for fh in outs.values():
                fh.write(rec)
            nw += 1
        for fh in outs.values():
            fh.close()
        return {spec: nw for spec in outs}

    # 1. one scan of the whole sample vs the union panel
    if args.host:
        seqs = zotpu_cli._read_all_seqs([sample])
        union_hits = [int(h) for h in G.scan_panel(k, union, seqs)]
    else:
        _, _, union_hits = pulldown.pulldown_paths(
            union, [sample], k, batch_reads=args.batch_reads,
            max_len=args.max_len, device=device)[0]
    cand = [i for i, h in enumerate(union_hits) if h >= 1]

    # 2. one parse pass collects just the candidate records
    cand_set = set(cand)
    recs = {i: rec for i, rec in enumerate(_iter_records(sample))
            if i in cand_set}

    # 3. per-variant hit counts over only the candidates (golden)
    cand_seqs = [recs[i][1] for i in cand]
    written = {}
    for m in meta["variants"]:
        hits = (G.scan_panel(k, alt_sets[m["spec"]], cand_seqs)
                if cand else np.zeros(0, np.int64))
        out = os.path.join(args.out_reads,
                           f"{sanitize(m['spec'])}.{sbase}.fastq")
        nw = 0
        with open(out, "w") as fh:
            for idx, h in zip(cand, hits):
                if int(h) >= args.min_hits:
                    rid, seq, qual = recs[idx]
                    fh.write(f"@{rid}\n{seq}\n+\n{qual}\n")
                    nw += 1
        written[m["spec"]] = nw
    return written


def cmd_evidence(args):
    """Screen read sets for variant evidence against a probe panel
    (zotpu/cli.py cmd_evidence): kmerize each sample, then read each
    variant's ref/alt probe counts from its k-mer set."""
    from zotpu import variants as V
    from zotpu_torch.workloads import kmerize as W
    device = None if args.host else _device(args.device)
    hdr = container.read(args.panel)
    meta = hdr.meta
    if "variants" not in meta:
        raise ValueError(f"{args.panel}: not a probes panel (run "
                         f"`zotpu probes` first)")
    k = hdr.k
    for sample in args.samples:
        if args.host:
            keys, counts = G.kmerize(k, zotpu_cli._read_all_seqs([sample]))
        else:
            keys, counts = W.kmerize_paths(
                [sample], k, batch_reads=args.batch_reads,
                max_len=args.max_len, device=device)
        for row in V.evidence_from_counts(meta, keys, counts):
            print(json.dumps({"command": "evidence", "sample": sample,
                              **row}))
        if args.out_reads:
            written = _write_variant_reads(args, meta, k, sample, device)
            print(json.dumps({"command": "evidence", "sample": sample,
                              "out_reads": args.out_reads,
                              "supporting_reads": written}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="zotpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def device_flag(sp):
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda runs the CUDA kernels; cpu their plain "
                             "PyTorch versions")

    def batch_flags(sp):
        sp.add_argument("--host", action="store_true",
                        help="use the golden numpy path instead of the "
                             "device kernels")
        sp.add_argument("--batch-reads", type=int, default=4096)
        sp.add_argument("--max-len", type=int, default=256)
        device_flag(sp)

    def out_codec(sp):
        sp.add_argument("--codec", choices=("raw", "zlib", "delta"),
                        default=None, help="output container codec")

    def shard_flags(sp, what):
        sp.add_argument("--shards", type=int, default=1,
                        help=f"{what} across N device slots (power of two; "
                             f"all-to-all k-mer routing)")
        sp.add_argument("--shard-hash", choices=("prefix", "mixed"),
                        default="prefix", dest="shard_hash",
                        help="shard owner function: key prefix or a mixed "
                             "32-bit hash (balanced under GC-content skew; "
                             "output bytes identical)")
        sp.add_argument("--coordinator", default=None,
                        help="multi-host runs (not yet ported)")
        sp.add_argument("--num-processes", type=int, default=None,
                        help="multi-host runs (not yet ported)")
        sp.add_argument("--process-id", type=int, default=None,
                        help="multi-host runs (not yet ported)")

    sp = sub.add_parser("kmerize", help="FASTA/FASTQ -> k-mer set with counts")
    sp.add_argument("-k", type=int, required=True, dest="k")
    sp.add_argument("--batch-reads", type=int, default=4096)
    sp.add_argument("--max-len", type=int, default=256)
    sp.add_argument("--merge-capacity", type=int, default=1 << 26,
                    help="device accumulator capacity in unique k-mers")
    sp.add_argument("--spill-dir", default=None,
                    help="per-batch checkpoint runs (not yet ported)")
    sp.add_argument("--resume", action="store_true",
                    help="reuse runs in --spill-dir (not yet ported)")
    shard_flags(sp, "shard the k-mer key space")
    out_codec(sp)
    device_flag(sp)
    sp.add_argument("output")
    sp.add_argument("inputs", nargs="+")
    sp.set_defaults(fn=cmd_kmerize)

    sp = sub.add_parser("scan", help="panel pulldown over read sets")
    sp.add_argument("panel")
    sp.add_argument("samples", nargs="+")
    sp.add_argument("--per-read", action="store_true")
    sp.add_argument("--out-reads", default=None,
                    help="write reads with >= --min-hits panel k-mers here "
                         "(FASTQ)")
    sp.add_argument("--min-hits", type=int, default=1)
    shard_flags(sp, "hash-shard the panel")
    batch_flags(sp)
    sp.set_defaults(fn=cmd_scan)

    sp = sub.add_parser("probes",
                        help="variant descriptions -> k-mer probe panel")
    sp.add_argument("-k", type=int, required=True, dest="k")
    sp.add_argument("reference", help="reference FASTA")
    sp.add_argument("output")
    sp.add_argument("variants", nargs="+",
                    help="HGVS-style specs, e.g. chr1:g.123A>G, "
                         "chr1:g.10_12del, chr1:g.10_11insTT, "
                         "chr1:g.10_12dup, chr1:g.10_12delinsGG, "
                         "chr1:g.10_12inv; @FILE reads one spec per line "
                         "('#' comments ok); with --transcripts also "
                         "TX:c.76A>T, TX:c.-14G>C, TX:c.*6del, TX:c.88+2T>G, "
                         "TX:n.42del")
    sp.add_argument("--transcripts", metavar="TSV",
                    help="refGene-style gene models enabling c./n. "
                         "coordinates (name chrom strand txStart txEnd "
                         "cdsStart cdsEnd exonCount exonStarts exonEnds)")
    out_codec(sp)
    sp.set_defaults(fn=zotpu_cli.cmd_probes)

    sp = sub.add_parser("evidence",
                        help="variant evidence in read sets vs a probe panel")
    sp.add_argument("panel", help="output of `probes`")
    sp.add_argument("samples", nargs="+")
    sp.add_argument("--out-reads", metavar="DIR",
                    help="also write each variant's supporting reads "
                         "(>= --min-hits ALT-probe k-mers) to "
                         "DIR/<variant>.<sample>.fastq")
    sp.add_argument("--min-hits", type=int, default=1)
    batch_flags(sp)
    sp.set_defaults(fn=cmd_evidence)

    sp = sub.add_parser("query", help="look up k-mer counts in a set")
    sp.add_argument("input", help="ZKF set (casket#member ok)")
    sp.add_argument("kmers", nargs="+",
                    help="k-mer strings (either strand; @FILE reads one "
                         "per line)")
    sp.add_argument("--seq", action="store_true",
                    help="treat queries as longer sequences; report how many "
                         "of their k-mers are present")
    sp.set_defaults(fn=zotpu_cli.cmd_query)

    sp = sub.add_parser("verify", help="compare two sets byte-for-byte")
    sp.add_argument("a")
    sp.add_argument("b")
    sp.add_argument("--as-sets", action="store_true",
                    help="compare membership only")
    sp.set_defaults(fn=zotpu_cli.cmd_verify)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # a downstream reader (e.g. `scan --per-read | head`) closed the pipe
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
