"""Command-line interface of the PyTorch/CUDA port.

    python -m zotpu_torch kmerize -k K [--batch-reads N] [--max-len L]
        [--merge-capacity N] [--spill-dir DIR [--resume]] [--shards N]
        [--shard-hash prefix|mixed] [--host] [--codec C | --compress]
        [--metrics FILE] [--trace DIR] [--device cuda|cpu]
        [--coordinator HOST:PORT --num-processes P --process-id I] OUT IN...
    python -m zotpu_torch merge [--merge-capacity N] [--host] [--codec C]
        [--device cuda|cpu] OUT IN...
    python -m zotpu_torch union|intersect|diff [--shards N] [--stream]
        [--host] [--codec C] [--device cuda|cpu]
        [--coordinator HOST:PORT --num-processes P --process-id I] OUT A B
    python -m zotpu_torch jaccard [--shards N] [--host] [--device cuda|cpu]
        IN IN...
    python -m zotpu_torch hist [--max-count N] [--cutoff] [--host]
        [--device cuda|cpu] IN
    python -m zotpu_torch filter [--min-count N | --auto] [--codec C]
        [--device cuda|cpu] OUT IN
    python -m zotpu_torch scan [--per-read] [--out-reads FASTQ]
        [--min-hits N] [--host] [--batch-reads N] [--max-len L]
        [--shards N] [--shard-hash prefix|mixed] [--device cuda|cpu]
        [--coordinator HOST:PORT --num-processes P --process-id I]
        PANEL SAMPLE...
    python -m zotpu_torch evidence [--out-reads DIR] [--min-hits N] [--host]
        [--batch-reads N] [--max-len L] [--device cuda|cpu] PANEL SAMPLE...
    python -m zotpu_torch probes -k K REFERENCE OUT VARIANT...
    python -m zotpu_torch spikein [--vaf F] [--coverage X] [--read-len N]
        [--error-rate F] [--seed N] [--transcripts TSV] REFERENCE OUT
        VARIANT...
    python -m zotpu_torch query SET KMER... [--seq]
    python -m zotpu_torch sample --rate F [--seed N] [--codec C] OUT IN
    python -m zotpu_torch dump IN
    python -m zotpu_torch info IN...
    python -m zotpu_torch verify A B
    python -m zotpu_torch casket ls|new|add|extract CASKET ...
    python -m zotpu_torch selftest [-k K] [--device cuda|cpu]
    python -m zotpu_torch bench [--workload W] [--bases N] [--k K]
        [--repeats N] [--setops-n N] [--scan-reads N] [--scan-panel N]
        [--device cuda|cpu]
    python -m zotpu_torch -V

Every command that writes a set writes the same ZKF container as its
``python -m zotpu`` counterpart (keys, counts and k; the meta names this
tool) and prints the same lines; ``scan`` and ``evidence`` write the same
read files, ``spikein`` the same FASTQ. ``--device`` defaults to cuda and
never falls back: without a CUDA device a command that has device work
exits 1. ``--device cpu`` runs the kernels' plain PyTorch versions;
``--host`` runs the golden numpy reference. ``probes``, ``spikein``,
``query``, ``sample``, ``dump``, ``info``, ``verify``, ``casket`` and
``filter --min-count`` are host-only (the ``probes`` and ``sample``
containers' meta names this tool).

``selftest`` runs every device path on small fixtures against golden and
prints one JSON line per check and a summary; it exits 1 if a check is not
byte-equal. ``kmerize --metrics FILE`` appends one JSONL line of stage
metrics (rates, dedup ratio, counts; routing skew with ``--shards``), and
``--trace DIR`` writes a torch.profiler Chrome trace to DIR/trace.json
(CUDA activity included on cuda, where a trace without it is an error).

``bench`` runs the performance harness (bench/harness.py): one JSON line
per workload, each with the device's name and the kernels it launched.

``kmerize --spill-dir DIR`` writes each batch's run as a checkpoint file
and ``--resume`` reuses the completed ones; the directories are
interchangeable with ``python -m zotpu kmerize --spill-dir``.

``--shards N`` (a power of two) runs ``kmerize``, ``scan``, the set ops and
``jaccard`` sharded over N device slots of one process: ``cuda:0 ..
cuda:N-1`` (N above the visible card count exits 1), or N CPU slots with
``--device cpu``.

Multi-controller runs: start the same command line once per process with
``--coordinator HOST:PORT`` (process 0's address), ``--num-processes P``
and ``--process-id I``. The processes join one ``torch.distributed`` group
(NCCL on cards, gloo on the CPU); process I drives ``cuda:{I % cards}``,
or the CPU with ``--device cpu``. ``--shards`` is then the global slot
count: P by default, else a power of two and a multiple of P, each process
holding ``shards / P`` slots on its device. ``kmerize`` reads the input
files round-robin (process I the files I, I + P, ...), and process 0 writes
the container; ``scan`` assigns the samples round-robin, process 0 prints
the summary lines, the owner of a sample its ``--per-read`` rows, and each
process writes its own ``--out-reads FILE.pI``; ``union|intersect|diff``
run streamed, every process reading its slots' rows from the shared files,
and process 0 writes the result. Every result equals the single-controller
run's. ``--host`` is refused with more than one process.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from zotpu_torch import semantics as S
from zotpu_torch import variants as V
from zotpu_torch.io import container, fastq
from zotpu_torch.reference_impl import golden as G
from zotpu_torch.sparse import SparseSet


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise ValueError("--device cuda needs a CUDA device and "
                         "torch.cuda.is_available() is false (pass "
                         "--device cpu to run the plain PyTorch versions)")
    return torch.device(name)


def _multi(args) -> bool:
    return bool(args.num_processes and args.num_processes > 1)


def _init_multihost(args, device, files=None, assign=True):
    """Join the run's process group from the CLI flags (zotpu/cli.py
    _init_multihost). Returns (process id, files for this process, the
    device it drives). ``files`` (default args.inputs) go round-robin to
    the processes when ``assign``; scan passes assign=False, as
    pulldown_paths_sharded assigns the samples by their global position.
    Every process runs the same command line. ``--shards`` becomes the
    global slot count: the process count by default, else a power of two
    and a multiple of it. The flags are checked before the group is
    joined, so a bad one exits 1 at once on every process."""
    files = args.inputs if files is None else files
    if not _multi(args):
        return 0, files, device
    P, pid = args.num_processes, args.process_id
    if pid is None or args.coordinator is None:
        raise ValueError(
            "--num-processes needs --coordinator HOST:PORT and --process-id")
    if not 0 <= pid < P:
        raise ValueError(f"--process-id {pid} is not in [0, {P})")
    from zotpu_torch.dist import mesh as M
    if args.shards <= 1:
        args.shards = P
    M.check_process_shards(args.shards, P)
    device = M.init_distributed(args.coordinator, P, pid, device)
    return pid, files[pid::P] if assign else files, device


def _no_host_multi(args) -> None:
    if args.host and _multi(args):
        # the golden path ignores the file assignment: every process would
        # read every input (or write its own part as the result)
        raise ValueError("--host is not supported with --num-processes > 1 "
                         "(run the host oracle single-controller)")


def _load_padded(path: str):
    ks = container.read(path)
    counts = ks.counts if ks.counts is not None else np.ones(ks.n, S.COUNT_DTYPE)
    return ks, counts


def _read_all_seqs(paths):
    seqs = []
    for p in paths:
        fmt = fastq.sniff_format(p)
        with fastq.open_file(p) as f:
            if fmt == "fastq":
                seqs.extend(s for _, s, _ in fastq.read_fastq(f))
            else:
                seqs.extend(s for _, s in fastq.read_fasta(f))
    return seqs


def _write_hit_reads(out_fh, path, per_read, min_hits):
    """Pull down reads with >= min_hits panel k-mers as FASTQ records."""
    fmt = fastq.sniff_format(path)
    with fastq.open_file(path) as f:
        if fmt == "fastq":
            recs = fastq.read_fastq(f)
        else:
            recs = ((name, seq, "I" * len(seq)) for name, seq in fastq.read_fasta(f))
        for i, (rid, seq, qual) in enumerate(recs):
            if i < len(per_read) and per_read[i] >= min_hits:
                out_fh.write(f"@{rid}\n{seq}\n+\n{qual}\n")


def cmd_kmerize(args):
    from zotpu_torch import metrics
    from zotpu_torch.workloads import kmerize as W
    _no_host_multi(args)
    device = None if args.host else _device(args.device)
    host_id, inputs, device = _init_multihost(args, device)
    args = argparse.Namespace(**{**vars(args), "inputs": inputs})
    stats = W.Stats()
    t0 = time.perf_counter()
    with metrics.profiled(args.trace, device):
        if args.host:
            seqs = _read_all_seqs(args.inputs)
            keys, counts = G.kmerize(args.k, seqs)
            stats.reads = len(seqs)
            stats.bases = sum(len(s) for s in seqs)
            stats.kmers = (int(counts.sum(dtype=np.uint64)) if len(counts)
                           else 0)
            stats.unique = len(keys)
        elif args.shards > 1:
            keys, counts = W.kmerize_paths_sharded(
                args.inputs, args.k, args.shards,
                batch_reads=args.batch_reads, max_len=args.max_len,
                stats=stats, spill_dir=args.spill_dir, resume=args.resume,
                merge_capacity=args.merge_capacity,
                shard_hash=args.shard_hash, device=device)
        else:
            keys, counts = W.kmerize_paths(
                args.inputs, args.k, batch_reads=args.batch_reads,
                max_len=args.max_len, spill_dir=args.spill_dir, stats=stats,
                resume=args.resume, merge_capacity=args.merge_capacity,
                device=device)
    wall = time.perf_counter() - t0
    if host_id == 0:  # every process holds the result; process 0 writes
        container.write(args.output, container.KmerSet(
            k=args.k, keys=keys, counts=counts,
            meta={"tool": "zotpu_torch kmerize", "inputs": args.inputs,
                  "stats": stats.as_dict()}),
            codec=args.codec or ("zlib" if args.compress else "raw"))
    if args.metrics:
        logger = metrics.MetricsLogger(args.metrics, host_id=host_id)
        try:
            logger.log("kmerize", **metrics.kmerize_stage_metrics(
                stats, wall, n_chips=stats.n_chips))
        finally:
            logger.close()
    print(json.dumps({"command": "kmerize", **stats.as_dict()}))
    return 0


def cmd_merge(args):
    """Merge N sets, counts summed (BASELINE config 2; zotpu/cli.py
    cmd_merge).

    Device path: inputs stream ONE AT A TIME from disk in fixed-size chunks
    (container.ChunkReader decodes every codec incrementally) through the
    device accumulator (workloads/accumulator.py), whose level merges run
    on K3, so host memory peaks at O(chunk) however many runs are merged.
    Saturating count addition does not depend on the order. --host keeps
    the golden numpy merge (loads everything; small data)."""
    k = None

    def check_k(path, got):
        nonlocal k
        if k is None:
            k = got
        elif got != k:
            raise ValueError(f"K mismatch: {path} has k={got}, expected {k}")

    if args.host:
        from zotpu_torch.workloads.kmerize import merge_runs
        sets = []
        for p in args.inputs:
            ks, counts = _load_padded(p)
            check_k(p, ks.k)
            sets.append((ks.keys, counts))
        keys, counts = merge_runs(sets, force_host=True)
    else:
        from zotpu_torch import keys as K
        from zotpu_torch.workloads.accumulator import DeviceAccumulator
        device = _device(args.device)
        chunk = int(os.environ.get("ZOTPU_MERGE_CHUNK", 1 << 22))
        acc = DeviceAccumulator(chunk, max_cap=args.merge_capacity,
                                device=device)
        for p in args.inputs:
            r = container.ChunkReader(p)
            check_k(p, r.k)
            for kc, cc in r.chunks(chunk):
                acc.add(*K.from_numpy_set(kc, cc, device),
                        torch.tensor(len(kc), dtype=torch.int64,
                                     device=device))
        keys, counts = acc.result()
    container.write(args.output, container.KmerSet(
        k=k, keys=keys, counts=counts, meta={"tool": "zotpu_torch merge"}),
        codec=args.codec or "raw")
    print(json.dumps({"command": "merge", "inputs": len(args.inputs),
                      "unique": len(keys)}))
    return 0


def _binary_setop(args, op):
    """union / intersect / diff of two sets (BASELINE config 3; zotpu/cli.py
    _binary_setop): one K3 launch on one device (``set_op_paths``), one
    per slot with --shards N, and with --stream (always in a
    multi-controller run) the slots' rows are read straight from the
    container files in O(chunk) host memory; across processes the
    cardinalities are summed, the process sets gathered, and process 0
    writes."""
    from zotpu_torch.workloads import setops as WS
    meta = {"tool": f"zotpu_torch {op}"}
    if args.stream or _multi(args):
        host_id, _, device = _init_multihost(args, _device(args.device),
                                             files=[], assign=False)
        n_shards = args.shards if args.shards > 1 else (
            torch.cuda.device_count() if device.type == "cuda" else 1)
        k, keys, counts, cards = WS.set_op_sharded_stream(
            args.a, args.b, op, n_shards, device=device)
        if _multi(args):
            from zotpu_torch.dist import shuffle
            from zotpu_torch.dist.mesh import sharded_mesh
            keys, counts = shuffle.allgather_host_sets(
                sharded_mesh(n_shards, device), keys, counts)
        if host_id == 0:
            container.write(args.output, container.KmerSet(
                k=k, keys=keys, counts=counts, meta=meta),
                codec=args.codec or "raw")
            print(json.dumps({"command": op, "unique": len(keys),
                              "cards": cards}))
        return 0
    if not args.host and args.shards <= 1:
        k, keys, counts = WS.set_op_paths(args.a, args.b, op,
                                          device=_device(args.device))
    else:
        a, ca = _load_padded(args.a)
        b, cb = _load_padded(args.b)
        if a.k != b.k:
            raise ValueError(f"K mismatch ({a.k} vs {b.k})")
        k = a.k
        if args.host:
            gold = {"union": G.union, "intersect": G.intersect,
                    "diff": G.difference}[op]
            keys, counts = gold((a.keys, ca), (b.keys, cb))
        else:
            keys, counts, _ = WS.set_op_sharded(
                (a.keys, ca), (b.keys, cb), op, a.k, args.shards,
                device=_device(args.device))
    container.write(args.output, container.KmerSet(
        k=k, keys=keys, counts=counts, meta=meta),
        codec=args.codec or "raw")
    print(json.dumps({"command": op, "unique": len(keys)}))
    return 0


def _pair_jaccard(a, b, host, shards=1, cache=None, device=None):
    if host:
        ni = len(np.intersect1d(a.keys, b.keys))
        nu = len(np.union1d(a.keys, b.keys))
        na, nb = a.n, b.n
    else:
        from zotpu_torch.workloads import setops as WS
        r = (WS.jaccard_sharded(a.keys, b.keys, a.k, shards, cache=cache,
                                device=device)
             if shards > 1 else WS.jaccard(a.keys, b.keys, device=device))
        na, nb, ni, nu = r["a"], r["b"], r["intersect"], r["union"]
    return int(na), int(nb), int(ni), int(nu)


def cmd_jaccard(args):
    """Pairwise similarity; with >2 inputs prints the full matrix."""
    device = None if args.host else _device(args.device)
    if len(args.inputs) == 2:
        if args.host or args.shards > 1:
            a, b = (_load_padded(p)[0] for p in args.inputs)
            na, nb, ni, nu = _pair_jaccard(a, b, args.host, args.shards,
                                           device=device)
        else:
            from zotpu_torch.workloads import setops as WS
            r = WS.jaccard_paths(*args.inputs, device=device)
            na, nb, ni, nu = (int(r[n]) for n in ("a", "b", "intersect",
                                                  "union"))
        print(json.dumps({"command": "jaccard", "a": na, "b": nb,
                          "intersect": ni, "union": nu,
                          "jaccard": ni / nu if nu else 0.0}))
        return 0
    sets = [_load_padded(p)[0] for p in args.inputs]
    # one partition cache for the whole matrix: each set is partitioned and
    # uploaded ONCE, not once per pair
    cache = {}
    for i in range(len(sets)):
        for j in range(i + 1, len(sets)):
            _, _, ni, nu = _pair_jaccard(sets[i], sets[j], args.host,
                                         args.shards, cache=cache,
                                         device=device)
            print(json.dumps({
                "command": "jaccard", "a": args.inputs[i],
                "b": args.inputs[j], "intersect": ni, "union": nu,
                "jaccard": ni / nu if nu else 0.0}))
    return 0


def cmd_hist(args):
    """Frequency spectrum of a set's counts (BASELINE config 4), one line
    per occupied bin; --cutoff adds the mixture fit of stats.py."""
    ks, counts = _load_padded(args.input)
    if args.host:
        h = G.spectrum(counts, max_count=args.max_count)
    else:
        from zotpu_torch.workloads import spectrum as WSp
        h = WSp.spectrum(counts, max_count=args.max_count,
                         device=_device(args.device))
    for freq in range(1, len(h)):
        if h[freq]:
            print(f"{freq}\t{int(h[freq])}")
    if args.cutoff:
        from zotpu_torch import stats as ST
        d = ST.spectrum_mixture_fit_detail(np.asarray(h, np.float64))
        print(json.dumps({"command": "hist", "cutoff": int(d["cutoff"]),
                          "coverage_peak": float(d["lam_g"]),
                          "genome_size_estimate":
                              int(d["genome_size_estimate"]),
                          "error_rate_lambda": round(d["lam_e"], 4),
                          "em_cutoff": int(d["em_cutoff"]),
                          "mixture_weights":
                              [round(x, 4) for x in d["weights"]],
                          "fit_ks": round(d["ks"], 4)}))
    return 0


def cmd_filter(args):
    """Drop k-mers below a count threshold (the config-4 error-trim step).

    --auto derives the threshold from the spectrum's error-peak cutoff (the
    device spectrum); --min-count N needs no device."""
    ks, counts = _load_padded(args.input)
    if args.auto:
        from zotpu_torch.workloads import spectrum as WSp
        min_count = WSp.spectrum_with_cutoff(
            counts, device=_device(args.device))["cutoff"]
    else:
        min_count = args.min_count
    if min_count is None:
        raise ValueError("pass --min-count N or --auto")
    mask = counts >= np.uint32(min_count)
    container.write(args.output, container.KmerSet(
        k=ks.k, keys=ks.keys[mask], counts=counts[mask],
        meta={"tool": "zotpu_torch filter", "min_count": int(min_count)}),
        codec=args.codec or "raw")
    print(json.dumps({"command": "filter", "min_count": int(min_count),
                      "kept": int(mask.sum()), "of": int(ks.n)}))
    return 0


def cmd_scan(args):
    """Panel pulldown over read sets (zotpu/cli.py cmd_scan). Overlong reads
    are halo-chunked into several device rows, and the rows re-aggregate per
    input record, so totals, reads_with_hits and --per-read rows stay
    record-aligned. In a multi-controller run every process holds every
    sample's summary and process 0 prints them; per-read vectors exist only
    on the sample's owner, which prints and writes them (each process to
    its own --out-reads file, suffixed .pI)."""
    _no_host_multi(args)
    device = None if args.host else _device(args.device)
    host_id, _, device = _init_multihost(args, device, files=args.samples,
                                         assign=False)
    panel, _ = _load_padded(args.panel)
    if args.host:
        results = []
        for p in args.samples:
            hits = G.scan_panel(panel.k, panel.keys,
                                _read_all_seqs([p]))
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
    out_path = args.out_reads
    if out_path and _multi(args):
        out_path = f"{out_path}.p{host_id}"
    out_fh = open(out_path, "w") if out_path else None
    for path, (total, reads_hit, per_read) in zip(args.samples, results):
        if host_id == 0:
            print(json.dumps({"command": "scan", "sample": path,
                              "k": panel.k, "total_hits": total,
                              "reads_with_hits": reads_hit}))
        if per_read is None:
            continue  # another process owns this sample's rows
        if args.per_read:
            for i, h in enumerate(per_read):
                print(f"{path}\t{i}\t{h}")
        if out_fh is not None:
            _write_hit_reads(out_fh, path, per_read, args.min_hits)
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
        seqs = _read_all_seqs([sample])
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
            keys, counts = G.kmerize(k, _read_all_seqs([sample]))
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


def _expand_variant_specs(specs):
    """Expand ``@FILE`` entries into the HGVS specs the file lists.

    Clinical panels run to hundreds of variants, which do not fit argv
    comfortably; ``@vars.txt`` reads one spec per line (blank lines and
    ``#`` comments skipped). Plain specs pass through unchanged."""
    out = []
    for s in specs:
        if s.startswith("@"):
            with open(s[1:]) as f:
                for line in f:
                    line = line.split("#", 1)[0].strip()
                    if line:
                        out.append(line)
        else:
            out.append(s)
    return out


def cmd_probes(args):
    """Variant descriptions -> discriminating k-mer probe panel (ZKF).

    Reference analog: zotmer's HGVS probe generation (SURVEY.md section 2a
    clinical family); per-variant ref/alt probe lists ride in the container
    metadata for host-side attribution by `evidence`."""
    args.variants = _expand_variant_specs(args.variants)
    keys, meta = V.build_panel(args.variants, args.reference, args.k,
                               transcripts_path=args.transcripts)
    container.write(args.output, container.KmerSet(
        k=args.k, keys=keys, counts=None,
        meta={"tool": "zotpu_torch probes", **meta}),
        codec=args.codec or "raw")
    print(json.dumps({"command": "probes", "variants": len(args.variants),
                      "probes": len(keys)}))
    return 0


def cmd_query(args):
    """Point lookups: k-mer strings (or every k-mer of longer sequences with
    --seq) -> counts in a set.

    Reference analog: zotmer's sparse rank/select membership surface
    (SURVEY.md section 2a "sparse/succinct set") exposed interactively --
    the CLI front door to zotpu_torch/sparse.py. Queries canonicalize first, so
    either strand of a k-mer finds its count."""
    ks, counts = _load_padded(args.input)
    k = ks.k
    sset = SparseSet(ks.keys)
    # same @FILE expansion as the variant commands
    specs = _expand_variant_specs(args.kmers)
    found = 0
    for q in specs:
        qs = q.upper()
        if not args.seq and len(qs) != k:
            raise ValueError(f"query {q!r} is {len(qs)} bases; the set has "
                             f"k={k} (use --seq to query every k-mer of a "
                             f"longer sequence)")
        keys = G.kmerize_seq(k, qs)
        if len(keys) == 0:
            print(json.dumps({"query": q, "count": 0,
                              "note": "no valid ACGT window"}))
            continue
        uniq = np.unique(keys)
        if ks.n == 0:  # empty set: every query misses (counts[0] would
            # IndexError through the eager np.where)
            mask = np.zeros(len(uniq), bool)
            cnt = np.zeros(len(uniq), np.int64)
        else:
            mask = sset.access(uniq)
            cnt = np.where(mask, counts[np.minimum(sset.rank(uniq),
                                                   ks.n - 1)], 0)
        if args.seq:
            print(json.dumps({
                "query": q, "kmers": int(len(keys)),
                "distinct": int(len(uniq)), "present": int(mask.sum()),
                "total_count": int(cnt.sum())}))
        else:
            print(json.dumps({"query": q, "count": int(cnt[0])}))
        found += int(mask.sum())
    return 0 if found or not specs else 1


def cmd_spikein(args):
    """Simulate reads from a reference with variants at a given VAF."""
    args.variants = _expand_variant_specs(args.variants)
    stats = V.spike_reads(args.reference, args.variants, args.output,
                          coverage=args.coverage, vaf=args.vaf,
                          read_len=args.read_len,
                          error_rate=args.error_rate, seed=args.seed,
                          transcripts_path=args.transcripts)
    print(json.dumps({"command": "spikein", "output": args.output, **stats}))
    return 0


def cmd_sample(args):
    ks, counts = _load_padded(args.input)
    keys, cnts = G.sample(ks.keys, counts, args.rate, seed=args.seed)
    container.write(args.output, container.KmerSet(
        k=ks.k, keys=keys, counts=cnts,
        meta={"tool": "zotpu_torch sample", "rate": args.rate,
              "seed": args.seed}),
        codec=args.codec or "raw")
    print(json.dumps({"command": "sample", "kept": len(keys), "of": ks.n}))
    return 0


def cmd_dump(args):
    ks, counts = _load_padded(args.input)
    # vectorized text render: a per-key python loop (G.decode_kmer) takes
    # minutes on a WGS-scale set; this does ~2M rows/s in numpy blocks
    k = ks.k
    shifts = np.array([2 * (k - 1 - i) for i in range(k)], np.uint64)
    out = sys.stdout
    for lo in range(0, ks.n, 1 << 20):
        keys = ks.keys[lo:lo + (1 << 20)]
        codes = (keys[:, None] >> shifts[None, :]) & np.uint64(3)
        chars = S.DECODE_LUT[codes.astype(np.uint8)]
        block = np.empty((len(keys), k + 1), np.uint8)
        block[:, :k] = chars
        block[:, k] = ord("\t")
        text = block.tobytes().decode("ascii").split("\t")[:-1]
        out.write("".join(f"{s}\t{int(c)}\n" for s, c in
                          zip(text, counts[lo:lo + (1 << 20)])))
    return 0


def cmd_info(args):
    for p in args.inputs:
        hdr = container.read_header(p)
        print(json.dumps({"file": p, **hdr}))
    return 0


def cmd_verify(args):
    a, ca = _load_padded(args.a)
    b, cb = _load_padded(args.b)
    if a.k != b.k:
        print(json.dumps({"equal": False, "reason": f"k {a.k} != {b.k}"}))
        return 1
    if (a.counts is None) != (b.counts is None) and not args.as_sets:
        # a counts-less kset is a membership set, not an all-ones kfset;
        # reporting them equal hid a real format difference. --as-sets opts
        # into the membership-only comparison.
        which = args.a if a.counts is None else args.b
        print(json.dumps({"equal": False,
                          "reason": f"{which} has no counts (kset vs kfset; "
                                    f"pass --as-sets to compare membership "
                                    f"only)"}))
        return 1
    n = min(a.n, b.n)
    kdiff = np.nonzero(a.keys[:n] != b.keys[:n])[0]
    cdiff = (np.empty(0, np.int64) if args.as_sets
             else np.nonzero(ca[:n] != cb[:n])[0])
    first = min(
        int(kdiff[0]) if len(kdiff) else n if a.n != b.n else -1,
        int(cdiff[0]) if len(cdiff) else n if a.n != b.n else -1,
        key=lambda x: x if x >= 0 else 1 << 62)
    if first == -1:
        print(json.dumps({"equal": True, "n": int(a.n)}))
        return 0
    print(json.dumps({"equal": False, "first_divergence": int(first),
                      "n_a": int(a.n), "n_b": int(b.n)}))
    return 1


def cmd_casket(args):
    """Named-member containers. Members are complete ZKF streams; every
    reading command accepts 'casket.zkc#member' addressing."""
    if args.verb == "ls":
        print(json.dumps({"file": args.casket,
                          **container.casket_toc(args.casket)}))
        return 0
    if args.verb == "new":
        members = []
        for spec in args.members:
            name, _, src = spec.partition("=")
            if not name or not src:
                raise ValueError(f"member spec {spec!r} is not NAME=SET.zkf")
            members.append((name, container.read(src)))
        ks = [m[1].k for m in members]
        if len(set(ks)) > 1:
            raise ValueError(f"K mismatch across members: {sorted(set(ks))}")
        container.casket_write(args.casket, members,
                               codec=args.codec or "raw")
        print(json.dumps({"file": args.casket,
                          "members": [m[0] for m in members]}))
        return 0
    if args.verb == "add":
        container.casket_add(args.casket, args.name,
                             container.read(args.source),
                             codec=args.codec or "raw")
        print(json.dumps({"file": args.casket, "added": args.name}))
        return 0
    if args.verb == "extract":
        container.write(args.output,
                        container.casket_read(args.casket, args.name),
                        codec=args.codec or "raw")
        print(json.dumps({"file": args.output, "from": args.casket,
                          "member": args.name}))
        return 0
    raise AssertionError(args.verb)


def cmd_selftest(args):
    """The device paths against golden on small fixtures, byte for byte
    (selftest.py): the gate to run on a card before a benchmark."""
    from zotpu_torch.selftest import run_selftest
    return run_selftest(k=args.k, device=_device(args.device))


def cmd_bench(args):
    """The performance harness on the card, or on the CPU with --device
    cpu (plain versions: a check of the workloads, not a measurement)."""
    from zotpu_torch.bench import harness
    args.device = _device(args.device)
    return harness.run(args)


def build_parser() -> argparse.ArgumentParser:
    from zotpu_torch import __version__
    p = argparse.ArgumentParser(
        prog="zotpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-V", "--version", action="version",
                   version=f"zotpu_torch {__version__}")
    sub = p.add_subparsers(dest="command", required=True)

    def device_flag(sp):
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda runs the CUDA kernels; cpu their plain "
                             "PyTorch versions")

    def batch_flags(sp):
        host_flag(sp)
        sp.add_argument("--batch-reads", type=int, default=4096)
        sp.add_argument("--max-len", type=int, default=256)
        device_flag(sp)

    def out_codec(sp):
        sp.add_argument("--codec", choices=("raw", "zlib", "delta"),
                        default=None, help="output container codec")

    def host_flag(sp):
        sp.add_argument("--host", action="store_true",
                        help="use the golden numpy path instead of the "
                             "device kernels")

    def shard_flags(sp, what, shard_hash=True):
        sp.add_argument("--shards", type=int, default=1,
                        help=f"{what} across N device slots (power of two)")
        if shard_hash:
            sp.add_argument("--shard-hash", choices=("prefix", "mixed"),
                            default="prefix", dest="shard_hash",
                            help="shard owner function: key prefix or a "
                                 "mixed 32-bit hash (balanced under "
                                 "GC-content skew; output bytes identical)")
        sp.add_argument("--coordinator", default=None,
                        help="HOST:PORT of process 0 for multi-controller "
                             "runs (torch.distributed)")
        sp.add_argument("--num-processes", type=int, default=None,
                        help="total processes of a multi-controller run")
        sp.add_argument("--process-id", type=int, default=None,
                        help="this process's id in [0, num-processes)")

    sp = sub.add_parser("kmerize", help="FASTA/FASTQ -> k-mer set with counts")
    sp.add_argument("-k", type=int, required=True, dest="k")
    sp.add_argument("--batch-reads", type=int, default=4096)
    sp.add_argument("--max-len", type=int, default=256)
    sp.add_argument("--merge-capacity", type=int, default=1 << 26,
                    help="device accumulator capacity in unique k-mers")
    sp.add_argument("--spill-dir", default=None,
                    help="write per-batch sorted runs here (restartable)")
    sp.add_argument("--resume", action="store_true",
                    help="reuse completed runs in --spill-dir after a crash")
    sp.add_argument("--compress", action="store_true",
                    help="zlib-compress the output container blobs "
                         "(legacy alias for --codec zlib)")
    shard_flags(sp, "shard the k-mer key space")
    out_codec(sp)
    sp.add_argument("--metrics", default=None,
                    help="append JSONL stage metrics to this file")
    sp.add_argument("--trace", default=None,
                    help="write a torch.profiler trace (DIR/trace.json) of "
                         "the run to this directory")
    host_flag(sp)
    device_flag(sp)
    sp.add_argument("output")
    sp.add_argument("inputs", nargs="+")
    sp.set_defaults(fn=cmd_kmerize)

    sp = sub.add_parser("merge", help="merge N sets, summing counts")
    sp.add_argument("output")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--merge-capacity", type=int, default=1 << 26,
                    help="device accumulator capacity in unique k-mers")
    host_flag(sp)
    out_codec(sp)
    device_flag(sp)
    sp.set_defaults(fn=cmd_merge)

    for op in ("union", "intersect", "diff"):
        sp = sub.add_parser(op, help=f"{op} of two sets")
        sp.add_argument("output")
        sp.add_argument("a")
        sp.add_argument("b")
        shard_flags(sp, "key-prefix-shard both sets", shard_hash=False)
        sp.add_argument("--stream", action="store_true",
                        help="partition the inputs straight from the "
                             "container files in O(chunk) host memory (sets "
                             "larger than host memory)")
        host_flag(sp)
        out_codec(sp)
        device_flag(sp)
        sp.set_defaults(fn=lambda a, _op=op: _binary_setop(a, _op))

    sp = sub.add_parser("jaccard", help="similarity of two or more sets")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--shards", type=int, default=1,
                    help="shard the cardinality computation over N slots")
    host_flag(sp)
    device_flag(sp)
    sp.set_defaults(fn=cmd_jaccard)

    sp = sub.add_parser("hist", help="k-mer frequency spectrum")
    sp.add_argument("input")
    sp.add_argument("--max-count", type=int, default=1024)
    sp.add_argument("--cutoff", action="store_true",
                    help="also print the error-peak cutoff")
    host_flag(sp)
    device_flag(sp)
    sp.set_defaults(fn=cmd_hist)

    sp = sub.add_parser("filter", help="drop k-mers below a count threshold")
    sp.add_argument("output")
    sp.add_argument("input")
    sp.add_argument("--min-count", type=int, default=None)
    sp.add_argument("--auto", action="store_true",
                    help="derive the threshold from the error-peak cutoff")
    out_codec(sp)
    device_flag(sp)
    sp.set_defaults(fn=cmd_filter)

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
    sp.set_defaults(fn=cmd_probes)

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
    sp.set_defaults(fn=cmd_query)

    sp = sub.add_parser("spikein",
                        help="simulate reads with variants at a given VAF")
    sp.add_argument("reference")
    sp.add_argument("output", help="FASTQ (.gz ok) to write")
    sp.add_argument("variants", nargs="+",
                    help="HGVS-style specs (@FILE reads one per line)")
    sp.add_argument("--vaf", type=float, default=0.5)
    sp.add_argument("--coverage", type=float, default=30.0)
    sp.add_argument("--read-len", type=int, default=100)
    sp.add_argument("--error-rate", type=float, default=0.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--transcripts", metavar="TSV",
                    help="gene models enabling c./n. variant specs")
    sp.set_defaults(fn=cmd_spikein)

    sp = sub.add_parser("sample", help="hash-threshold downsample")
    sp.add_argument("--rate", type=float, required=True)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("output")
    sp.add_argument("input")
    out_codec(sp)
    sp.set_defaults(fn=cmd_sample)

    sp = sub.add_parser("dump", help="print k-mers and counts as text")
    sp.add_argument("input")
    sp.set_defaults(fn=cmd_dump)

    sp = sub.add_parser("info", help="print container metadata")
    sp.add_argument("inputs", nargs="+")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("verify", help="compare two sets byte-for-byte")
    sp.add_argument("a")
    sp.add_argument("b")
    sp.add_argument("--as-sets", action="store_true",
                    help="compare membership only")
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser("casket", help="named-member containers; reading "
                        "commands accept CASKET.zkc#member everywhere")
    cs = sp.add_subparsers(dest="verb", required=True)
    c = cs.add_parser("ls", help="print the member table")
    c.add_argument("casket")
    c.set_defaults(fn=cmd_casket)
    c = cs.add_parser("new", help="build a casket from NAME=SET.zkf specs")
    c.add_argument("casket")
    c.add_argument("members", nargs="+", metavar="NAME=SET.zkf")
    out_codec(c)
    c.set_defaults(fn=cmd_casket)
    c = cs.add_parser("add", help="add or replace one member")
    c.add_argument("casket")
    c.add_argument("name")
    c.add_argument("source", help="a ZKF file or CASKET#member")
    out_codec(c)
    c.set_defaults(fn=cmd_casket)
    c = cs.add_parser("extract", help="copy a member out to a ZKF file")
    c.add_argument("casket")
    c.add_argument("name")
    c.add_argument("output")
    out_codec(c)
    c.set_defaults(fn=cmd_casket)

    sp = sub.add_parser("selftest",
                        help="every device path against golden on small "
                             "fixtures (the gate before a benchmark)")
    sp.add_argument("-k", type=int, default=25, dest="k")
    device_flag(sp)
    sp.set_defaults(fn=cmd_selftest)

    from zotpu_torch.bench.harness import WORKLOADS
    sp = sub.add_parser("bench", help="performance harness")
    sp.add_argument("--workload", default="kmerize",
                    choices=[*WORKLOADS, "all"])
    sp.add_argument("--bases", type=int, default=1 << 26)
    sp.add_argument("--k", type=int, default=25)
    sp.add_argument("--repeats", type=int, default=3)
    sp.add_argument("--setops-n", type=int, default=None,
                    help="keys per side for the setops workload")
    sp.add_argument("--scan-reads", type=int, default=None,
                    help="reads for the scan workload")
    sp.add_argument("--scan-panel", type=int, default=None,
                    help="panel size for the scan workload")
    device_flag(sp)
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # a group this call joins it also leaves; a caller's group stays
    owned = not dist.is_initialized()
    try:
        return args.fn(args)
    except BrokenPipeError:
        # a downstream reader (e.g. `scan --per-read | head`) closed the pipe
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
