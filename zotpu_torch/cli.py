"""Command-line interface of the PyTorch/CUDA port.

    python -m zotpu_torch kmerize -k K [--batch-reads N] [--max-len L]
        [--merge-capacity N] [--codec C] [--device cuda|cpu] OUT IN...
    python -m zotpu_torch verify A B

``kmerize`` writes the same ZKF container as ``python -m zotpu kmerize``
(keys and counts; the meta names this tool). ``--device`` defaults to cuda
and never falls back: without a CUDA device it exits 1. ``--device cpu``
runs the kernels' plain PyTorch versions. ``verify`` is the JAX package's
host-only ``zotpu.cli.cmd_verify``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from zotpu import cli as zotpu_cli
from zotpu.io import container


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise ValueError("--device cuda needs a CUDA device and "
                         "torch.cuda.is_available() is false (pass "
                         "--device cpu to run the plain PyTorch versions)")
    return torch.device(name)


def cmd_kmerize(args):
    from zotpu_torch.workloads import kmerize as W
    device = _device(args.device)
    stats = W.Stats()
    keys, counts = W.kmerize_paths(
        args.inputs, args.k, batch_reads=args.batch_reads,
        max_len=args.max_len, stats=stats,
        merge_capacity=args.merge_capacity, device=device)
    container.write(args.output, container.KmerSet(
        k=args.k, keys=keys, counts=counts,
        meta={"tool": "zotpu_torch kmerize", "inputs": args.inputs,
              "stats": stats.as_dict()}),
        codec=args.codec or "raw")
    print(json.dumps({"command": "kmerize", **stats.as_dict()}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="zotpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("kmerize", help="FASTA/FASTQ -> k-mer set with counts")
    sp.add_argument("-k", type=int, required=True, dest="k")
    sp.add_argument("--batch-reads", type=int, default=4096)
    sp.add_argument("--max-len", type=int, default=256)
    sp.add_argument("--merge-capacity", type=int, default=1 << 26,
                    help="device accumulator capacity in unique k-mers")
    sp.add_argument("--codec", choices=("raw", "zlib", "delta"), default=None,
                    help="output container codec")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "PyTorch versions")
    sp.add_argument("output")
    sp.add_argument("inputs", nargs="+")
    sp.set_defaults(fn=cmd_kmerize)

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
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
