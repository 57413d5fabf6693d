"""Micro-benchmarks dissecting the kmerize step on the card: pack vs sort
vs dedup, beside the PyTorch primitives of the same size.

    python -m zotpu_torch.bench.micro [n_log2]      # default 24

Port of zotpu/bench/micro.py. Rows, each over n = 2^n_log2 elements:

- ``pack``: the u8-code pack kernel (K1b) over reads of 256 bases, k=25
  (the rows hold about n windows);
- ``sort_i64``: ``torch.sort`` of int64 keys. It stands in for the JAX
  rows ``sort_1xu32`` and ``sort_2xu32``: the port's keys are int64, not
  two u32 words;
- ``sort+dedup``: ``kmer_sort_dedup`` of the pack's keys, ``torch.sort``
  then the dense dedup-compact kernel (K2). It stands in for
  ``dedup_scatter`` and ``sort+dedup``;
- ``scatter``, ``gather``, ``cumsum_i32``: the torch ops.

Each row is timed by CUDA events, min of 3 after a warm-up, with the card
synchronised before each. Prints the card's name, one line a row, and last
one JSON object with the rows' milliseconds and the kernels' launches.
Needs a CUDA device: without one it exits 1.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from zotpu_torch import kernels
from zotpu_torch.kernels.pack import pack_canonical
from zotpu_torch.kernels.sortdedup import kmer_sort_dedup

K, READ_LEN = 25, 256


def rows(n_log2: int, device) -> tuple[dict, int, int]:
    """The rows' callables on ``device``: {name: (fn, elements)}, and the
    pack's read count and window count."""
    n = 1 << n_log2
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, 1 << 50, n)).to(device)
    reads = max(n // (READ_LEN - K + 1), 1)
    codes = torch.from_numpy(rng.integers(0, 4, size=(reads, READ_LEN))
                             .astype(np.uint8)).to(device)
    lengths = torch.full((reads,), READ_LEN, dtype=torch.int32,
                         device=device)
    m = reads * (READ_LEN - K + 1)
    packed = pack_canonical(codes, lengths, K)
    seg = torch.arange(n, device=device)
    return {
        "pack": (lambda: pack_canonical(codes, lengths, K), m),
        "sort_i64": (lambda: torch.sort(keys), n),
        "sort+dedup": (lambda: kmer_sort_dedup(packed), m),
        "scatter": (lambda: torch.zeros_like(keys).scatter_(0, seg, keys), n),
        "gather": (lambda: keys[seg], n),
        "cumsum_i32": (lambda: torch.cumsum((keys & 1).to(torch.int32), 0,
                                            dtype=torch.int32), n),
    }, reads, m


def cuda_ms(fn, repeats: int = 3) -> float:
    """Min milliseconds of fn() by CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_log2 = int(argv[0]) if argv else 24
    if not torch.cuda.is_available():
        print("error: the micro-benchmarks need a CUDA device "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    before = kernels.launches()
    fns, reads, m = rows(n_log2, device)
    print(f"n = 2^{n_log2} = {1 << n_log2}  pack over {reads}x{READ_LEN} "
          f"({m} kmers) on {torch.cuda.get_device_name(device)}", flush=True)
    out = {}
    for name, (fn, elems) in fns.items():
        ms = out[name] = cuda_ms(fn)
        print(f"  {name:28s} {ms:9.3f} ms   {elems / ms / 1e6:8.3f} Gelem/s",
              flush=True)
    launches = {name: n - before[name]
                for name, n in kernels.launches().items() if n > before[name]}
    print(json.dumps({"n_log2": n_log2, "device":
                      torch.cuda.get_device_name(device), "ms": out,
                      "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
