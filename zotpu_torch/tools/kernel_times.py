"""Time the redesigned kernels of one or more zotpu_torch trees in one call.

    python -m zotpu_torch.tools.kernel_times [TREE ...]

Each TREE is a directory that holds a ``zotpu_torch`` package (default: the
tree this file lives in). To compare a change with its parent on the same
card, unpack the parent (``git archive``) into a directory and name the
trees in turns: ``PARENT . . PARENT``. Every tree runs in a process of its
own, builds its own kernels, and times the wrappers ``pack_canonical_wire``
(K1a), ``pack_canonical`` (K1b), ``dedup_compact`` (K2), ``set_op_fused``
op="merge" with valid counts (K3), ``row_hits_sorted_join`` against a
2^21-key panel (K4), and the receive tree's ``merge_runs_pass`` without
(K5) and with a payload (K7) and ``merge_dedup_pass`` (K6) at the main
paths' shapes: a batch of 65,536 rows x 160 bases, k=25, from a seed; the
receive tree on what slot 0 of 4 receives of such a batch (4 runs of
2,228,224 slots, about 40% of them valid keys, about half of those
unique). Two times per kernel, both by
CUDA events, median of 9 after 3 warm-ups: ``ms`` with the stream kept busy
by a spin kernel first, so that the launches are queued and the time is the
device's alone, and ``eager_ms`` from an idle stream, which adds the
wrapper's host time; and ``device_rows_us``, the mean microseconds of each
device kernel the wrapper launches, by ``torch.profiler`` over 20 calls (a
wrapper's partition, main and closing kernels apart). Prints one JSON line
per tree and kernel, after a line with the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROWS, LENGTH, K = 65536, 160, 25
SHARDS = 4                     # the receive tree's slot count
SPIN_CYCLES = 3_500_000        # about 2 ms of the card's clock


def _ms(torch, fn, queued: bool) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(9):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_rows_us(torch, fn, reps: int = 20) -> dict[str, float]:
    """Mean microseconds of every device kernel that fn() launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:64]: e.device_time_total / e.count
            for e in prof.key_averages() if e.device_time_total > 0}


def time_tree(label: str) -> None:
    """Time the kernels of the zotpu_torch package on sys.path."""
    import numpy as np
    import torch

    from zotpu_torch.kernels import (join, merge_dedup, merge_fused,
                                     merge_runs, pack, sortdedup)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # any bits are wire words; a sprinkling of invalid flags as in reads
    packed = rng.integers(0, 1 << 32, (ROWS, LENGTH // 16), dtype=np.uint64)
    mask = (rng.random((ROWS, LENGTH // 32, 32)) < 1e-4).astype(np.uint64)
    mask = (mask << np.arange(32, dtype=np.uint64)).sum(axis=2)
    p = torch.from_numpy(packed.astype(np.uint32).view(np.int32)).to(dev)
    m = torch.from_numpy(mask.astype(np.uint32).view(np.int32)).to(dev)
    n = torch.full((ROWS,), 150, dtype=torch.int32, device=dev)
    codes = torch.from_numpy(
        rng.integers(0, 4, (ROWS, LENGTH)).astype(np.uint8)).to(dev)
    # keys that repeat as a 30x read set's do: about half are unique
    space = ROWS * (LENGTH - K + 1) // 2
    runs = []
    for _ in range(2):
        keys = torch.from_numpy(rng.integers(0, space, ROWS * (LENGTH - K + 1)
                                             )).to(dev)
        keys[-(keys.shape[0] // 14):] = torch.iinfo(torch.int64).max
        runs.append(torch.sort(keys).values)
    (ka, ca, na), (kb, cb, nb) = (sortdedup.dedup_compact(r) for r in runs)
    # a sorted unique panel; a fifth of the windows are panel keys
    panel = torch.unique(torch.from_numpy(
        rng.integers(0, 1 << (2 * K), 1 << 21)).to(dev))
    panel = torch.cat([panel, panel.new_full(
        ((1 << 21) - panel.shape[0],), torch.iinfo(torch.int64).max)])
    windows = pack.pack_canonical(codes, n, K)
    hit = torch.from_numpy(rng.random(windows.shape[0]) < 0.2).to(dev)
    windows = torch.where(hit, panel[torch.from_numpy(rng.integers(
        0, 1 << 20, windows.shape[0])).to(dev)], windows)
    # slot 0's received runs: ascending keys, then a sentinel tail
    cap = ROWS // SHARDS * (LENGTH - K + 1)
    received = []
    for _ in range(SHARDS):
        run = torch.full((cap,), torch.iinfo(torch.int64).max, device=dev)
        n_valid = int(cap * rng.uniform(0.35, 0.45))
        run[:n_valid] = torch.sort(torch.from_numpy(
            rng.integers(0, 2_500_000, n_valid)).to(dev)).values
        received.append(run)
    received = torch.cat(received)
    row_ids = torch.from_numpy(rng.integers(0, ROWS, SHARDS * cap)).to(dev)
    half = merge_runs.merge_runs_pass(received, None, cap)[0]
    cases = {
        "pack_canonical_wire": lambda: pack.pack_canonical_wire(p, m, n, K),
        "pack_canonical": lambda: pack.pack_canonical(codes, n, K),
        "dedup_compact": lambda: sortdedup.dedup_compact(runs[0]),
        "set_op_fused": lambda: merge_fused.set_op_fused(
            ka, ca, kb, cb, "merge", n_a=na, n_b=nb),
        "join_row_hits": lambda: join.row_hits_sorted_join(
            panel, windows, ROWS, LENGTH - K + 1),
        "merge_runs": lambda: merge_runs.merge_runs_pass(received, None, cap),
        "merge_dedup": lambda: merge_dedup.merge_dedup_pass(half, 2 * cap),
        "merge_runs_payload": lambda: merge_runs.merge_runs_pass(
            received, row_ids, cap),
    }
    for name, fn in cases.items():
        print(json.dumps({"tree": label, "kernel": name,
                          "ms": _ms(torch, fn, True),
                          "eager_ms": _ms(torch, fn, False),
                          "device_rows_us": _device_rows_us(torch, fn)}),
              flush=True)


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for tree in argv or [here]:
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=tree)
        # the timing code is this file's, whatever the tree's own version
        # holds: the tree supplies only its kernels package
        code = (f"import sys, importlib.util; sys.path.insert(0, sys.argv[1]);"
                f" spec = importlib.util.spec_from_file_location("
                f"'kernel_times', {os.path.abspath(__file__)!r});"
                f" mod = importlib.util.module_from_spec(spec);"
                f" spec.loader.exec_module(mod); mod.time_tree(sys.argv[1])")
        rc = subprocess.run([sys.executable, "-c", code, tree], env=env,
                            cwd=tree).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
