#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place with every key held in its low 32 bits, as a narrower
packing would hold it, and judged by the cell's own comparison. Its
readings must come out over the limits, or the comparison could not tell
such a shortcut from the program.

    python3 benchmark/control.py --workload CELL --seeds 11 12 13

prints one JSON line a seed with the control's readings and the limits,
at the cell's own size on its first card (``--device cpu`` and
``run.main``'s ``cfg_patch`` are for the tests). Exits 1 where a seed's
readings are all within the limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(spec, cfg: dict, seed: int, device) -> dict:
    """The control's readings on the inputs of ``seed``."""
    from benchmark import fixture
    with tempfile.TemporaryDirectory(prefix="zotpu-bench-") as tmp:
        inputs = fixture.make_inputs(cfg, spec.traffic, seed, device, tmp)
    job = spec.job.Job(cfg, inputs, [device])
    want = job.expected(device)
    control = job.render(job.expected(device, key_bits=32))
    return job.compare([control], want)[0]


def main(argv=None, cfg_patch: dict | None = None) -> int:
    import torch
    from benchmark import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = run.load_cell(args.workload)
    cfg = {**spec.cfg, **(cfg_patch or {})}
    device = torch.device(args.device)
    limits = spec.job.LIMITS
    failed_all = True
    for seed in args.seeds:
        got = readings(spec, cfg, seed, device)
        over = any(got[n] > limits[n] for n in limits)
        failed_all &= over
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got, "limits": limits,
                          "control_correct": not over}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
