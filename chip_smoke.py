#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (zotpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]      # from the repository root

Phases (any failure exits non-zero; no exception is caught):

1. the card's name and power limit (nvidia-smi), then the kernel build
   and the native FASTQ parser's (the numpy fallback in use is a failure);
   then (1b) the self-test, the gate before the long phases: (a)
   ``python -m zotpu_torch selftest -k 25`` in process on the card's own
   slots (one card: D = 1, the mixed-hash check skips and both forced
   second rounds run), (b) ``run_selftest(k=25, devices=[cuda:0] * 4)``,
   whose D = 4 checks run over 4 slots on the card; each must end ``"ok":
   true``, ``"failed": 0`` and not partial, and the two together must
   launch K1a, K2, K3, K4, K4 tagged, K5, K6 and K7; (c) ``kmerize
   --metrics --trace`` on a small fixture: the JSONL line has the JAX
   package's keys and the stats line's counts, and the trace file is JSON
   holding CUDA kernel events of K1a, K2 and K3;
2. the card's device-to-device copy rate; the set-op, pack and
   receive-tree kernels (K3, K1, K5-K7) on the edge shapes of
   ``zotpu_torch/kernels/edge_cases.py``; then each
   kernel against its plain PyTorch version on the same CUDA tensors at
   the main path's shapes (a batch of 65,536 reads x 160, k=25; the join
   against the scan panel of phase 5; the set-op kernel also at the
   accumulator's level-3 shape): exact equality over what the contract
   defines, both times by CUDA events (median of several runs), the bound
   from the contract bytes (each input read once, each output written
   once) at the published 3.35 TB/s and at the measured copy rate, and
   the time of the one PyTorch call that computes the same function where
   there is one (``torch.unique_consecutive`` for K2, ``torch.searchsorted``
   for K4); then (2b) the same kind of batch split over 4 slots on this
   card and routed by the sharded step's own ``_route``: the receive-tree
   kernels K5, K6 and K7 and K4's tagged entry on slot 0's received runs
   (about 8.9M slots), and the cost of the host read of the second-round
   flag;
3. the kmerize path at real size: ``python -m zotpu_torch kmerize -k 25``
   on a synthetic E. coli K-12-sized genome (4,641,652 bp) read at 30x
   (150 bp, 0.5% substitutions, a sprinkling of N), checked against an
   oracle that uses neither K2, K3 nor the accumulator (plain pack per
   batch, torch.cat, torch.unique); then the same fixture through the u8
   pack path (--max-len 150), which must give the same container. The
   launch counts are set to 0 just before each of these two runs and read
   just after it: the wire run's counts for K1a, K2 and K3, the u8 run's
   for K1b; each must be > 0; then the host pipeline alone and a warm
   rerun under torch.profiler for the device's busy share;
4. golden: a ~1 Mbase subset through the CLI's u8 path (--max-len 150)
   against zotpu_torch.reference_impl.golden.kmerize;
5. the scan path at real size (BASELINE config 5): ``python -m zotpu_torch
   scan`` of the same reads, split into 16 samples, against a panel of the
   canonical 25-mers of the genome's first 1,000,000 bp plus 2^20 random
   keys, checked against an oracle that uses neither the join module nor
   K4 (plain pack per batch, torch.isin, a row sum, the record sums); the
   counts are reset just before the run and K1a and K4 must each equal the
   batch count; then the subset through the u8 path against
   golden.scan_panel;
6. ``evidence --out-reads`` on spiked reads of a genome slice against
   golden.kmerize + variants.evidence_from_counts and golden.scan_panel;
7. sharded kmerize (``kmerize_paths_sharded``) of the 30x reads over 4
   slots on this card, prefix and mixed owner, each equal to phase 3's
   container (so to the oracle); the counts are reset before each run and
   K5, K6 and K3 must run; then a forced second round on one slot with a
   capacity factor of 0.9, which must take the overflow round and stay
   equal;
8. sharded scan (``pulldown_paths_sharded``) of the 16 samples over 4
   slots, equal per sample and per read to the single-device
   ``pulldown_paths``; K7 and K4's tagged entry must run;
9. merge (BASELINE config 2): each of the 16 samples kmerized by the CLI,
   then ``python -m zotpu_torch merge`` of the 16 containers, which must
   equal phase 3's container of the whole run (``verify``); K3 must run;
10. set algebra and jaccard (config 3) on two sample-sized sets, the merge
   of samples 0-7 and of samples 8-15: the CLI's ``union``, ``intersect``,
   ``diff`` and ``jaccard`` (a pair, and the matrix of the two sets and
   phase 9's merge) on one device against an oracle on the card
   that uses no kernel of the port (``torch.isin`` for membership,
   ``torch.unique`` + ``index_add_`` for the summed counts); then
   ``set_op_sharded``, ``jaccard_sharded`` and ``set_op_sharded_stream``
   over 4 slots on this card, each equal to the single-device result (the
   CLI's ``--shards N`` asks for N cards, so the slots are placed through
   ``devices=`` as in phases 7 and 8), and the CLI's ``--stream`` on the
   card's one slot; and K3 against its plain version at
   the JAX package's set-op bench size, 2^24 random keys a side
   (zotpu/bench/harness.py ``bench_setops``), for each op, with the
   bytes that op must move (``setop_bytes``);
11. spill/resume: ``kmerize --spill-dir`` of four samples, uninterrupted,
   then interrupted after two batches and resumed with ``--resume``: the
   two directories hold the same files, and both results equal the
   accumulator run of the same inputs; the final merge is the K3 merge
   tree (the runs hold more than ``DEVICE_MERGE_THRESHOLD`` keys); then one
   sharded spill run over 4 slots;
12. spectrum (config 4): ``hist --cutoff`` and ``filter --auto`` on phase
   3's container; the histogram must equal ``golden.spectrum``, the
   coverage peak must sit within 15% of 30 x 126 / 150 and the genome-size
   estimate within 15% of the genome's length;
13. multi-controller runs on ``torch.distributed``: P = 2 processes started
   by this script, each with L = 2 slots on this card (D = 4), on the gloo
   backend (NCCL refuses two ranks on one card), run the CLI with
   ``--coordinator --num-processes 2 --process-id I``: (a) ``kmerize`` of
   the 16 samples, prefix and mixed owners, each equal to phase 3's
   container (``verify``); (b) ``scan --per-read`` of the 16 samples:
   process 0's summary lines equal phase 5's, and the per-read rows each
   process prints for its own samples equal the single-device scan's
   (phase 8's reference run); (c) ``union`` of phase 10's A and B,
   streamed, equal to phase 10's union; (d) ``kmerize --spill-dir`` of
   phase 11's samples crashed after one batch (``fail_after_batches``) and
   resumed with ``--resume``: equal to phase 11's accumulator run, with a
   run file per process and batch. Each call prints its wall time, the
   bytes that crossed processes, the backend and each process's launches
   of K1a, K3, K4 tagged, K5, K6 and K7, which must run. With two or more
   cards the CLI itself also runs with one process per card on NCCL;
   then (13b) the entry points of ``zotpu_torch/entry.py``: ``entry()``'s
   step on the card (K1b, ``torch.sort``, K2) against the same step on its
   arguments moved to the CPU, and ``dryrun_multichip(4)`` over 4 slots
   of this card (every multi-device path once on tiny shapes: K1a, K1b,
   K3, K4 tagged, K5, K6 and K7 must each run) against golden and the
   same call on 4 CPU slots; with four or more cards also over four
   distinct cards, against the one-card run (with fewer, one line says it
   ran on one card); one line with the wall times, the bytes sent and
   the card;
14. the performance harness at the CLI's defaults (full width: 2^26 bases,
   2^24 keys a side, 2^17 reads against a 2^20-key panel), in processes
   of its own: ``python -m zotpu_torch bench --workload all``, then
   ``--workload setops-sort`` (which ``all`` leaves out, as the JAX
   harness does): every line parses, all twelve workloads appear, every
   number is finite and above 0, each record names this card and reports
   the kernels its workload must launch, the scan and its shard model
   count the same hits, the forced second round costs more than 0 and the
   load sweep has five points; then ``python -m zotpu_torch.bench.micro
   24``, whose six rows must print with their times and which must launch
   K1b and K2. Every record is printed, with the phase's seconds.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
one JSON object with every kernel's launches (on the paths of phases 3-13,
in phase 13b's entry points as ``entry_launches`` and in phase 14's bench
as ``bench_launches``), error, times and bound.
The script imports nothing of the JAX package ``zotpu``: it runs from a
tree that holds ``chip_smoke.py`` and ``zotpu_torch/`` alone.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

GENOME_BP = 4_641_652          # E. coli K-12 MG1655
READ_LEN = 150
COVERAGE = 30
SUB_RATE = 0.005
N_RATE = 1e-4
K = 25
BATCH_READS = 65536
MAX_LEN = 160                  # 32 | 160: the wire path
SUBSET_READS = 6700            # ~1 Mbase for the golden check
N_SAMPLES = 16                 # BASELINE config 5: 16 read sets, one panel
PANEL_BP = 1_000_000           # the panel's genomic part (harness.py:207)
PANEL_RANDOM = 1 << 20         # and its random background keys

# name -> (source, the Pallas call it replaces)
KERNEL_INFO = {
    "pack_canonical_wire": ("zotpu_torch/csrc/pack.cu",
                            "zotpu/kernels/pack_pallas.py:222"),
    "pack_canonical": ("zotpu_torch/csrc/pack.cu",
                       "zotpu/kernels/pack_pallas.py:173"),
    "dedup_compact": ("zotpu_torch/csrc/dedup.cu",
                      "zotpu/kernels/dedup_pallas.py:287"),
    "set_op_fused": ("zotpu_torch/csrc/merge.cu",
                     "zotpu/kernels/merge_fused.py:609"),
    "join_row_hits": ("zotpu_torch/csrc/join.cu",
                      "zotpu/kernels/sort_pallas.py:676"),
    "join_row_hits_tagged": ("zotpu_torch/csrc/join.cu",
                             "zotpu/kernels/sort_pallas.py:676"),
    "merge_runs": ("zotpu_torch/csrc/merge_runs.cu",
                   "zotpu/kernels/sort_pallas.py:900"),
    "merge_dedup": ("zotpu_torch/csrc/merge_runs.cu",
                    "zotpu/kernels/dedup_pallas.py:383"),
    "merge_runs_payload": ("zotpu_torch/csrc/merge_runs.cu",
                           "zotpu/kernels/sort_pallas.py:330"),
}
SHARDS = 4                     # D slots on one card
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published (the bound's rate)
COPY_RATE = {}                 # "bytes_per_s": measured in phase 2
SPIN_CYCLES = 3_500_000        # about 2 ms of the card's clock
SHARD_CF = 4.0                 # kmerize_paths_sharded's capacity factor
SETOP_BENCH_N = 1 << 24        # keys a side (harness.py bench_setops)
SPILL_SAMPLES = 4              # samples of the spill/resume phase
SET_OPS = ("union", "intersect", "diff")
# the kernels the self-test's two runs must launch between them (K1b is
# not on its path: max_len 128 takes the wire pack)
SELFTEST_KERNELS = tuple(n for n in KERNEL_INFO if n != "pack_canonical")
# --metrics line keys (zotpu/metrics.py: MetricsLogger.log and
# kmerize_stage_metrics without --shards)
METRICS_KEYS = {"ts", "host", "event", "bases_per_s", "kmers_per_s_per_chip",
                "dedup_ratio", "reads", "bases", "kmers", "unique",
                "n_chips"}
# device functions of the kmerize path in csrc/: K1a, K2, K3
TRACE_KERNELS = ("pack_wire_kernel", "dedup_kernel", "setop_kernel")
# phase 14: each bench workload, as (record name, impl), and the kernels it
# must launch at the CLI's defaults (scaling: its D = 1 row's)
BENCH_KERNELS = {
    ("kmerize", None): ("pack_canonical_wire", "dedup_compact"),
    ("setops_merge", "auto"): ("set_op_fused",),
    ("setops_merge", "sort"): ("dedup_compact",),
    ("scan", None): ("pack_canonical_wire", "join_row_hits"),
    ("scan_shard_model", None): ("pack_canonical_wire",
                                 "join_row_hits_tagged",
                                 "merge_runs_payload"),
    ("setops_shard_model", None): ("set_op_fused",),
    ("kmerize_scaling", None): ("pack_canonical", "dedup_compact"),
    ("kmerize_shard_model", None): ("pack_canonical_wire", "dedup_compact",
                                    "merge_runs", "merge_dedup",
                                    "set_op_fused"),
    ("kmerize_shard_sensitivity", None): ("pack_canonical_wire",
                                          "merge_dedup"),
    ("kmerize_sustained", None): ("pack_canonical_wire", "dedup_compact",
                                  "set_op_fused"),
    ("host_parse_gz", None): (),
    ("kmerize_e2e", None): ("pack_canonical_wire", "dedup_compact",
                            "set_op_fused"),
}
MICRO_ROWS = ("pack", "sort_i64", "sort+dedup", "scatter", "gather",
              "cumsum_i32")


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(torch, fn, reps=7, warm=2, queued=True) -> float:
    """Median milliseconds of fn() by CUDA events, after warm-up. With
    ``queued`` the stream is first kept busy for about 2 ms by a spin
    kernel, so that fn()'s launches are all enqueued before the card
    reaches the first event: the time is then the device's alone. Without
    it the time is the larger of the device's and the host's (allocation,
    checks and launch calls of the wrapper), which is what a short kernel
    called once from an idle stream costs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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


def dense_prefix(out):
    """(keys, counts, n) -> the part a dense run defines: [:n] and n. K2,
    K6 and K3 with valid counts leave the slots past n unwritten."""
    n = int(out[2])
    return out[0][:n], out[1][:n], out[2]


def compare(torch, name, got, want, defined=None) -> float:
    """Exact equality of every output of a kernel and its plain version (a
    None output, such as an absent payload, must be None on both sides);
    ``defined`` cuts both to the part the contract defines."""
    torch.cuda.synchronize()
    if defined is not None:
        got, want = defined(got), defined(want)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check([g is None for g in got] == [w is None for w in want],
          f"{name}: outputs present on one side only")
    err = max_abs_err(torch, [g for g in got if g is not None],
                      [w for w in want if w is not None])
    check(err == 0, f"{name} differs from its plain version")
    return err


def setop_bytes(op, n_a, n_b, n_out):
    """The bytes a set op must move on int64 keys and counts: merge and
    union need both sides' keys and counts; diff needs no count of B;
    intersect needs the keys, and the counts of the matched pairs only.
    The output is n_out keys and counts, and the three scalars 8 B each."""
    if op == "diff":
        nbytes = n_a * 16 + n_b * 8
    elif op == "intersect":
        nbytes = (n_a + n_b) * 8 + 2 * n_out * 8
    else:
        nbytes = (n_a + n_b) * 16
    return nbytes + n_out * 16 + 24


def measure(torch, name, kernel, plain, nbytes, defined=None, library=None):
    """A kernel against its plain version on the same inputs: exact
    equality (compare), then both times by CUDA events (the device's
    alone, see cuda_ms; the kernel's also from an idle stream, as earlier
    runs of this script measured it), its bound from
    ``nbytes`` (what the function must move: each input read once, each
    output written once) at the published memory rate and at this card's
    measured copy rate, and the time of ``library``, one PyTorch call that
    computes the same function, where there is one."""
    err = compare(torch, name, kernel(), plain(), defined)
    ms, plain_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain)
    eager_ms = cuda_ms(torch, kernel, queued=False)
    library_ms = None if library is None else cuda_ms(torch, library)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    copy_bound_ms = nbytes / COPY_RATE["bytes_per_s"] * 1e3
    check(bound_ms <= ms, f"{name}: the bound {bound_ms:.4f} ms exceeds the "
          f"kernel's {ms:.4f} ms, so the contract bytes are counted wrong")
    say(f"  {name}: max_abs_err={err} kernel {ms:.4f} ms ({eager_ms:.4f} "
        f"ms called from an idle stream), plain {plain_ms:.4f} ms, library "
        f"call "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'} "
        f"(CUDA events, median); {nbytes} contract bytes, bound "
        f"{bound_ms:.4f} ms at 3.35 TB/s ({bound_ms / ms:.3f} of the "
        f"kernel's time), {copy_bound_ms:.4f} ms at the measured copy rate "
        f"({copy_bound_ms / ms:.3f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def measure_copy_rate(torch, dev):
    """The card's device-to-device copy rate: bytes moved (read + written)
    per second by a 256 MiB tensor copy, the yardstick beside the published
    3.35 TB/s."""
    src = torch.empty(1 << 28, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms = cuda_ms(torch, lambda: dst.copy_(src))
    COPY_RATE["bytes_per_s"] = 2 * src.numel() / (ms * 1e-3)
    say(f"  device-to-device copy of {src.numel()} B: {ms:.4f} ms, "
        f"{COPY_RATE['bytes_per_s'] / 1e12:.4f} TB/s moved (read + write)")


def max_abs_err(torch, got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape,
              f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.equal(g, w):
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def make_reads(rng, genome, n):
    """n reads of READ_LEN codes (0-3, 4 = N) from the genome, with
    substitutions at SUB_RATE and N at N_RATE (the coverage fixture's
    recipe, zotpu/bench/harness.py _Fixture)."""
    offs = rng.integers(0, len(genome) - READ_LEN, n)
    codes = genome[offs[:, None] + np.arange(READ_LEN)[None, :]]
    n_sub = int(n * READ_LEN * SUB_RATE)
    codes[rng.integers(0, n, n_sub), rng.integers(0, READ_LEN, n_sub)] = (
        rng.integers(0, 4, n_sub).astype(np.uint8))
    n_n = int(n * READ_LEN * N_RATE)
    codes[rng.integers(0, n, n_n), rng.integers(0, READ_LEN, n_n)] = 4
    return codes


def write_fastq(f, codes, first_id):
    n, L = codes.shape
    rec = np.empty((n, 10 + 2 * L + 4), np.uint8)
    ids = np.arange(first_id, first_id + n)
    rec[:, 0] = ord("@")
    rec[:, 1] = ord("r")
    rec[:, 2:9] = (ids[:, None] // 10 ** np.arange(6, -1, -1)) % 10 + ord("0")
    rec[:, 9] = ord("\n")
    rec[:, 10:10 + L] = np.frombuffer(b"ACGTN", np.uint8)[codes]
    rec[:, 10 + L:13 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 13 + L:13 + 2 * L] = ord("I")
    rec[:, 13 + 2 * L] = ord("\n")
    f.write(rec.tobytes())


def batch_codes(rng, genome, rows):
    """A parsed-batch-shaped (rows, MAX_LEN) u8 array: reads + N padding."""
    codes = np.full((rows, MAX_LEN), 4, np.uint8)
    codes[:, :READ_LEN] = make_reads(rng, genome, rows)
    return codes, np.full(rows, READ_LEN, np.int32)


def run_cli(argv):
    """python -m zotpu_torch ... in-process; returns its stdout lines."""
    from zotpu_torch import cli
    argv = [str(a) for a in argv]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"zotpu_torch {' '.join(argv)} exited {rc}")
    return buf.getvalue().strip().splitlines()


def make_panel(genome, seed):
    """The scan panel: canonical K-mers of genome[:PANEL_BP] plus
    PANEL_RANDOM random keys below 4^K, sorted unique u64."""
    from zotpu_torch.reference_impl import golden as G
    gkeys, _ = G.kmerize(K, [genome[:PANEL_BP]])
    rng = np.random.default_rng([seed, 5])
    return np.unique(np.concatenate([
        gkeys, rng.integers(0, 1 << (2 * K), PANEL_RANDOM, dtype=np.uint64)]))


def device_timeline(torch, prof):
    """From a torch.profiler trace: the microseconds the device was busy
    (the union of its kernel and copy intervals) and the device rows with
    the most time, or (None, []) when the trace holds no device event."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return None, []
    busy, cur = 0.0, None
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in evs):
        if cur is None or lo > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [lo, hi]
        else:
            cur[1] = max(cur[1], hi)
    busy += cur[1] - cur[0]
    rows = {}
    for e in evs:
        rows[e.name] = rows.get(e.name, 0.0) + e.time_range.elapsed_us()
    return busy, sorted(rows.items(), key=lambda kv: -kv[1])[:5]


def profiled(torch, fn):
    """A warm rerun of fn under torch.profiler: prints and returns its wall
    seconds and the device's busy microseconds on the trace timeline
    (None when the trace holds no device event)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    busy_us, top = device_timeline(torch, prof)
    busy = ("not measured (no device event in the trace)" if busy_us is None
            else f"{busy_us / 1e3:.3f} ms, idle share "
                 f"{1 - busy_us / 1e6 / wall:.4f}")
    say(f"  profiled warm rerun: wall {wall:.3f} s, device busy {busy}; "
        f"top device rows (us): "
        f"{json.dumps([[n[:40], round(t, 1)] for n, t in top])}")
    return wall, busy_us


def kernel_fn(name: str) -> str:
    """A kernel event's demangled signature -> the function's own name,
    e.g. "void (anonymous namespace)::setop_kernel<2>(long long const*,
    ...)" -> "setop_kernel"."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name.split("(")[0].split("<")[0].split("::")[-1]


def selftest_summary(lines, name, want_checks):
    """The summary of a self-test run's JSON lines, checked: ok, nothing
    failed, not partial, and every check in ``want_checks`` ran."""
    rows = [json.loads(x) for x in lines]
    summary = rows[-1]
    ran = {r["check"] for r in rows if "ok" in r and "check" in r}
    check(summary.get("command") == "selftest" and summary["ok"] is True
          and summary["failed"] == 0 and "partial" not in summary,
          f"{name}: the self-test passed in full ({json.dumps(summary)})")
    check(ran == set(want_checks),
          f"{name}: ran {sorted(ran)}, expected {sorted(want_checks)}")
    return summary


def phase_selftest(torch, dev, seed):
    """Phase 1b: the self-test on the card's own slots through the CLI, and
    over 4 slots on this card; then kmerize --metrics --trace."""
    from zotpu_torch import kernels
    from zotpu_torch.selftest import run_selftest

    configs = ["config1_kmerize", "config2_merge", "config3_setops",
               "config4_hist", "config5_scan", "sharded_setop_psum",
               "sharded_setop_stream", "sharded_scan_stream_join",
               "merge_chunk_streamed", "spill_stamp_rejection"]
    fused = ["sharded_fused_dedup_gated", "sharded_fused_dedup_taken"]
    n_cards = torch.cuda.device_count()
    t_phase = time.perf_counter()
    say(f"phase 1b: self-test, k={K}: (a) the CLI on {n_cards} card slot(s), "
        f"(b) run_selftest over {SHARDS} slots on one card")
    kernels.reset_launches()
    t0 = time.perf_counter()
    lines = run_cli(["selftest", "-k", K])
    secs_a = time.perf_counter() - t0
    run_a = kernels.launches()
    sum_a = selftest_summary(lines, "(a)", configs + fused + (
        ["mixed_hash_sharded_step"] if n_cards > 1 else []))
    lines = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = run_selftest(k=K, verbose_print=lines.append,
                      devices=[dev] * SHARDS)
    secs_b = time.perf_counter() - t0
    run_b = kernels.launches()
    check(rc == 0, "(b): run_selftest returned 0")
    sum_b = selftest_summary(lines, "(b)",
                             configs + fused + ["mixed_hash_sharded_step"])
    for name in SELFTEST_KERNELS:
        check(run_a[name] + run_b[name] > 0,
              f"the self-test launched {name}")
    say("  self-test: " + json.dumps({
        part: {"device": s["device"], "checks": s["checks"],
               "seconds": round(secs, 3), "launches": run}
        for part, s, secs, run in (("a", sum_a, secs_a, run_a),
                                   ("b", sum_b, secs_b, run_b))}))
    phase_metrics_trace(seed)
    say(f"  phase 1b: {time.perf_counter() - t_phase:.3f} s in all")


def phase_metrics_trace(seed):
    """Phase 1b (c): kmerize --metrics --trace through the CLI on a small
    fixture (a 20 kbp genome, 4,000 reads: 4 batches, so K3 merges too)."""
    from zotpu_torch.io import container
    from zotpu_torch.reference_impl import golden as G

    rng = np.random.default_rng([seed, 7])
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    codes = make_reads(rng, genome, 4000)
    with tempfile.TemporaryDirectory() as tmp:
        fq, out = os.path.join(tmp, "r.fastq"), os.path.join(tmp, "o.zkf")
        mfile, tdir = os.path.join(tmp, "m.jsonl"), os.path.join(tmp, "tr")
        with open(fq, "wb") as f:
            write_fastq(f, codes, 0)
        t0 = time.perf_counter()
        lines = run_cli(["kmerize", "-k", K, "--batch-reads", 1024,
                         "--max-len", MAX_LEN, "--metrics", mfile,
                         "--trace", tdir, out, fq])
        wall = time.perf_counter() - t0
        stats = json.loads(lines[-1])
        with open(mfile) as f:
            rows = [json.loads(x) for x in f]
        check(len(rows) == 1 and set(rows[0]) == METRICS_KEYS,
              f"one --metrics line with the JAX package's keys: {rows}")
        m = rows[0]
        check(m["event"] == "kmerize" and m["host"] == 0
              and all(m[key] == stats[key] for key in
                      ("reads", "bases", "kmers", "unique", "n_chips")),
              "the --metrics counts equal the stats line's")
        text = np.frombuffer(b"ACGTN", np.uint8)[codes]
        ks = container.read(out)
        want = G.kmerize(K, [r.tobytes().decode() for r in text])
        check(np.array_equal(ks.keys, want[0])
              and np.array_equal(ks.counts, want[1]),
              "the traced run's container equals golden")
        path = os.path.join(tdir, "trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            trace = json.load(f)
        fns = [kernel_fn(e.get("name", "")) for e in trace["traceEvents"]
               if str(e.get("cat", "")).lower() == "kernel"]
        ours = {fn: fns.count(fn) for fn in TRACE_KERNELS}
        check(all(ours.values()),
              f"the trace holds CUDA kernel events of each of "
              f"{TRACE_KERNELS}: {sorted(set(fns))}")
    say(f"  kmerize --metrics --trace: {stats['reads']} reads, "
        f"{stats['unique']} unique, CLI wall {wall:.3f} s under the "
        f"profiler; metrics line {json.dumps(m)}; "
        f"trace.json {size} B, {len(trace['traceEvents'])} events, "
        f"{len(fns)} CUDA kernel events, of K1a, K2, K3: {json.dumps(ours)}")


def phase_kernels(torch, dev, rng, genome, panel):
    """Phase 2: kernel vs plain at the main path's shapes."""
    from zotpu_torch.io import wire
    from zotpu_torch.kernels import join as J
    from zotpu_torch.kernels import merge_fused as M
    from zotpu_torch.kernels import pack as P
    from zotpu_torch.kernels import sortdedup as D
    from zotpu_torch.keys import SENTINEL
    from zotpu_torch.workloads.accumulator import DeviceAccumulator
    from zotpu_torch.workloads.pulldown import panel_to_device

    rows = {}
    codes, lengths = batch_codes(rng, genome, BATCH_READS)
    packed, mask = wire.pack_codes(codes)
    c = torch.from_numpy(codes).to(dev)
    n = torch.from_numpy(lengths).to(dev)
    p = torch.from_numpy(packed.view(np.int32)).to(dev)
    m = torch.from_numpy(mask.view(np.int32)).to(dev)
    say(f"phase 2: batch {BATCH_READS} x {MAX_LEN}, k={K}, "
        f"{BATCH_READS * (MAX_LEN - K + 1)} windows")
    measure_copy_rate(torch, dev)
    phase_edge_cases(torch, dev)

    out_bytes = BATCH_READS * (MAX_LEN - K + 1) * 8
    rows["pack_canonical_wire"] = measure(
        torch, "pack_canonical_wire (K1a)",
        lambda: P.pack_canonical_wire(p, m, n, K),
        lambda: P.pack_canonical_wire_plain(p, m, n, K),
        packed.nbytes + mask.nbytes + lengths.nbytes + out_bytes)
    rows["pack_canonical"] = measure(
        torch, "pack_canonical (K1b)",
        lambda: P.pack_canonical(c, n, K),
        lambda: P.pack_canonical_plain(c, n, K),
        codes.nbytes + lengths.nbytes + out_bytes)

    keys = P.pack_canonical_wire(p, m, n, K)
    sorted_keys = torch.sort(keys).values
    sort_ms = cuda_ms(torch, lambda: torch.sort(keys))
    say(f"  torch.sort of {keys.shape[0]} int64 keys: {sort_ms:.4f} ms")
    n_unique = int(D.dedup_compact(sorted_keys)[2])
    # the library call also drops nothing: the sentinel run is one more
    # unique key, and it syncs with the host for its output size
    rows["dedup_compact"] = measure(
        torch, "dedup_compact (K2)",
        lambda: D.dedup_compact(sorted_keys),
        lambda: D.dedup_compact_plain(sorted_keys),
        sorted_keys.shape[0] * 8 + n_unique * 16 + 8, defined=dense_prefix,
        library=lambda: torch.unique_consecutive(sorted_keys,
                                                 return_counts=True))

    panel_t = panel_to_device(panel, device=dev)
    say(f"  scan panel: {len(panel)} keys ({panel.nbytes} B), padded to "
        f"{panel_t.shape[0]}")
    m_row = MAX_LEN - K + 1
    # the library call is the core of the join only: each window's
    # position in the panel, without the equality test and the row sums
    rows["join_row_hits"] = measure(
        torch, "join_row_hits (K4)",
        lambda: J.row_hits_sorted_join(panel_t, keys, BATCH_READS, m_row),
        lambda: J.row_hits_plain(panel_t, keys, BATCH_READS, m_row),
        keys.shape[0] * 8 + panel_t.shape[0] * 8 + BATCH_READS * 8,
        library=lambda: torch.searchsorted(panel_t, keys))
    hits = J.row_hits_sorted_join(panel_t, keys, BATCH_READS, m_row)
    say(f"  K4 batch: {int(hits.sum())} hits, {int((hits > 0).sum())} of "
        f"{BATCH_READS} rows hit")
    del panel_t, hits

    # two level-0 runs of the accumulator: dedup outputs of two batches
    runs = [D.kmer_sort_dedup(keys)]
    codes2, _ = batch_codes(rng, genome, BATCH_READS)
    runs.append(D.kmer_sort_dedup(P.pack_canonical(
        torch.from_numpy(codes2).to(dev), n, K)))
    (ka, ca, na), (kb, cb, nb) = runs
    say(f"  set_op_fused inputs: n_a={int(na)} n_b={int(nb)} of "
        f"{ka.shape[0]} each")
    for op in ("merge", "union", "intersect", "diff"):
        n_op = int(M.set_op_fused(ka, ca, kb, cb, op, n_a=na, n_b=nb)[2])
        r = measure(torch, f"set_op_fused op={op} (K3)",
                    lambda: M.set_op_fused(ka, ca, kb, cb, op, n_a=na, n_b=nb),
                    lambda: M.set_op_plain(ka, ca, kb, cb, op, n_a=na, n_b=nb),
                    setop_bytes(op, int(na), int(nb), n_op),
                    defined=dense_prefix)
        if op == "merge":
            rows["set_op_fused"] = r
    # without the valid counts the whole sentinel-tailed arrays merge and
    # the output's tail is written: every slot must equal the plain version
    # (K2 leaves its runs' tails unwritten, so the sentinel tails are made)
    sent_a, sent_b = (torch.where(torch.arange(k.shape[0], device=dev) < n_,
                                  k, SENTINEL)
                      for k, n_ in ((ka, na), (kb, nb)))
    compare(torch, "set_op_fused without valid counts",
            M.set_op_fused(sent_a, ca, sent_b, cb, "merge"),
            M.set_op_plain(sent_a, ca, sent_b, cb, "merge"))
    del sent_a, sent_b
    ko, co, no = M.set_op_fused(ka, ca, kb, cb, "merge", n_a=na, n_b=nb)
    nout = int(no)
    pin_k = torch.empty(nout, dtype=torch.int64, pin_memory=True)
    pageable_ms = cuda_ms(torch, lambda: ko[:nout].cpu())
    pinned_ms = cuda_ms(torch, lambda: pin_k.copy_(ko[:nout]))
    say(f"  D2H of {nout} merged int64 keys: pageable {pageable_ms:.4f} ms, "
        f"pinned {pinned_ms:.4f} ms")
    pinned = torch.from_numpy(packed.view(np.int32)).pin_memory()
    h2d_ms = cuda_ms(torch, lambda: p.copy_(pinned, non_blocking=True))
    say(f"  H2D of one batch's wire words ({packed.nbytes} B, pinned): "
        f"{h2d_ms:.4f} ms")
    del ko, co, pin_k, ka, ca, kb, cb

    # the accumulator's upper levels: two level-2 runs (4 batches each, 4x
    # the batch capacity) merging into level 3, as the 30x run does once
    sides = []
    for _ in range(2):
        acc = DeviceAccumulator(keys.shape[0], device=dev)
        for _ in range(4):
            bc, _ = batch_codes(rng, genome, BATCH_READS)
            acc.add(*D.kmer_sort_dedup(P.pack_canonical(
                torch.from_numpy(bc).to(dev), n, K)))
        check(acc.levels[:2] == [None, None] and len(acc.levels) == 3,
              "four batches end in one level-2 run")
        sides.append(acc.levels[2])
    (ka, ca, na), (kb, cb, nb) = sides
    n_l3 = int(M.set_op_fused(ka, ca, kb, cb, "merge", n_a=na, n_b=nb)[2])
    say(f"  level-3 merge inputs: n_a={int(na)} n_b={int(nb)} of "
        f"{ka.shape[0]} each, n_out={n_l3}")
    measure(torch, "set_op_fused op=merge at the level-3 shape (K3)",
            lambda: M.set_op_fused(ka, ca, kb, cb, "merge", n_a=na, n_b=nb),
            lambda: M.set_op_plain(ka, ca, kb, cb, "merge", n_a=na, n_b=nb),
            (int(na) + int(nb) + n_l3) * 16 + 24, defined=dense_prefix)
    return rows


def phase_edge_cases(torch, dev):
    """The shapes the set-op, pack and receive-tree kernels can get wrong
    (zotpu_torch/kernels/edge_cases.py), kernel against plain version,
    exact: K3 on every op with and without the valid counts, K1 on both
    input forms, K5 and K7 on every pass and pair (the payload of sentinel
    rows included), K6 over its dense prefix."""
    from zotpu_torch.io import wire
    from zotpu_torch.kernels import edge_cases as EC
    from zotpu_torch.kernels import merge_dedup as MD
    from zotpu_torch.kernels import merge_fused as M
    from zotpu_torch.kernels import merge_runs as MR
    from zotpu_torch.kernels import pack as P

    cases = EC.set_op_cases()
    for name, a, b in cases:
        ka, ca = (torch.from_numpy(x).to(dev) for x in a[:2])
        kb, cb = (torch.from_numpy(x).to(dev) for x in b[:2])
        na, nb = (torch.tensor(x[2], device=dev) for x in (a, b))
        for op in ("merge", "intersect", "diff"):
            compare(torch, f"K3 {name} {op} with valid counts",
                    M.set_op_fused(ka, ca, kb, cb, op, n_a=na, n_b=nb),
                    M.set_op_plain(ka, ca, kb, cb, op, n_a=na, n_b=nb),
                    dense_prefix)
            compare(torch, f"K3 {name} {op} without valid counts",
                    M.set_op_fused(ka, ca, kb, cb, op),
                    M.set_op_plain(ka, ca, kb, cb, op))
    packs = EC.pack_cases()
    for name, codes, lengths, k in packs:
        packed, mask = wire.pack_codes(codes)
        c = torch.from_numpy(codes).to(dev)
        n = torch.from_numpy(lengths).to(dev)
        want = P.pack_canonical_plain(c, n, k)
        compare(torch, f"K1b {name}", P.pack_canonical(c, n, k), want)
        compare(torch, f"K1a {name}", P.pack_canonical_wire(
            torch.from_numpy(packed.view(np.int32)).to(dev),
            torch.from_numpy(mask.view(np.int32)).to(dev), n, k), want)
    merges = EC.merge_runs_cases()
    for name, keys, tags, kind, arg in merges:
        k, t = torch.from_numpy(keys).to(dev), torch.from_numpy(tags).to(dev)
        fn = MR.merge_runs_pass if kind == "pass" else MR.merge_runs_pair
        pair_len, a_len = ((2 * arg, arg) if kind == "pass"
                           else (max(len(keys), 1), arg))
        compare(torch, f"K5 {name}", fn(k, None, arg),
                MR.merge_plain(k, None, pair_len, a_len))
        compare(torch, f"K7 {name}", fn(k, t, arg),
                MR.merge_plain(k, t, pair_len, a_len))
    dedups = EC.merge_dedup_cases()
    for name, keys, n_a in dedups:
        k = torch.from_numpy(keys).to(dev)
        compare(torch, f"K6 {name}", MD.merge_dedup_pair(k, n_a),
                MD.merge_dedup_plain(k, n_a), dense_prefix)
    say(f"  edge shapes: K3 {len(cases)} cases x 3 ops x (with, without "
        f"valid counts), K1 {len(packs)} cases x (wire, u8), K5 and K7 "
        f"{len(merges)} cases each, K6 {len(dedups)} cases: all exact")


def phase_shard_kernels(torch, dev, rng, genome, panel):
    """Phase 2b: K5, K6, K7 and K4's tagged entry against their plain
    versions at one full batch's shapes: the batch of phase 2 split over
    SHARDS slots on this card, sorted and routed by the sharded step's own
    _route (prefix owner, SHARD_CF), then slot 0's received runs."""
    from zotpu_torch.io import wire
    from zotpu_torch.dist import shuffle as SH
    from zotpu_torch.dist.mesh import make_mesh
    from zotpu_torch.kernels import join as J
    from zotpu_torch.kernels import merge_dedup as MD
    from zotpu_torch.kernels import merge_runs as MR
    from zotpu_torch.kernels import pack as P
    from zotpu_torch.keys import SENTINEL

    rows = {}
    mesh = make_mesh(devices=[dev] * SHARDS)
    codes, lengths = batch_codes(rng, genome, BATCH_READS)
    packed, mask = wire.pack_codes(codes)
    keys = P.pack_canonical_wire(
        torch.from_numpy(packed.view(np.int32)).to(dev),
        torch.from_numpy(mask.view(np.int32)).to(dev),
        torch.from_numpy(lengths).to(dev), K)
    m_row = MAX_LEN - K + 1
    m_local = BATCH_READS // SHARDS * m_row
    cap = int(np.ceil(m_local * SHARD_CF / SHARDS))
    cap2 = (cap + 3) // 4
    rid = torch.arange(BATCH_READS, device=dev).repeat_interleave(m_row)
    sk, sr = [], []
    for d in range(SHARDS):
        k_d, order = torch.sort(keys[d * m_local:(d + 1) * m_local])
        sk.append(k_d)
        sr.append(rid[d * m_local:(d + 1) * m_local][order])
    routed = SH._route(mesh, sk, K, cap, payload=sr, capacity2=cap2)
    check(not routed.need2 and all(int(o) == 0 for o in routed.overflow),
          "the full batch routes in the first round")
    rk, rt = routed.keys[0], routed.pay[0]
    n_valid = int((rk != SENTINEL).sum())
    say(f"phase 2b: {SHARDS} slots on one card, batch {BATCH_READS} x "
        f"{MAX_LEN}, k={K}: {m_local} keys a slot, cap {cap}, slot 0 "
        f"receives {rk.shape[0]} slots ({n_valid} valid) in {SHARDS} runs")

    # no library call merges sorted runs: torch.sort of the concatenation
    # is the plain version of K5, K6 and K7 (and of K3), not a merge
    rows["merge_runs"] = measure(
        torch, f"merge_runs_pass run={cap} (K5)",
        lambda: MR.merge_runs_pass(rk, None, cap),
        lambda: MR.merge_plain(rk, None, 2 * cap, cap),
        rk.shape[0] * 16)
    half, _ = MR.merge_runs_pass(rk, None, cap)
    n_k6 = int(MD.merge_dedup_pass(half, 2 * cap)[2])
    # what K6 must move: the valid keys in, the dense result out (as K3's
    # row counts valid elements only); the sentinel capacity is no input
    # of the function
    say(f"  K6: {n_valid} valid keys of {half.shape[0]} slots, {n_k6} "
        f"unique; counting the whole capacity as input, as earlier runs of "
        f"this script did, gives {half.shape[0] * 8 + n_k6 * 16 + 8} bytes")
    rows["merge_dedup"] = measure(
        torch, f"merge_dedup_pass run={2 * cap} (K6)",
        lambda: MD.merge_dedup_pass(half, 2 * cap),
        lambda: MD.merge_dedup_plain(half, 2 * cap),
        n_valid * 8 + n_k6 * 16 + 8, defined=dense_prefix)
    rows["merge_runs_payload"] = measure(
        torch, f"merge_runs_pass run={cap} with row ids (K7)",
        lambda: MR.merge_runs_pass(rk, rt, cap),
        lambda: MR.merge_plain(rk, rt, 2 * cap, cap),
        rk.shape[0] * 32)
    qk, qt = SH.merge_received_runs_tag(rk, rt, SHARDS, cap, 0)
    prow, pcap = SH.partition_panel(panel, K, SHARDS)
    p0 = torch.from_numpy(prow[0]).to(dev)
    rows["join_row_hits_tagged"] = measure(
        torch, f"row_hits_tagged, {qk.shape[0]} probes vs a {pcap}-key "
        f"panel row (K4 tagged)",
        lambda: J.row_hits_tagged(p0, qk, qt, BATCH_READS),
        lambda: J.row_hits_tagged_plain(p0, qk, qt, BATCH_READS),
        qk.shape[0] * 16 + p0.shape[0] * 8 + BATCH_READS * 8,
        library=lambda: torch.searchsorted(p0, qk))

    # the host read of the second-round flag: route with and without it
    def route(c2):
        return lambda: SH._route(mesh, sk, K, cap, capacity2=c2)

    def host_ms(fn, reps=7):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    with_flag, without = host_ms(route(cap2)), host_ms(route(0))
    say(f"  _route of the batch over {SHARDS} slots (host clock, median): "
        f"{with_flag:.4f} ms with the second-round flag read, "
        f"{without:.4f} ms without")
    return rows


def phase_sharded_kmerize(torch, fx, tmp):
    """Phase 7: kmerize_paths_sharded with SHARDS slots on this card, once
    per owner function, against the single-device container of phase 3;
    then a forced second round on one slot with a capacity factor below
    1. Returns K5's and K6's launches in the prefix run."""
    from zotpu_torch import semantics as S
    from zotpu_torch.io import container
    from zotpu_torch import kernels
    from zotpu_torch.dist import shuffle as SH
    from zotpu_torch.workloads import kmerize as W

    want = container.read(os.path.join(tmp, "ecoli30x.zkf"))
    slots = [torch.device("cuda")] * SHARDS
    say(f"phase 7: sharded kmerize, {SHARDS} slots on one card, "
        f"--batch-reads {BATCH_READS} --max-len {MAX_LEN}")
    counts = {}
    for shard_hash in ("prefix", "mixed"):
        stats = W.Stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        keys, cnts = W.kmerize_paths_sharded(
            [fx["fq"]], K, SHARDS, batch_reads=BATCH_READS, max_len=MAX_LEN,
            stats=stats, capacity_factor=SHARD_CF, shard_hash=shard_hash,
            devices=slots)
        wall = time.perf_counter() - t0
        run = kernels.launches()
        check(np.array_equal(keys, want.keys)
              and np.array_equal(cnts, want.counts),
              f"sharded kmerize ({shard_hash}) equals the single-device "
              f"container")
        say(f"  {shard_hash}: wall {wall:.3f} s, "
            f"{stats.bases / wall:.6e} bases/s, {stats.batches} batches, "
            f"unique {stats.unique}, routed_per_shard "
            f"{stats.routed_per_shard}, second rounds {stats.second_rounds}"
            f"; equal to the single-device port; launches "
            f"{json.dumps(run)}")
        for name in ("merge_runs", "merge_dedup", "set_op_fused",
                     "pack_canonical_wire"):
            check(run[name] > 0, f"{name} launched in the sharded run")
        if shard_hash == "prefix":
            counts = {"merge_runs": run["merge_runs"],
                      "merge_dedup": run["merge_dedup"]}
        profiled(torch, lambda: W.kmerize_paths_sharded(
            [fx["fq"]], K, SHARDS, batch_reads=BATCH_READS, max_len=MAX_LEN,
            capacity_factor=SHARD_CF, shard_hash=shard_hash, devices=slots))
    # the mixed run's host tail: its slots' key ranges interleave, so
    # gather_global re-sorts the whole set on the host
    owner = np.minimum(S.routing_mix32(*S.split_hi_lo(want.keys))
                       >> np.uint32(33 - SHARDS.bit_length()), SHARDS - 1)
    parts = [np.flatnonzero(owner == d) for d in range(SHARDS)]
    t0 = time.perf_counter()
    keys, cnts = SH.gather_global(
        [want.keys[i].astype(np.int64) for i in parts],
        [want.counts[i].astype(np.int64) for i in parts],
        [len(i) for i in parts], reorder=True)
    say(f"  mixed host reorder (gather_global, {len(keys)} keys): "
        f"{time.perf_counter() - t0:.3f} s")
    check(np.array_equal(keys, want.keys), "reorder restores the set")
    stats = W.Stats()
    kernels.reset_launches()
    keys, cnts = W.kmerize_paths_sharded(
        [fx["fq"]], K, 1, batch_reads=BATCH_READS, max_len=MAX_LEN,
        stats=stats, capacity_factor=0.9, force_second_round=True,
        devices=slots[:1])
    run = kernels.launches()
    check(np.array_equal(keys, want.keys)
          and np.array_equal(cnts, want.counts),
          "the forced second round equals the single-device container")
    check(stats.second_rounds > 0 and run["merge_dedup"] > 0,
          "the second-round subtree ran")
    say(f"  forced second round (1 slot, capacity factor 0.9): "
        f"{stats.second_rounds} of {stats.batches} batches took it; "
        f"equal; launches {json.dumps(run)}")
    return counts


def phase_sharded_scan(torch, fx, panel):
    """Phase 8: pulldown_paths_sharded with SHARDS slots on this card
    against the single-device pulldown_paths, per sample and per read.
    Returns K7's and K4 tagged's launches, the numbers, and the
    single-device results."""
    from zotpu_torch import kernels
    from zotpu_torch.workloads import pulldown as P

    samples = fx["samples"]
    want = P.pulldown_paths(panel, samples, K, batch_reads=BATCH_READS,
                            max_len=MAX_LEN, device="cuda")
    say(f"phase 8: sharded scan, {SHARDS} slots on one card, "
        f"{N_SAMPLES} samples")
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = P.pulldown_paths_sharded(
        panel, samples, K, SHARDS, batch_reads=BATCH_READS, max_len=MAX_LEN,
        capacity_factor=SHARD_CF, devices=[torch.device("cuda")] * SHARDS)
    wall = time.perf_counter() - t0
    run = kernels.launches()
    check(got == want, "sharded scan equals the single-device scan")
    check(run["merge_runs_payload"] > 0 and run["join_row_hits_tagged"] > 0,
          "the sharded scan ran K7 and K4 tagged")
    bases = fx["bases"]
    say(f"  wall {wall:.3f} s, {bases / wall:.6e} bases/s, "
        f"{sum(g[0] for g in got)} hits: every sample's lines and per-read "
        f"hits equal the single-device scan; launches {json.dumps(run)}")
    pwall, busy_us = profiled(torch, lambda: P.pulldown_paths_sharded(
        panel, samples, K, SHARDS, batch_reads=BATCH_READS, max_len=MAX_LEN,
        capacity_factor=SHARD_CF, devices=[torch.device("cuda")] * SHARDS))
    return ({"merge_runs_payload": run["merge_runs_payload"],
             "join_row_hits_tagged": run["join_row_hits_tagged"]},
            {"wall_s": wall, "bases_per_s": bases / wall,
             "profiled_wall_s": pwall,
             "device_busy_ms": None if busy_us is None else busy_us / 1e3},
            want)


def same_files(dir_a, dir_b):
    """The sorted .zkf names of dir_a, after checking that dir_b holds the
    same names with the same bytes."""
    names = sorted(n for n in os.listdir(dir_a) if n.endswith(".zkf"))
    check(names == sorted(n for n in os.listdir(dir_b) if n.endswith(".zkf")),
          f"{dir_a} and {dir_b} hold the same run files")
    for n in names:
        with open(os.path.join(dir_a, n), "rb") as f, \
                open(os.path.join(dir_b, n), "rb") as g:
            check(f.read() == g.read(), f"run file {n} is the same in both")
    return names


def verify_equal(a, b, what):
    got = json.loads(run_cli(["verify", a, b])[-1])
    check(got.get("equal") is True, f"{what}: verify says {got}")
    return got["n"]


def phase_merge(torch, fx, tmp):
    """Phase 9 (BASELINE config 2): kmerize every sample, merge the 16
    containers through the CLI, verify against the whole run's container.
    Returns the samples' containers and the merge's numbers."""
    from zotpu_torch import kernels
    from zotpu_torch.io import container

    t0 = time.perf_counter()
    sets = []
    for i, sample in enumerate(fx["samples"]):
        sets.append(os.path.join(tmp, f"s{i}.zkf"))
        run_cli(["kmerize", "-k", K, "--batch-reads", BATCH_READS,
                 "--max-len", MAX_LEN, sets[-1], sample])
    keys_in = sum(container.read_header(p)["n"] for p in sets)
    say(f"phase 9: merge of {N_SAMPLES} sample sets ({keys_in} keys in all; "
        f"kmerized in {time.perf_counter() - t0:.1f} s)")
    merged = os.path.join(tmp, "merged.zkf")
    kernels.reset_launches()
    t0 = time.perf_counter()
    line = json.loads(run_cli(["merge", merged, *sets])[-1])
    wall = time.perf_counter() - t0
    run = kernels.launches()
    n = verify_equal(merged, os.path.join(tmp, "ecoli30x.zkf"),
                     "the merge of the samples equals the whole run")
    check(line == {"command": "merge", "inputs": N_SAMPLES, "unique": n},
          f"the merge line {line}")
    check(run["set_op_fused"] > 0, "K3 launched on the merge path")
    say(f"  merge (CLI, cuda): wall {wall:.3f} s, {keys_in / wall:.6e} keys/s "
        f"in, {n} unique out; verify: equal to phase 3's container; "
        f"launches {json.dumps(run)}; {card_line()}")
    pwall, busy_us = profiled(torch, lambda: run_cli(["merge", merged,
                                                      *sets]))
    # the host side alone: reading every input in the merge's chunks, and
    # writing the result's container
    t0 = time.perf_counter()
    for path in sets:
        for _ in container.ChunkReader(path).chunks(1 << 22):
            pass
    read_s = time.perf_counter() - t0
    result = container.read(merged)
    t0 = time.perf_counter()
    container.write(merged, result)
    write_s = time.perf_counter() - t0
    say(f"  host side alone: reading the {N_SAMPLES} inputs in chunks "
        f"{read_s:.3f} s, writing the result ({n} keys) {write_s:.3f} s")
    return sets, {"wall_s": wall, "keys_in": keys_in,
                  "keys_per_s": keys_in / wall, "unique": n,
                  "set_op_fused": run["set_op_fused"],
                  "host_read_s": read_s, "host_write_s": write_s,
                  "profiled_wall_s": pwall,
                  "device_busy_ms": None if busy_us is None else busy_us / 1e3}


def phase_setops(torch, dev, sets, tmp):
    """Phase 10 (config 3): union, intersect, diff and jaccard of two
    sample-sized sets through the CLI against an oracle on the card, then
    the sharded and the streamed forms over SHARDS slots against the
    single-device results. Returns K3's launches per op and the numbers."""
    from zotpu_torch import kernels
    from zotpu_torch.io import container
    from zotpu_torch.keys import COUNT_MAX
    from zotpu_torch.workloads import setops as WS

    pa, pb = os.path.join(tmp, "A.zkf"), os.path.join(tmp, "B.zkf")
    half = N_SAMPLES // 2
    kernels.reset_launches()
    run_cli(["merge", pa, *sets[:half]])
    run_cli(["merge", pb, *sets[half:]])
    launches = {"merge": kernels.launches()["set_op_fused"]}
    t0 = time.perf_counter()
    A, B = container.read(pa), container.read(pb)
    read_s = time.perf_counter() - t0
    say(f"phase 10: set ops on A = samples 0-{half - 1} ({A.n} keys) and "
        f"B = samples {half}-{N_SAMPLES - 1} ({B.n} keys), k={K}; reading "
        f"both containers takes {read_s:.3f} s")

    # the oracle, on the card, with no kernel of the port
    t0 = time.perf_counter()
    ka, kb = (torch.from_numpy(x.keys.astype(np.int64)).to(dev)
              for x in (A, B))
    ca, cb = (torch.from_numpy(x.counts.astype(np.int64)).to(dev)
              for x in (A, B))
    uk, inv = torch.unique(torch.cat([ka, kb]), return_inverse=True)
    uc = torch.zeros_like(uk).index_add_(0, inv, torch.cat([ca, cb]))
    uc = uc.clamp(max=COUNT_MAX)
    both = torch.isin(uk, ka) & torch.isin(uk, kb)
    only_a = ~torch.isin(ka, kb)
    oracle = {op: (k.cpu().numpy().astype(np.uint64),
                   c.cpu().numpy().astype(np.uint32))
              for op, (k, c) in (("union", (uk, uc)),
                                 ("intersect", (uk[both], uc[both])),
                                 ("diff", (ka[only_a], ca[only_a])))}
    n_int, n_uni = int(both.sum()), uk.shape[0]
    del ka, kb, ca, cb, uk, inv, uc, both, only_a
    say(f"  oracle (torch.unique + index_add_, torch.isin): union "
        f"{n_uni}, intersect {n_int}, diff {len(oracle['diff'][0])} "
        f"({time.perf_counter() - t0:.1f} s)")
    want_cards = {"a": A.n, "b": B.n, "intersect": n_int, "union": n_uni,
                  "jaccard": n_int / n_uni}

    def same(got, want, what):
        check(np.array_equal(got[0], want[0])
              and np.array_equal(got[1], want[1]), what)

    slots = [dev] * SHARDS
    a, b = (A.keys, A.counts), (B.keys, B.counts)
    cache, walls = {}, {}
    for op in SET_OPS:
        out = os.path.join(tmp, f"{op}.zkf")
        kernels.reset_launches()
        t0 = time.perf_counter()
        line = json.loads(run_cli([op, out, pa, pb])[-1])
        walls[op] = time.perf_counter() - t0
        n_one = kernels.launches()["set_op_fused"]
        got = container.read(out)
        os.remove(out)
        single = (got.keys, got.counts)
        same(single, oracle[op], f"{op} (CLI) equals the oracle")
        check(line == {"command": op, "unique": len(single[0])}
              and n_one == 1, f"{op}: one K3 launch, line {line}")
        t0 = time.perf_counter()
        keys, counts, cards = WS.set_op_sharded(a, b, op, K, SHARDS,
                                                devices=slots, cache=cache)
        w_sh = time.perf_counter() - t0
        n_sh = kernels.launches()["set_op_fused"] - n_one
        same((keys, counts), single, f"{op} over {SHARDS} slots equals the "
             f"single-device result")
        check(cards == want_cards, f"{op}: sharded cardinalities {cards}")
        t0 = time.perf_counter()
        k, keys, counts, cards = WS.set_op_sharded_stream(
            pa, pb, op, SHARDS, devices=slots)
        w_st = time.perf_counter() - t0
        same((keys, counts), single, f"{op} streamed equals the "
             f"single-device result")
        check(k == K and cards == want_cards,
              f"{op}: streamed cardinalities {cards}")
        # and the CLI's --stream on this card's one slot
        line = json.loads(run_cli([op, "--stream", out, pa, pb])[-1])
        got = container.read(out)
        os.remove(out)
        same((got.keys, got.counts), single, f"{op} --stream (CLI) equals "
             f"the single-device result")
        check(line == {"command": op, "unique": len(single[0]),
                       "cards": want_cards}, f"{op} --stream line {line}")
        launches[op] = kernels.launches()["set_op_fused"]
        check(n_sh == SHARDS and launches[op] == 2 + 2 * SHARDS,
              f"{op}: a K3 launch a slot ({launches[op]} in all)")
        keys_in = A.n + B.n
        say(f"  {op}: CLI wall {walls[op]:.3f} s ({keys_in / walls[op]:.6e} "
            f"keys/s in, {len(single[0])} out), {SHARDS} slots "
            f"{w_sh:.3f} s, streamed {w_st:.3f} s: equal to the oracle and "
            f"to each other; K3 launches {launches[op]}")
        del got, single, keys, counts
    check(len(cache) == 2, "the partition cache holds each set once")

    kernels.reset_launches()
    line = json.loads(run_cli(["jaccard", pa, pb])[-1])
    check(line == {"command": "jaccard", **want_cards},
          f"jaccard (CLI) {line} equals the oracle's {want_cards}")
    # the matrix form: A, B and phase 9's merge of all samples, which is
    # their union, so every pair's cardinalities are known from the oracle
    pm = os.path.join(tmp, "merged.zkf")
    lines = [json.loads(x) for x in run_cli(["jaccard", pa, pb, pm])]
    want = [{"command": "jaccard", "a": p, "b": q, "intersect": ni,
             "union": n_uni, "jaccard": ni / n_uni}
            for p, q, ni in ((pa, pb, n_int), (pa, pm, A.n), (pb, pm, B.n))]
    check(lines == want, f"jaccard matrix (CLI, 3 inputs) {lines}")
    t0 = time.perf_counter()
    cards = WS.jaccard_sharded(A.keys, B.keys, K, SHARDS, devices=slots)
    w_j = time.perf_counter() - t0
    launches["jaccard"] = kernels.launches()["set_op_fused"]
    check(cards == want_cards and launches["jaccard"] == 1 + 3 + SHARDS,
          f"jaccard over {SHARDS} slots {cards}, a K3 launch a pair and a "
          f"slot ({launches['jaccard']} in all)")
    say(f"  jaccard {want_cards['jaccard']:.6f}: CLI (a pair, and the "
        f"matrix of 3 inputs) and {SHARDS} slots "
        f"({w_j * 1e3:.1f} ms, only the counts leave the card) equal the "
        f"oracle; K3 launches {launches['jaccard']}")
    # union.zkf stays: phase 13's streamed multi-controller union is held
    # against it
    pwall, busy_us = profiled(torch, lambda: run_cli(
        ["union", os.path.join(tmp, "union.zkf"), pa, pb]))
    return launches, {"a": A.n, "b": B.n, "wall_s": walls,
                      "host_read_s": read_s,
                      "union_profiled_wall_s": pwall,
                      "union_device_busy_ms": (None if busy_us is None
                                               else busy_us / 1e3)}


def phase_setop_bench(torch, dev, seed):
    """Phase 10's kernel rows: K3 against its plain version at the JAX
    package's set-op bench size, SETOP_BENCH_N random keys below 2^50 a
    side with counts of one (zotpu/bench/harness.py bench_setops; two such
    sets share next to no key), for each op. Returns a row per op."""
    from zotpu_torch.kernels import merge_fused as M

    gen = torch.Generator(device=dev).manual_seed(seed)
    sides = []
    for _ in range(2):
        k = torch.unique(torch.randint(0, 1 << 50, (SETOP_BENCH_N,),
                                       generator=gen, device=dev,
                                       dtype=torch.int64))
        sides.append((k, torch.ones_like(k),
                      torch.tensor(k.shape[0], device=dev)))
    (ka, ca, na), (kb, cb, nb) = sides
    n_in = int(na) + int(nb)
    say(f"  K3 at the set-op bench size: {int(na)} + {int(nb)} keys")
    rows = {}
    for op in ("merge", *SET_OPS):
        n_op = int(M.set_op_fused(ka, ca, kb, cb, op, n_a=na, n_b=nb)[2])
        nbytes = setop_bytes(op, int(na), int(nb), n_op)
        r = measure(torch, f"set_op_fused op={op}, 2^24 keys a side (K3)",
                    lambda: M.set_op_fused(ka, ca, kb, cb, op, n_a=na, n_b=nb),
                    lambda: M.set_op_plain(ka, ca, kb, cb, op, n_a=na, n_b=nb),
                    nbytes, defined=dense_prefix)
        # BASELINE's second metric: by the contract bytes (what this op
        # must read and write), and by the JAX bench's formula (the two
        # inputs at 12 B a key, harness.py:189)
        say(f"    set-op {op}: {nbytes / r['ms'] / 1e6:.1f} GB/s by the "
            f"contract bytes, {n_in * 12 / r['ms'] / 1e6:.1f} GB/s by the "
            f"bench formula (inputs at 12 B a key), "
            f"{n_in / r['ms'] / 1e6:.3f} Gkeys/s, n_out {n_op}")
        rows[op] = {**r, "contract_bytes": nbytes, "n_in": n_in,
                    "n_out": n_op,
                    "contract_gb_per_s": nbytes / r["ms"] / 1e6}
    return rows


def phase_spill(torch, dev, fx, tmp):
    """Phase 11: kmerize --spill-dir of SPILL_SAMPLES samples, whole, then
    crashed after two batches and resumed; then a sharded spill run.
    Returns the launches of the uninterrupted spill run."""
    from zotpu_torch import kernels
    from zotpu_torch.io import container
    from zotpu_torch.workloads import kmerize as W

    inputs = fx["samples"][:SPILL_SAMPLES]
    flags = ["-k", K, "--batch-reads", BATCH_READS, "--max-len", MAX_LEN]
    dirs = [os.path.join(tmp, f"spill{i}") for i in range(3)]
    for d in dirs:
        os.mkdir(d)
    acc, clean, resumed = (os.path.join(tmp, f"spill_{n}.zkf")
                           for n in ("acc", "clean", "resumed"))
    run_cli(["kmerize", *flags, acc, *inputs])
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = json.loads(run_cli(["kmerize", *flags, "--spill-dir", dirs[0],
                                clean, *inputs])[-1])
    wall = time.perf_counter() - t0
    run = kernels.launches()
    b = stats["batches"]
    say(f"phase 11: kmerize --spill-dir of {SPILL_SAMPLES} samples: "
        f"{json.dumps(stats)}")
    names = sorted(os.listdir(dirs[0]))
    run_keys = sum(container.read_header(os.path.join(dirs[0], f))["n"]
                   for f in names)
    check(b >= 3 and len(names) == b, "several batches, a run file each")
    check(run["pack_canonical_wire"] == b and run["dedup_compact"] == b,
          "K1a and K2 ran once per batch in spill mode")
    check(run_keys >= W.DEVICE_MERGE_THRESHOLD
          and run["set_op_fused"] == b - 1,
          "the final merge is the K3 merge tree (runs - 1 launches)")
    try:
        W.kmerize_paths(inputs, K, batch_reads=BATCH_READS, max_len=MAX_LEN,
                        spill_dir=dirs[1], fail_after_batches=2, device=dev)
    except W.Interrupted as e:
        say(f"  interrupted: {e}")
    else:
        check(False, "fail_after_batches interrupts the run")
    check(sorted(os.listdir(dirs[1])) == ["run000001.zkf", "run000002.zkf"],
          "exactly two run files exist after the crash")
    kernels.reset_launches()
    rstats = json.loads(run_cli(["kmerize", *flags, "--spill-dir", dirs[1],
                                 "--resume", resumed, *inputs])[-1])
    rerun = kernels.launches()
    check(rerun["pack_canonical_wire"] == b - 2,
          "the resumed run recomputed only the missing batches")
    check(rerun["set_op_fused"] == b - 1, "the resumed run merged on K3")
    check(rstats == stats, f"the resumed run's stats {rstats}")
    check(same_files(dirs[0], dirs[1]) == names, "the same run files")
    n = verify_equal(resumed, clean, "resumed equals uninterrupted")
    verify_equal(resumed, acc, "spill mode equals the accumulator path")
    say(f"  wall {wall:.3f} s, {b} run files holding {run_keys} keys, "
        f"{n} unique; crash after 2 batches, --resume: the same run files, "
        f"and the result equals the uninterrupted spill run and the "
        f"accumulator path; launches {json.dumps(run)}, resumed "
        f"{json.dumps(rerun)}")
    want = container.read(acc)
    kernels.reset_launches()
    sstats = W.Stats()
    t0 = time.perf_counter()
    keys, cnts = W.kmerize_paths_sharded(
        inputs, K, SHARDS, batch_reads=BATCH_READS, max_len=MAX_LEN,
        stats=sstats, capacity_factor=SHARD_CF, spill_dir=dirs[2],
        devices=[dev] * SHARDS)
    swall = time.perf_counter() - t0
    srun = kernels.launches()
    check(np.array_equal(keys, want.keys)
          and np.array_equal(cnts, want.counts),
          "the sharded spill run equals the accumulator path")
    check(srun["merge_runs"] > 0 and srun["merge_dedup"] > 0
          and srun["set_op_fused"] == sstats.batches - 1,
          "the sharded spill run ran K5, K6 and the K3 merge tree")
    check(len(os.listdir(dirs[2])) == sstats.batches, "a run file a batch")
    say(f"  sharded spill run ({SHARDS} slots): wall {swall:.3f} s, "
        f"{sstats.batches} run files, routed_per_shard "
        f"{sstats.routed_per_shard}: equal; launches {json.dumps(srun)}")
    return run, {"wall_s": wall, "batches": b, "run_keys": run_keys,
                 "sharded_wall_s": swall}


def phase_spectrum(torch, tmp):
    """Phase 12 (config 4): hist --cutoff and filter --auto on the whole
    run's container, against golden.spectrum and the fixture's coverage
    and genome size."""
    from zotpu_torch.io import container
    from zotpu_torch.reference_impl import golden as G

    full = os.path.join(tmp, "ecoli30x.zkf")
    t0 = time.perf_counter()
    lines = run_cli(["hist", "--cutoff", full])
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = container.read(full).counts
    read_s = time.perf_counter() - t0
    want = G.spectrum(counts)
    check(lines[:-1] == [f"{f}\t{int(want[f])}" for f in range(1, len(want))
                         if want[f]], "the histogram equals golden.spectrum")
    fit = json.loads(lines[-1])
    peak_want = COVERAGE * (READ_LEN - K + 1) / READ_LEN
    say(f"phase 12: hist --cutoff of {len(counts)} counts: wall {wall:.3f} "
        f"s ({read_s:.3f} s of it reading the container, measured apart), "
        f"equal to golden.spectrum; {json.dumps(fit)}")
    say(f"  coverage peak {fit['coverage_peak']:.3f} (expected near "
        f"{peak_want:.1f}), genome-size estimate "
        f"{fit['genome_size_estimate']} (the genome has {GENOME_BP} bp)")
    check(abs(fit["coverage_peak"] / peak_want - 1) <= 0.15,
          "the coverage peak is within 15% of 30 x 126 / 150")
    check(abs(fit["genome_size_estimate"] / GENOME_BP - 1) <= 0.15,
          "the genome-size estimate is within 15% of the genome's length")
    solid = os.path.join(tmp, "solid.zkf")
    t0 = time.perf_counter()
    line = json.loads(run_cli(["filter", "--auto", solid, full])[-1])
    fwall = time.perf_counter() - t0
    kept = int((counts >= line["min_count"]).sum())
    check(line == {"command": "filter", "min_count": fit["cutoff"],
                   "kept": kept, "of": len(counts)},
          f"filter --auto: {line}")
    check(container.read_header(solid)["n"] == kept, "the filtered set")
    say(f"  filter --auto: wall {fwall:.3f} s, min_count "
        f"{line['min_count']}, kept {kept} of {len(counts)}")
    pwall, busy_us = profiled(torch, lambda: run_cli(["hist", full]))
    return {"wall_s": wall, "host_read_s": read_s, "filter_wall_s": fwall,
            **fit,
            "profiled_wall_s": pwall,
            "device_busy_ms": None if busy_us is None else busy_us / 1e3}


def write_fixture(rng, genome, tmp):
    """The 30x reads as one FASTQ, as N_SAMPLES FASTQ samples of
    consecutive reads, and the golden subset (the first SUBSET_READS)."""
    n_reads = round(COVERAGE * GENOME_BP / READ_LEN)
    fq = os.path.join(tmp, "ecoli30x.fastq")
    sub_fq = os.path.join(tmp, "subset.fastq")
    samples = [os.path.join(tmp, f"s{i}.fastq") for i in range(N_SAMPLES)]
    bounds = np.linspace(0, n_reads, N_SAMPLES + 1).astype(np.int64)
    t0 = time.perf_counter()
    subset = None
    with contextlib.ExitStack() as stack:
        f = stack.enter_context(open(fq, "wb"))
        sf = [stack.enter_context(open(p, "wb")) for p in samples]
        for lo in range(0, n_reads, 1 << 16):
            codes = make_reads(rng, genome, min(1 << 16, n_reads - lo))
            if subset is None:
                subset = codes[:SUBSET_READS].copy()
            write_fastq(f, codes, lo)
            hi = lo + len(codes)
            for s in range(N_SAMPLES):
                a, b = max(bounds[s], lo), min(bounds[s + 1], hi)
                if a < b:
                    write_fastq(sf[s], codes[a - lo:b - lo], a)
    with open(sub_fq, "wb") as f:
        write_fastq(f, subset, 0)
    say(f"phase 3: wrote {n_reads} reads x {READ_LEN} bp "
        f"({n_reads * READ_LEN} bases), once whole and once as "
        f"{N_SAMPLES} samples, in {time.perf_counter() - t0:.1f} s")
    return {"fq": fq, "sub_fq": sub_fq, "subset": subset,
            "samples": samples, "bases": n_reads * READ_LEN}


def phase_main_path(torch, fx, tmp):
    """Phases 3 and 4: the kmerize path through the CLI at real size, on
    the wire path and on the u8 path, then the u8 path on the golden
    subset; returns each kernel's launches in its main-path run."""
    from zotpu_torch.io import container, fastq
    from zotpu_torch.reference_impl import golden as G
    from zotpu_torch import kernels
    from zotpu_torch.kernels.pack import pack_canonical_plain
    from zotpu_torch.keys import SENTINEL
    from zotpu_torch.workloads import kmerize as W

    fq, sub_fq, subset = fx["fq"], fx["sub_fq"], fx["subset"]
    out = os.path.join(tmp, "ecoli30x.zkf")
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = json.loads(run_cli(["kmerize", "-k", K, "--batch-reads",
                                BATCH_READS, "--max-len", MAX_LEN, out,
                                fq])[-1])
    wall = time.perf_counter() - t0
    run1 = kernels.launches()
    say(f"  kmerize (CLI, cuda): {json.dumps(stats)}")
    say(f"  wall {wall:.3f} s, {stats['bases'] / wall:.6e} bases/s, "
        f"unique {stats['unique']}, launches {json.dumps(run1)}")
    b = stats["batches"]
    check(run1["pack_canonical_wire"] == b, "K1a ran once per batch")
    check(run1["dedup_compact"] == b, "K2 ran once per batch")
    check(run1["set_op_fused"] >= b - 1, "K3 ran at least batches-1 times")
    check(run1["pack_canonical"] == 0, "the wire run took no u8 pack")

    # the oracle: plain pack per batch on the card, cat, torch.unique
    t0 = time.perf_counter()
    parts = []
    for batch in fastq.parse_batches(fq, BATCH_READS, MAX_LEN, halo=K - 1):
        k = pack_canonical_plain(torch.from_numpy(batch.codes).cuda(),
                                 torch.from_numpy(batch.lengths).cuda(), K)
        parts.append(k[k != SENTINEL])
    allk = torch.cat(parts)
    del parts
    uk, uc = torch.unique(allk, sorted=True, return_counts=True)
    got = container.read(out)
    check(np.all(np.diff(got.keys.astype(np.int64)) > 0),
          "keys strictly increasing")
    check(int(got.counts.sum(dtype=np.uint64)) == allk.shape[0],
          "sum of counts = valid windows")
    check(np.array_equal(got.keys, uk.cpu().numpy().astype(np.uint64)),
          "keys equal the oracle's")
    check(np.array_equal(got.counts.astype(np.int64), uc.cpu().numpy()),
          "counts equal the oracle's")
    say(f"  oracle (plain pack + torch.unique) agrees: {uk.shape[0]} keys, "
        f"{allk.shape[0]} windows ({time.perf_counter() - t0:.1f} s)")
    del allk, uk, uc

    # the same fixture through the u8 pack path: 32 does not divide 150
    u8_out = os.path.join(tmp, "ecoli30x_u8.zkf")
    kernels.reset_launches()
    t0 = time.perf_counter()
    ustats = json.loads(run_cli(["kmerize", "-k", K, "--batch-reads",
                                 BATCH_READS, "--max-len", READ_LEN, u8_out,
                                 fq])[-1])
    uwall = time.perf_counter() - t0
    run_u8 = kernels.launches()
    say(f"  kmerize u8 path (--max-len {READ_LEN}): wall {uwall:.3f} s, "
        f"{ustats['bases'] / uwall:.6e} bases/s, launches "
        f"{json.dumps(run_u8)}")
    check(run_u8["pack_canonical"] == ustats["batches"], "K1b ran per batch")
    check(run_u8["pack_canonical_wire"] == 0, "the u8 run took no wire pack")
    got_u8 = container.read(u8_out)
    check(np.array_equal(got_u8.keys, got.keys)
          and np.array_equal(got_u8.counts, got.counts),
          "u8 path container equals the wire path's")
    del got, got_u8

    # host side alone: parse + wire pack + pin, no device work
    t0 = time.perf_counter()
    hstats = W.Stats()
    for _ in W._iter_batches([fq], BATCH_READS, MAX_LEN, K, hstats,
                             wire_pack=True, pin=True):
        pass
    hwall = time.perf_counter() - t0
    say(f"  host pipeline alone (parse + wire pack + pin): {hwall:.3f} s, "
        f"{hstats.bases / hwall:.6e} bases/s")
    pwall, busy_us = profiled(torch, lambda: run_cli(
        ["kmerize", "-k", K, "--batch-reads", BATCH_READS, "--max-len",
         MAX_LEN, out, fq]))

    say("phase 4: golden subset through the u8 path")
    sub_out = os.path.join(tmp, "subset.zkf")
    kernels.reset_launches()
    sstats = json.loads(run_cli(["kmerize", "-k", K, "--batch-reads", 1024,
                                 "--max-len", READ_LEN, sub_out,
                                 sub_fq])[-1])
    run2 = kernels.launches()
    check(run2["pack_canonical"] == sstats["batches"], "K1b ran per batch")
    want_k, want_c = G.kmerize(K, list(subset))
    got = container.read(sub_out)
    check(np.array_equal(got.keys, want_k), "subset keys equal golden")
    check(np.array_equal(got.counts, want_c), "subset counts equal golden")
    say(f"  {sstats['bases']} bases, {sstats['batches']} batches, "
        f"{len(want_k)} unique k-mers: equal to golden; launches "
        f"{json.dumps(run2)}")
    # main-path counts: the wire run's, and K1b from the u8 run
    counts = {"pack_canonical_wire": run1["pack_canonical_wire"],
              "pack_canonical": run_u8["pack_canonical"],
              "dedup_compact": run1["dedup_compact"],
              "set_op_fused": run1["set_op_fused"]}
    for name, n in counts.items():
        check(n > 0, f"{name} launched on the kmerize path")
    return counts, {"wall_s": wall, "bases": stats["bases"],
                    "bases_per_s": stats["bases"] / wall,
                    "u8_wall_s": uwall,
                    "unique": stats["unique"], "batches": b,
                    "host_bases_per_s": hstats.bases / hwall,
                    "profiled_wall_s": pwall,
                    "device_busy_ms": (None if busy_us is None
                                       else busy_us / 1e3)}


def phase_scan(torch, fx, panel, tmp):
    """Phase 5: the scan path through the CLI at real size against an
    oracle that uses neither the join module nor K4, then the golden
    subset through the u8 path; returns K4's launches in the main run, the
    numbers, and the run's summary lines."""
    from zotpu_torch.io import container, fastq
    from zotpu_torch.reference_impl import golden as G
    from zotpu_torch import kernels
    from zotpu_torch.kernels.pack import pack_canonical_plain
    from zotpu_torch.keys import SENTINEL
    from zotpu_torch.workloads import pulldown as P

    pz = os.path.join(tmp, "panel.zkf")
    container.write(pz, container.KmerSet(k=K, keys=panel))
    samples = fx["samples"]
    say(f"phase 5: scan of {N_SAMPLES} samples against {len(panel)} panel "
        f"keys, --batch-reads {BATCH_READS} --max-len {MAX_LEN}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = lines = run_cli(["scan", "--batch-reads", BATCH_READS,
                               "--max-len", MAX_LEN, pz, *samples])
    wall = time.perf_counter() - t0
    run = kernels.launches()
    got = [json.loads(x) for x in lines]
    check([g["sample"] for g in got] == samples, "one line per sample")

    # the oracle: plain pack per batch on the card, torch.isin against the
    # unpadded panel, a reshape row sum, then the sums per record
    t0 = time.perf_counter()
    panel_t = torch.from_numpy(panel.astype(np.int64)).cuda()
    batches = bases = probed = 0
    for path, g in zip(samples, got):
        hits, rids = [], []
        for batch in fastq.parse_batches(path, BATCH_READS, MAX_LEN,
                                         halo=K - 1):
            keys = pack_canonical_plain(
                torch.from_numpy(batch.codes).cuda(),
                torch.from_numpy(batch.lengths).cuda(), K)
            row = torch.isin(keys, panel_t).reshape(
                batch.codes.shape[0], -1).sum(dim=1)
            n = batch.n_reads
            hits.append(row[:n].cpu().numpy())
            rids.append(batch.record_ids[:n])
            batches += 1
            bases += batch.bases
            probed += int((keys != SENTINEL).sum())
        _, inv = np.unique(np.concatenate(rids), return_inverse=True)
        per_rec = np.bincount(inv, weights=np.concatenate(hits))
        check(g["total_hits"] == int(per_rec.sum())
              and g["reads_with_hits"] == int((per_rec > 0).sum()),
              f"scan of {path} equals the oracle")
    del panel_t
    total = sum(g["total_hits"] for g in got)
    rwh = sum(g["reads_with_hits"] for g in got)
    say(f"  oracle (plain pack + torch.isin + row/record sums) agrees on "
        f"every sample: {total} hits, {rwh} reads with hits "
        f"({time.perf_counter() - t0:.1f} s)")
    say(f"  scan (CLI, cuda): wall {wall:.3f} s, {bases} bases, "
        f"{bases / wall:.6e} bases/s, {probed} k-mers probed, "
        f"{probed / wall:.6e} k-mers/s, {batches} batches, launches "
        f"{json.dumps(run)}; {card_line()}")
    check(run["pack_canonical_wire"] == batches, "K1a ran once per batch")
    check(run["join_row_hits"] == batches, "K4 ran once per batch")
    check(run["pack_canonical"] == 0, "the wire run took no u8 pack")

    # where the time goes: the host side alone, then a warm rerun under
    # torch.profiler for the device's busy share on the trace timeline
    t0 = time.perf_counter()
    for _ in P._iter_scan_batches(samples, BATCH_READS, MAX_LEN, K, True,
                                  True):
        pass
    hwall = time.perf_counter() - t0
    say(f"  host pipeline alone (parse + wire pack + pin, {N_SAMPLES} "
        f"samples): {hwall:.3f} s, {bases / hwall:.6e} bases/s")
    pwall, busy_us = profiled(torch, lambda: run_cli(
        ["scan", "--batch-reads", BATCH_READS, "--max-len", MAX_LEN, pz,
         *samples]))

    kernels.reset_launches()
    lines = run_cli(["scan", "--batch-reads", 1024, "--max-len", READ_LEN,
                     "--per-read", pz, fx["sub_fq"]])
    run2 = kernels.launches()
    per_read = [int(x.split("\t")[2]) for x in lines[1:]]
    want = G.scan_panel(K, panel, list(fx["subset"]))
    check(per_read == want.tolist(), "subset per-read hits equal golden")
    check(run2["pack_canonical"] > 0 and run2["join_row_hits"] > 0,
          "the subset took the u8 pack and K4")
    say(f"  golden subset (u8 path): {len(per_read)} reads, "
        f"{int(want.sum())} hits, equal to golden.scan_panel; launches "
        f"{json.dumps(run2)}")
    return run["join_row_hits"], {
        "wall_s": wall, "bases": bases, "bases_per_s": bases / wall,
        "kmers_probed": probed, "kmers_per_s": probed / wall,
        "batches": batches, "total_hits": total, "reads_with_hits": rwh,
        "host_wall_s": hwall, "profiled_wall_s": pwall,
        "device_busy_ms": None if busy_us is None else busy_us / 1e3}, summary


def phase_evidence(torch, genome, tmp, seed):
    """Phase 6: probes -> evidence --out-reads on spiked reads of a 20 kbp
    genome slice, against golden.kmerize + evidence_from_counts and the
    golden scan of every read."""
    from zotpu_torch import variants as V
    from zotpu_torch.io import container, fastq
    from zotpu_torch.reference_impl import golden as G
    from zotpu_torch import kernels

    seq = np.frombuffer(b"ACGT", np.uint8)[genome[2_000_000:2_020_000]]
    seq = seq.tobytes().decode()
    ref = os.path.join(tmp, "ref.fa")
    with open(ref, "w") as f:
        f.write(">chr1\n" + "".join(seq[i:i + 60] + "\n"
                                    for i in range(0, len(seq), 60)))
    specs = [f"chr1:g.{p}{seq[p - 1]}>{'ACGT'['ACGT'.index(seq[p - 1]) - 1]}"
             for p in (4001, 9001, 14001)] + ["chr1:g.17001_17003del"]
    pz, fq = os.path.join(tmp, "probes.zkf"), os.path.join(tmp, "spiked.fq")
    outdir = os.path.join(tmp, "support")
    run_cli(["probes", "-k", K, ref, pz, *specs])
    V.spike_reads(ref, specs, fq, coverage=30, vaf=0.3, read_len=READ_LEN,
                  error_rate=0.002, seed=seed)
    say(f"phase 6: evidence --out-reads, {len(specs)} variants on a "
        f"{len(seq)} bp reference")
    kernels.reset_launches()
    lines = run_cli(["evidence", "--batch-reads", 4096, "--max-len", MAX_LEN,
                     "--out-reads", outdir, pz, fq])
    run = kernels.launches()
    with fastq.open_file(fq) as f:
        seqs = [s for _, s, _ in fastq.read_fastq(f)]
    meta = container.read(pz).meta
    rows = [json.loads(x) for x in lines]
    want = [{"command": "evidence", "sample": fq, **r}
            for r in V.evidence_from_counts(meta, *G.kmerize(K, seqs))]
    check(rows[:-1] == want, "evidence rows equal golden")
    written = rows[-1]["supporting_reads"]
    for m in meta["variants"]:
        alt = np.asarray([int(x, 16) for x in m["alt_probes"]], np.uint64)
        n = int((G.scan_panel(K, alt, seqs) >= 1).sum())
        check(written[m["spec"]] == n and n > 0,
              f"{m['spec']}: supporting reads equal golden")
    check(run["join_row_hits"] > 0 and run["pack_canonical_wire"] > 0,
          "evidence ran K1a and K4")
    say(f"  {len(seqs)} reads; alt support "
        f"{[r['alt']['support'] for r in rows[:-1]]}, supporting reads "
        f"{json.dumps(written)}: equal to golden; launches {json.dumps(run)}")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(argvs, timeout):
    """Start one process per argv together and wait for all of them; a
    process still running at ``timeout`` seconds is killed (then every one
    is). Fails unless every process exits 0. Returns their outputs. They
    run from this script's directory (``-m zotpu_torch`` finds the port)
    and share the host's cores between them. Each one's pipe is read from
    its own thread while they run: a process whose exit waits for its
    peers (NCCL's teardown does) would otherwise wait for a peer blocked on
    a full pipe that is read only after the first has exited."""
    env = {**os.environ,
           "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // len(argvs)))}
    procs = [subprocess.Popen([sys.executable, *map(str, a)], env=env,
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    outs = [""] * len(procs)

    def drain(i):
        with procs[i].stdout as f:
            outs[i] = f.read()

    readers = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in readers:
        t.start()
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise
    finally:
        for t in readers:
            t.join(timeout=30)
    check(not any(t.is_alive() for t in readers),
          "every process's output was read to its end")
    for p, out in zip(procs, outs):
        check(p.returncode == 0, f"process {p.args} exited {p.returncode}:\n"
              f"{out[-4000:]}")
    return outs


def multi_worker(spec_path, pid) -> int:
    """One process of phase 13: joins the group on this card with the
    spec's backend, then runs the spec's commands in order (the CLI with
    the multi-controller flags, or the crashed spill run), each command's
    stdout to a file, and writes each command's seconds, launches and bytes
    sent to other processes. Any failure but the injected crash raises."""
    import torch
    import torch.distributed as dist
    from zotpu_torch import cli, kernels
    from zotpu_torch.dist import mesh as M
    from zotpu_torch.workloads import kmerize as W

    with open(spec_path) as f:
        spec = json.load(f)
    P = spec["processes"]
    dev = M.init_distributed(spec["coordinator"], P, pid, "cuda",
                             backend=spec["backend"])
    flags = ["--coordinator", spec["coordinator"], "--num-processes", str(P),
             "--process-id", str(pid)]
    records = []
    for j, cmd in enumerate(spec["commands"]):
        kernels.reset_launches()
        M.reset_sent_bytes()
        out = f"{spec['out']}.cmd{j}.p{pid}"
        t0 = time.perf_counter()
        if cmd[0] == "crash":   # kmerize --spill-dir, failing before batch 2
            kw = cmd[1]
            try:
                W.kmerize_paths_sharded(
                    kw["inputs"][pid::P], K, kw["shards"],
                    batch_reads=BATCH_READS, max_len=MAX_LEN,
                    capacity_factor=SHARD_CF, spill_dir=kw["spill_dir"],
                    fail_after_batches=1, device=dev)
            except W.Interrupted as e:
                rc = str(e)
            else:
                rc = "not interrupted"
        else:
            with open(out, "w") as f, contextlib.redirect_stdout(f):
                rc = cli.main([str(a) for a in cmd] + flags)
        torch.cuda.synchronize()
        records.append({"rc": rc, "seconds": time.perf_counter() - t0,
                        "launches": kernels.launches(),
                        "sent_bytes": M.sent_bytes()})
    with open(f"{spec['out']}.p{pid}.json", "w") as f:
        json.dump(records, f)
    dist.destroy_process_group()
    return 0


def phase_multi(torch, fx, tmp, scan_lines, per_read):
    """Phase 13: the multi-controller CLI with 2 processes x 2 slots on this
    card (gloo), against phases 3, 5 (8's single-device per-read hits), 10
    and 11; then, with two or more cards, the CLI itself on NCCL."""
    from zotpu_torch.io import container

    P, backend = 2, "gloo"
    samples = fx["samples"]
    flags = ["--batch-reads", BATCH_READS, "--max-len", MAX_LEN, "--shards",
             SHARDS]
    out = {name: os.path.join(tmp, f"multi_{name}.zkf")
           for name in ("prefix", "mixed", "union", "spill")}
    spill_dir = os.path.join(tmp, "spill_multi")
    os.mkdir(spill_dir)
    spill_in = samples[:SPILL_SAMPLES]
    calls = [
        ("(a) kmerize prefix", ["kmerize", "-k", K, *flags, out["prefix"],
                                *samples]),
        ("(a) kmerize mixed", ["kmerize", "-k", K, *flags, "--shard-hash",
                               "mixed", out["mixed"], *samples]),
        ("(b) scan --per-read", ["scan", *flags, "--per-read",
                                 os.path.join(tmp, "panel.zkf"), *samples]),
        ("(c) union", ["union", "--shards", SHARDS, out["union"],
                       os.path.join(tmp, "A.zkf"),
                       os.path.join(tmp, "B.zkf")]),
        ("(d) spill, crash", ["crash", {"inputs": spill_in, "shards": SHARDS,
                                        "spill_dir": spill_dir}]),
        ("(d) spill, --resume", ["kmerize", "-k", K, *flags, "--spill-dir",
                                 spill_dir, "--resume", out["spill"],
                                 *spill_in]),
    ]
    spec = {"coordinator": f"127.0.0.1:{free_port()}", "processes": P,
            "backend": backend, "out": os.path.join(tmp, "multi"),
            "commands": [c for _, c in calls]}
    with open(spec["out"] + ".spec.json", "w") as f:
        json.dump(spec, f)
    say(f"phase 13: multi-controller, {P} processes x {SHARDS // P} slots on "
        f"this card, backend {backend} (NCCL refuses two ranks on one card; "
        f"passed to init_distributed as backend={backend!r})")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_processes([[os.path.abspath(__file__), "--worker",
                    spec["out"] + ".spec.json", "--rank", pid]
                   for pid in range(P)], timeout=600)
    wall = time.perf_counter() - t0
    recs = []
    for pid in range(P):
        with open(f"{spec['out']}.p{pid}.json") as f:
            recs.append(json.load(f))

    def printed(j, pid):
        with open(f"{spec['out']}.cmd{j}.p{pid}") as f:
            return f.read().splitlines()

    result = {"processes": P, "slots_per_process": SHARDS // P,
              "backend": backend, "wall_s_all": wall, "calls": {}}
    want = {"pack_canonical_wire", "set_op_fused", "join_row_hits_tagged",
            "merge_runs", "merge_dedup", "merge_runs_payload"}
    ran = set()
    for j, (name, _) in enumerate(calls):
        rs = [r[j] for r in recs]
        expect = ("injected failure before batch 2" if name.endswith("crash")
                  else 0)
        check(all(r["rc"] == expect for r in rs), f"{name}: {rs}")
        runs = [{k: n for k, n in r["launches"].items() if n} for r in rs]
        ran |= {k for r in runs for k in r}
        row = {"wall_s": max(r["seconds"] for r in rs),
               "sent_bytes": [r["sent_bytes"] for r in rs],
               "launches": runs}
        result["calls"][name] = row
        say(f"  {name}: wall {row['wall_s']:.3f} s, bytes sent to the other "
            f"process {row['sent_bytes']}, backend {backend}, launches per "
            f"process {json.dumps(runs)}")
    check(want <= ran, f"phase 13 launched {sorted(want - ran)} nowhere")
    for mode in ("prefix", "mixed"):
        verify_equal(out[mode], os.path.join(tmp, "ecoli30x.zkf"),
                     f"(a) two-process kmerize ({mode}) equals phase 3's")
    check([x for x in printed(2, 0) if x.startswith("{")] == scan_lines
          and not [x for x in printed(2, 1) if x.startswith("{")],
          "(b) process 0 printed phase 5's summary lines, process 1 none")
    for pid in range(P):
        rows = [x for x in printed(2, pid) if not x.startswith("{")]
        mine = range(pid, len(samples), P)
        check(rows == [f"{samples[i]}\t{r}\t{h}" for i in mine
                       for r, h in enumerate(per_read[i][2])],
              f"(b) process {pid}'s per-read rows equal the single-device "
              f"scan's for its samples")
    verify_equal(out["union"], os.path.join(tmp, "union.zkf"),
                 "(c) the two-process streamed union equals phase 10's")
    names = sorted(os.listdir(spill_dir))
    check(all(f"run{b:06d}.p{p}.zkf" in names for p in range(P)
              for b in (1, 2)) and len(names) % P == 0,
          f"(d) a run file per process and batch: {names}")
    verify_equal(out["spill"], os.path.join(tmp, "spill_acc.zkf"),
                 "(d) the resumed two-process spill run equals phase 11's")
    say(f"  equal: (a) phase 3's container, prefix and mixed; (b) phase 5's "
        f"lines and the single-device per-read hits; (c) phase 10's union; "
        f"(d) phase 11's result, {len(names)} run files; {wall:.1f} s for "
        f"the processes in all; {card_line()}")
    n = torch.cuda.device_count()
    if n >= 2:
        result["nccl"] = phase_multi_nccl(fx, tmp, 4 if n >= 4 else 2)
    return result


def phase_entry(torch, dev):
    """Phase 13b: the port's entry points (zotpu_torch/entry.py). ``entry()``
    on the card against its plain route on the same tensors moved to the
    CPU; ``dryrun_multichip`` over SHARDS slots of this card against
    golden and the same call on SHARDS CPU slots, through K1a, K1b, K3,
    K4 tagged, K5, K6 and K7; with SHARDS cards or more, the dry run over
    distinct cards against the one-card run. The counts are reset just
    before each card run and read just after it; returns their sums and
    the phase's numbers."""
    from zotpu_torch import entry as E
    from zotpu_torch import kernels
    from zotpu_torch.reference_impl import golden as G

    say(f"phase 13b: entry points: entry() on the card, "
        f"dryrun_multichip({SHARDS}) over {SHARDS} slots of it")
    step, args = E.entry()
    check(all(a.device.type == "cuda" for a in args),
          "entry()'s arguments live on the card")
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = step(*args)
    n = int(got[2])
    entry_wall = time.perf_counter() - t0
    run = kernels.launches()
    want = step(*(a.cpu() for a in args))
    check(n == int(want[2])
          and torch.equal(got[0][:n].cpu(), want[0][:n])
          and torch.equal(got[1][:n].cpu(), want[1][:n]),
          "entry()'s dense prefix and n equal the plain route's on the CPU")
    check(run["pack_canonical"] > 0 and run["dedup_compact"] > 0,
          f"entry() launched K1b and K2: {run}")
    launches = dict(run)
    step_ms = cuda_ms(torch, lambda: step(*args))
    res = {"entry": {"unique": n, "wall_s_first": entry_wall,
                     "step_ms": step_ms, "launches": {
                         k: v for k, v in run.items() if v}}}

    codes, _ = E.dry_inputs(SHARDS)
    gk, gc = G.kmerize(E.DRY_K, list(codes))
    slots = [str(dev)] * SHARDS
    kernels.reset_launches()
    one = E.dryrun_multichip(SHARDS, devices=slots)
    run = kernels.launches()
    want = ("pack_canonical_wire", "pack_canonical", "set_op_fused",
            "join_row_hits_tagged", "merge_runs", "merge_dedup",
            "merge_runs_payload")
    check(all(run[name] > 0 for name in want),
          f"the dry run launched {sorted(k for k in want if not run[k])} "
          f"no time")
    for name, v in run.items():
        launches[name] += v
    cpu = E.dryrun_multichip(SHARDS, devices=["cpu"] * SHARDS)

    def same(a, b):
        return (all(np.array_equal(a[key], b[key])
                    for key in ("keys", "counts", "row_hits"))
                and all(a[key] == b[key] for key in
                        ("union", "cards", "overflow", "slot_bytes")))

    check(np.array_equal(one["keys"], gk)
          and np.array_equal(one["counts"], gc * 2),
          "the dry run's global set equals golden.kmerize (counts twice: "
          "the accumulator took the batch twice)")
    check(same(one, cpu), "the dry run on the card equals it on CPU slots")
    warm = E.dryrun_multichip(SHARDS, devices=slots)
    check(same(warm, one), "a second dry run gives the same result")

    def row(r, launched):
        return {"devices": r["devices"], "wall_s": r["wall"],
                "sent_bytes": r["sent_bytes"],
                "slot_bytes": r["slot_bytes"], "unique": len(r["keys"]),
                "union": r["union"], "overflow": r["overflow"],
                "launches": {k: v for k, v in launched.items() if v}}

    res["dryrun_one_card"] = row(one, run)
    res["dryrun_one_card_warm_wall_s"] = warm["wall"]
    n_cards = torch.cuda.device_count()
    if n_cards >= SHARDS:
        kernels.reset_launches()
        multi = E.dryrun_multichip(SHARDS)
        run = kernels.launches()
        check(all(run[name] > 0 for name in want)
              and multi["devices"] == [f"cuda:{i}" for i in range(SHARDS)],
              f"the dry run over {SHARDS} cards launched every kernel: {run}")
        check(same(multi, one), f"the dry run over {SHARDS} distinct cards "
              f"equals the one-card run")
        res["dryrun_distinct_cards"] = row(multi, run)
        res["dryrun_distinct_cards_warm_wall_s"] = E.dryrun_multichip(
            SHARDS)["wall"]
    else:
        say(f"  {n_cards} card(s) visible: the dry run ran over {SHARDS} "
            f"slots of one card only, not over {SHARDS} distinct cards")
    say(f"  entry(): {n} unique k-mers, first call {entry_wall:.4f} s, step "
        f"{step_ms:.4f} ms (CUDA events, queued); dryrun_multichip("
        f"{SHARDS}) on one card: wall {json.dumps(one['wall'])}, warm "
        f"{json.dumps(warm['wall'])}, sent_bytes {one['sent_bytes']}, "
        f"slot_bytes {one['slot_bytes']}, equal to golden and to CPU slots; "
        f"{card_line()}")
    return launches, res


def run_module(argv, timeout):
    """python ARGV in a process of its own, from this script's directory;
    fails unless it exits 0. Returns its stdout lines."""
    res = subprocess.run([sys.executable, *argv], capture_output=True,
                         text=True, timeout=timeout,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(res.returncode == 0, f"python {' '.join(argv)} exited "
          f"{res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return res.stdout.strip().splitlines()


def positive_numbers(rec, where):
    """Every number of a bench record (and of its load sweep's points) is
    finite and above 0; genome_bases may be null (uniform fixture)."""
    for key, v in rec.items():
        if key == "load_sweep":
            for point in v:
                positive_numbers(point, f"{where} load point")
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            check(np.isfinite(v) and v > 0, f"{where}: {key} = {v}")
        else:
            check(key in ("workload", "impl", "fixture", "device",
                          "launches", "dense_dedup")
                  or (key == "genome_bases" and v is None),
                  f"{where}: {key} = {v!r}")


def phase_bench(torch):
    """Phase 14: ``python -m zotpu_torch bench`` at the CLI's defaults and
    the micro-benchmarks, each in a process of its own on this card.
    Returns the launches of every kernel over the phase."""
    say("phase 14: python -m zotpu_torch bench --workload all, then "
        "--workload setops-sort, at the CLI's defaults; then "
        "python -m zotpu_torch.bench.micro 24")
    torch.cuda.empty_cache()
    lines, seconds = [], {}
    for workload in ("all", "setops-sort"):
        t0 = time.perf_counter()
        lines += run_module(["-m", "zotpu_torch", "bench", "--workload",
                             workload], timeout=800)
        seconds[workload] = time.perf_counter() - t0
    recs = []
    for line in lines:
        try:
            recs.append(json.loads(line))
        except json.JSONDecodeError:
            check(False, f"a bench line that does not parse: {line!r}")
        say(f"  bench {line}")
    card = torch.cuda.get_device_name(0)
    by_name = {}
    for r in recs:
        name = (r["workload"], r.get("impl"))
        by_name.setdefault(name, []).append(r)
        check(r["device"] == card, f"{name} names {r['device']!r}, not "
              f"the card {card!r}")
        positive_numbers(r, str(name))
        want = set(BENCH_KERNELS.get(name, ()))
        check(want <= set(r["launches"]), f"{name} launched "
              f"{sorted(r['launches'])}, not all of {sorted(want)}")
    check(set(by_name) == set(BENCH_KERNELS),
          f"the bench's workloads {sorted(map(str, by_name))} are the "
          f"twelve of BENCH_KERNELS")
    check(all(len(rs) == 1 for name, rs in by_name.items()
              if name[0] != "kmerize_scaling"),
          "one record a workload (scaling: one a mesh size)")
    (scan,), (sscan,) = by_name[("scan", None)], by_name[
        ("scan_shard_model", None)]
    check(scan["total_hits"] == sscan["total_hits"],
          f"scan counts {scan['total_hits']} hits, its shard model "
          f"{sscan['total_hits']}")
    (sens,) = by_name[("kmerize_shard_sensitivity", None)]
    check(sens["second_round_overhead"] > 0
          and len(sens["load_sweep"]) == 5,
          "the forced second round costs more than 0; five sweep points")
    t1 = time.perf_counter()
    micro = run_module(["-m", "zotpu_torch.bench.micro", "24"], timeout=300)
    t_micro = time.perf_counter() - t1
    for line in micro:
        say(f"  micro {line}")
    summary = json.loads(micro[-1])
    check(list(summary["ms"]) == list(MICRO_ROWS)
          and all(np.isfinite(v) and v > 0 for v in summary["ms"].values())
          and all(any(line.split()[:1] == [row] for line in micro)
                  for row in MICRO_ROWS),
          f"the micro-benchmark's six rows printed: {summary}")
    check({"pack_canonical", "dedup_compact"} <= set(summary["launches"]),
          f"micro launched K1b and K2: {summary['launches']}")
    launches = dict.fromkeys(KERNEL_INFO, 0)
    for rs in by_name.values():
        for kernel, n in rs[0]["launches"].items():
            launches[kernel] += n
    for kernel, n in summary["launches"].items():
        launches[kernel] += n
    say(f"  seconds of the processes: bench --workload all "
        f"{seconds['all']:.1f}, --workload setops-sort "
        f"{seconds['setops-sort']:.1f}, micro {t_micro:.1f}; launches in "
        f"all {json.dumps(launches)}; {card_line()}")
    return launches


def phase_multi_nccl(fx, tmp, P):
    """Phase 13 with two or more cards: the CLI itself, one process per
    card (``python -m zotpu_torch ... --process-id I``, NCCL, --shards P)."""
    say(f"  NCCL: the CLI itself, {P} processes, one per card")
    flags = ["--batch-reads", BATCH_READS, "--max-len", MAX_LEN]
    res = {}
    for name, cmd in (("kmerize", ["kmerize", "-k", K, *flags,
                                   os.path.join(tmp, "nccl.zkf"),
                                   *fx["samples"]]),
                      ("union", ["union", os.path.join(tmp, "nccl_u.zkf"),
                                 os.path.join(tmp, "A.zkf"),
                                 os.path.join(tmp, "B.zkf")])):
        port = free_port()
        t0 = time.perf_counter()
        run_processes([["-m", "zotpu_torch", *cmd, "--coordinator",
                        f"127.0.0.1:{port}", "--num-processes", P,
                        "--process-id", pid] for pid in range(P)],
                      timeout=600)
        res[name] = time.perf_counter() - t0
        say(f"  NCCL {name}: {P} processes, wall {res[name]:.3f} s "
            f"(process start included)")
    verify_equal(os.path.join(tmp, "nccl.zkf"),
                 os.path.join(tmp, "ecoli30x.zkf"),
                 "NCCL kmerize equals phase 3's container")
    verify_equal(os.path.join(tmp, "nccl_u.zkf"),
                 os.path.join(tmp, "union.zkf"),
                 "NCCL union equals phase 10's")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return multi_worker(args.worker, args.rank)

    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from zotpu_torch.io import native
    from zotpu_torch import _build

    card = card_line()
    say(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    so, secs = _build.build()
    _build.lib()
    say(f"  kernels built in {secs:.1f} s -> {os.path.relpath(so)}")
    say(f"  FASTQ parser in use: {native.backend()}")
    check(native.backend() == "native",
          "the native FASTQ parser is built and in use (the numpy fallback "
          "would change every end-to-end number)")

    dev = torch.device("cuda")
    phase_selftest(torch, dev, args.seed)
    rng = np.random.default_rng(args.seed)
    genome = rng.integers(0, 4, GENOME_BP).astype(np.uint8)
    panel = make_panel(genome, args.seed)
    rows = phase_kernels(torch, dev, rng, genome, panel)
    rows.update(phase_shard_kernels(torch, dev, rng, genome, panel))
    with tempfile.TemporaryDirectory() as tmp:
        fx = write_fixture(rng, genome, tmp)
        launches, e2e = phase_main_path(torch, fx, tmp)
        launches["join_row_hits"], scan, scan_lines = phase_scan(
            torch, fx, panel, tmp)
        phase_evidence(torch, genome, tmp, args.seed)
        launches.update(phase_sharded_kmerize(torch, fx, tmp))
        sharded, sscan, per_read = phase_sharded_scan(torch, fx, panel)
        launches.update(sharded)
        sets, merge = phase_merge(torch, fx, tmp)
        op_launches, setops = phase_setops(torch, dev, sets, tmp)
        for path in sets:
            os.remove(path)
        bench_rows = phase_setop_bench(torch, dev, args.seed)
        spill_launches, spill = phase_spill(torch, dev, fx, tmp)
        spectrum = phase_spectrum(torch, tmp)
        multi = phase_multi(torch, fx, tmp, scan_lines, per_read)
    entry_launches, entry = phase_entry(torch, dev)
    bench_launches = phase_bench(torch)
    op_launches["merge"] += merge["set_op_fused"]
    by_path = {"kmerize": launches["set_op_fused"], **op_launches,
               "spill": spill_launches["set_op_fused"]}
    for path, n in by_path.items():
        check(n > 0, f"K3 launched on the {path} path")
    say(f"e2e kmerize: {json.dumps(e2e)}")
    say(f"e2e scan: {json.dumps(scan)}")
    say(f"e2e sharded scan: {json.dumps(sscan)}")
    say(f"e2e merge: {json.dumps(merge)}")
    say(f"e2e set ops: {json.dumps(setops)}")
    say(f"spill/resume: {json.dumps(spill)}")
    say(f"spectrum: {json.dumps(spectrum)}")
    say(f"multi-controller: {json.dumps(multi)}")
    say(f"entry points: {json.dumps(entry)}")
    say(f"K3 launches by path: {json.dumps(by_path)}")
    check(not any(m.split(".")[0] in ("jax", "zotpu") for m in sys.modules),
          "neither jax nor the JAX package zotpu was imported")

    say(card_line())
    k3 = KERNEL_INFO["set_op_fused"]
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1], "launches": launches[name],
         "bench_launches": bench_launches[name],
         "entry_launches": entry_launches[name],
         **rows[name]} for name in KERNEL_INFO] + [
        # K3 again, at the set-op bench size: the launches are those of
        # the op's own path (merge: phases 9 and 10; the others: phase 10)
        {"name": f"set_op_fused op={op} at 2^24 keys a side",
         "route": "cuda", "source": k3[0], "replaces": k3[1],
         "launches": op_launches[op], **row}
        for op, row in bench_rows.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
