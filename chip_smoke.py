#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (zotpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]      # from the repository root

Phases (any failure exits non-zero; no exception is caught):

1. the card's name and power limit (nvidia-smi), then the kernel build
   and the native FASTQ parser's (the numpy fallback in use is a failure);
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
   ``pulldown_paths``; K7 and K4's tagged entry must run.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
one JSON object with every kernel's launches, error, times and bound.
The script imports nothing of the JAX package ``zotpu``: it runs from a
tree that holds ``chip_smoke.py`` and ``zotpu_torch/`` alone.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
    n_in = int(na) + int(nb)
    for op in ("merge", "union", "intersect", "diff"):
        n_op = int(M.set_op_fused(ka, ca, kb, cb, op, n_a=na, n_b=nb)[2])
        r = measure(torch, f"set_op_fused op={op} (K3)",
                    lambda: M.set_op_fused(ka, ca, kb, cb, op, n_a=na, n_b=nb),
                    lambda: M.set_op_plain(ka, ca, kb, cb, op, n_a=na, n_b=nb),
                    (n_in + n_op) * 16 + 24, defined=dense_prefix)
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
    Returns K7's and K4 tagged's launches."""
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
             "device_busy_ms": None if busy_us is None else busy_us / 1e3})


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
    subset through the u8 path; returns K4's launches in the main run."""
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
    lines = run_cli(["scan", "--batch-reads", BATCH_READS, "--max-len",
                     MAX_LEN, pz, *samples])
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
        "device_busy_ms": None if busy_us is None else busy_us / 1e3}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
    rng = np.random.default_rng(args.seed)
    genome = rng.integers(0, 4, GENOME_BP).astype(np.uint8)
    panel = make_panel(genome, args.seed)
    rows = phase_kernels(torch, dev, rng, genome, panel)
    rows.update(phase_shard_kernels(torch, dev, rng, genome, panel))
    with tempfile.TemporaryDirectory() as tmp:
        fx = write_fixture(rng, genome, tmp)
        launches, e2e = phase_main_path(torch, fx, tmp)
        launches["join_row_hits"], scan = phase_scan(torch, fx, panel, tmp)
        phase_evidence(torch, genome, tmp, args.seed)
        launches.update(phase_sharded_kmerize(torch, fx, tmp))
        sharded, sscan = phase_sharded_scan(torch, fx, panel)
        launches.update(sharded)
    say(f"e2e kmerize: {json.dumps(e2e)}")
    say(f"e2e scan: {json.dumps(scan)}")
    say(f"e2e sharded scan: {json.dumps(sscan)}")
    check(not any(m.split(".")[0] in ("jax", "zotpu") for m in sys.modules),
          "neither jax nor the JAX package zotpu was imported")

    say(card_line())
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1], "launches": launches[name],
         **rows[name]} for name in KERNEL_INFO]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
