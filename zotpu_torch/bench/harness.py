"""Performance harness of the port: ``python -m zotpu_torch bench``.

Port of zotpu/bench/harness.py. The same twelve workloads, built from the
same ``numpy.random.default_rng`` seeds, so both packages time the same
fixtures byte for byte (``_Fixture``, ``_synth_codes``, the scan panel and
the e2e and parse FASTQs). Each workload prints one JSON record (scaling:
one a mesh size) with the JAX record's ``workload`` name and keys, plus
``device`` (the card's name, or ``"cpu"``), ``launches`` (the launches of
each of the port's CUDA kernels during the workload; empty on the CPU,
where every wrapper runs its plain PyTorch version) and ``wall_s`` (the
workload's wall seconds, fixtures included). Every call names its
device: the workloads take ``device`` and nothing falls back to the CPU.

Timing keeps the JAX harness's contract. A fence is a host read of a
scalar the work ends in (every launch is on the device's current stream,
so the read waits for all of them). ``_amortized_time`` is the slope of N
dispatches plus one fence against one dispatch plus one fence, min over
repeats; the other workloads take the min over ``repeats`` after a
warm-up.

What the port measures differently, by key:

- ``kmerize`` times the port's per-batch step: pack (K1a), ``torch.sort``
  and the dense dedup-compact (K2). The JAX step stops at the marked runs
  (``compact=False``), which the port does not have.
- ``kmerize_shard_model``: ``t_step_nodedup_s`` is renamed ``t_step_s``.
  ``_bench_no_dedup`` is not ported, so the port's D=1 sharded step
  includes its dedup (K2).
- ``setops_merge`` with ``impl="sort"`` is ``torch.sort`` of the two sides'
  concatenation, then K2's dedup-compact: what the sort-based
  ``kernels/setops.set_op`` computes (concatenate, sort, combine), exact
  here because every count of the fixture is 1. ``gb_per_s`` counts the
  JAX contract's 12 B an entry (a u64 key and a u32 count) in both forms.
- ``scan_shard_model`` and ``kmerize_shard_model``: the D=8 receive-tree
  terms always run (the JAX harness runs them only under Pallas), at the
  port's own run capacity (the k-mers over 8, not rounded to a tile), with
  every run ascending (the TPU's alternating direction is not kept). A
  failure to build or launch a kernel there raises; nothing is swallowed.
  ``alltoall_bytes_per_chip`` of the scan keeps the JAX count of 12 B a
  k-mer (a u32 key pair and a u32 row id), so that it stays comparable
  with the JAX record. The port routes an int64 key and an int64 row id,
  16 B a k-mer: ``alltoall_bytes_per_chip_port`` holds that, read off the
  exchanged tensors (``step.routed_bytes_per_probe``).
- ``setops_shard_model`` times ``workloads/setops._run_slots``, which reads
  the cardinalities on the host in every call: one sync per dispatch.
- ``kmerize_sustained`` sizes its accumulator from the batch shape, where
  the JAX harness runs one more step inside the timing to learn it.
- ``kmerize_scaling`` uploads each slot's codes before the timing, where
  the JAX step takes host arrays.
- ``kmerize_shard_sensitivity`` keeps an error only for the card running
  out of memory (``torch.cuda.OutOfMemoryError``); any other failure
  raises.

Not ported: bench.py's ``progress`` streaming (bench.py itself is not
ported) and the rig-specific slow-link fallbacks of the timers.
"""

from __future__ import annotations

import gzip
import json
import os
import tempfile
import time

import numpy as np
import torch

from zotpu_torch import kernels
from zotpu_torch.dist import shuffle
from zotpu_torch.dist.mesh import make_mesh
from zotpu_torch.io import bgzf, wire
from zotpu_torch.kernels.merge_fused import set_op_fused
from zotpu_torch.kernels.pack import pack_canonical_wire
from zotpu_torch.kernels.sortdedup import dedup_compact, kmer_sort_dedup
from zotpu_torch.keys import SENTINEL
from zotpu_torch.reference_impl import golden as G
from zotpu_torch.workloads import kmerize as W
from zotpu_torch.workloads import pulldown
from zotpu_torch.workloads import setops
from zotpu_torch.workloads.accumulator import DeviceAccumulator

# keys of the JAX records that the port's records carry under another name
# (the module docstring says why)
RENAMED_KEYS = {"t_step_nodedup_s": "t_step_s"}
# record keys whose values do not depend on time: equal on every device,
# and in both packages, for the same arguments
COUNT_KEYS = ("workload", "impl", "bases", "k", "fixture", "kmers",
              "kmers_probed", "panel", "total_hits", "n", "n_per_shard",
              "alltoall_bytes_per_chip", "batches", "genome_bases",
              "acc_batches", "unique", "files", "devices")
# --workload choices, in the order ``run`` measures them; "all" runs every
# one but setops-sort, as the JAX harness does
WORKLOADS = ("kmerize", "setops", "setops-sort", "scan", "scan-shard-model",
             "setops-shard-model", "scaling", "shard-model",
             "shard-sensitivity", "sustained", "parse", "e2e")


def _synth_codes(rng, reads, length):
    return rng.integers(0, 4, size=(reads, length),
                        endpoint=False).astype(np.uint8)


class _Fixture:
    """Read-batch generator for the device benches; a copy of the JAX
    harness's, draw for draw.

    kind="uniform": i.i.d. random bases -- dedup ratio ~1, the unique set
    grows without bound (the cheapest operating point for dedup/count-
    combine, the worst-case growth for the accumulator).

    kind="coverage": the E. coli-shaped workload BASELINE config 1 names --
    reads drawn from ONE deterministic synthetic genome (default sized so
    the whole run is ~30x coverage) with a 0.5% per-base substitution error
    rate. Real duplicate segments exercise the count-combine paths at a
    realistic dedup ratio, and the accumulator's unique set saturates near
    genome size plus the error tail instead of growing linearly.
    """

    def __init__(self, kind: str, seed: int = 0,
                 genome_bases: int | None = None,
                 total_bases: int | None = None,
                 error_rate: float = 0.005):
        if kind not in ("uniform", "coverage"):
            raise ValueError(f"unknown fixture {kind!r}")
        self.kind = kind
        self.rng = np.random.default_rng(seed)
        self.error_rate = error_rate
        self.genome = None
        if kind == "coverage":
            if genome_bases is None:
                # size the genome for ~30x over the run's total bases
                genome_bases = max((total_bases or (1 << 25)) // 30, 1 << 20)
            self.genome = self.rng.integers(0, 4, size=genome_bases,
                                            dtype=np.int64)

    def codes(self, reads: int, length: int) -> np.ndarray:
        if self.kind == "uniform":
            return _synth_codes(self.rng, reads, length)
        offs = self.rng.integers(0, len(self.genome) - length, reads)
        codes = self.genome[offs[:, None]
                            + np.arange(length)[None, :]].astype(np.uint8)
        n_err = int(reads * length * self.error_rate)
        if n_err:
            er = self.rng.integers(0, reads, n_err)
            ec = self.rng.integers(0, length, n_err)
            codes[er, ec] = self.rng.integers(0, 4, n_err).astype(np.uint8)
        return codes


def _wire(codes, device):
    """u8 codes -> the wire words (io/wire.py) and int32 lengths on device."""
    pw, mw = wire.pack_codes(codes)
    lengths = np.full(codes.shape[0], codes.shape[1], np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in
                 (pw.view(np.int32), mw.view(np.int32), lengths))


def _amortized_time(dispatch, fence, repeats: int = 3, n: int = 4):
    """Per-dispatch seconds with the host sync amortized away: min over
    repeats of time(n dispatches + 1 fence) against time(1 dispatch + 1
    fence); the slope is the per-batch device cost, which a pipeline that
    syncs once a run pays. Returns (slope_s, single_sync_s). Noise can
    make the slope 0 or less at small sizes; the single-sync time stands
    in then (it charges the sync to the batch, so it is never too fast)."""
    def t_of(m):
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            r = None
            for _ in range(m):
                r = dispatch()
            fence(r)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1 = t_of(1)
    tn = t_of(n)
    slope = (tn - t1) / (n - 1)
    if slope <= 0:
        return t1, t1
    return slope, t1


def _min_time(fn, repeats: int):
    """Min seconds of fn() (which ends in a fence) over repeats, after a
    warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def bench_kmerize(total_bases: int, *, device, k: int = 25,
                  read_len: int = 256, repeats: int = 3,
                  fixture: str = "uniform",
                  fx: "_Fixture | None" = None) -> dict:
    """The per-batch device step on the wire form as the pipeline ships
    it: pack (K1a), ``torch.sort``, dense dedup-compact (K2)."""
    fx = fx or _Fixture(fixture, total_bases=8 * total_bases)
    reads = max(total_bases // read_len, 1)
    pw, mw, lengths = _wire(fx.codes(reads, read_len), device)

    def step():
        return kmer_sort_dedup(pack_canonical_wire(pw, mw, lengths, k))[2]

    int(step())  # warm-up
    dt, dt_sync = _amortized_time(step, int, repeats=repeats)
    bases = reads * read_len
    kmers = reads * (read_len - k + 1)
    return {
        "workload": "kmerize", "k": k, "bases": bases,
        "fixture": fx.kind,
        "seconds": dt,
        "seconds_single_sync": dt_sync,
        "bases_per_s": bases / dt,
        "kmers_per_s": kmers / dt,
    }


def bench_setops(n: int = 1 << 24, *, device, repeats: int = 3,
                 impl: str = "auto") -> dict:
    """Sorted-set merge GB/s (BASELINE metric 2) of two sides of n random
    keys below 2^50 with counts of 1. impl="auto": the fused set-op kernel
    (K3) with the valid counts; "sort": ``torch.sort`` of the
    concatenation, then K2's dedup-compact."""
    rng = np.random.default_rng(1)

    def mk():
        keys = np.sort(rng.integers(0, 1 << 50, size=n).astype(np.uint64))
        keys = np.unique(keys)
        k = np.full(n, SENTINEL, np.int64)
        c = np.zeros(n, np.int64)
        k[:len(keys)] = keys.astype(np.int64)
        c[:len(keys)] = 1
        return (torch.from_numpy(k).to(device), torch.from_numpy(c).to(device),
                torch.tensor(len(keys), dtype=torch.int64, device=device))

    ka, ca, na = mk()
    kb, cb, nb = mk()

    def step():
        if impl == "sort":
            n_out = dedup_compact(torch.sort(torch.cat([ka, kb])).values)[2]
        else:
            n_out = set_op_fused(ka, ca, kb, cb, op="merge", n_a=na,
                                 n_b=nb)[2]
        return int(n_out)  # fence

    dt = _min_time(step, repeats)
    bytes_moved = 2 * n * 12  # two inputs of (key u64, count u32) entries
    return {
        "workload": "setops_merge", "impl": impl, "n": 2 * n, "seconds": dt,
        "gb_per_s": bytes_moved / dt / 1e9,
        "keys_per_s": 2 * n / dt,
    }


def _scan_fixture(n_reads: int, read_len: int, k: int, panel_size: int):
    """The pulldown mix of the JAX harness (seed 2): most reads are
    background, every 20th comes from a 100,000-base genome whose k-mers
    seed part of the panel, so live hits flow through the per-read sums.
    Returns (rng after the draws, sorted u64 panel, u8 codes)."""
    rng = np.random.default_rng(2)
    genome = rng.integers(0, 4, size=100_000, endpoint=False).astype(np.uint8)
    gkeys, _ = G.kmerize(k, [genome])    # golden accepts 2-bit code arrays
    panel = np.unique(np.concatenate([
        gkeys, rng.integers(0, 1 << (2 * k), panel_size,
                            dtype=np.uint64).astype(np.uint64)]))
    codes = _synth_codes(rng, n_reads, read_len)
    src = n_reads // 20
    offs = rng.integers(0, len(genome) - read_len, src)
    for i, off in enumerate(offs):        # every 20th read is genomic
        codes[i * 20] = genome[off:off + read_len]
    return rng, panel, codes


def bench_scan(n_reads: int = 1 << 17, *, device, read_len: int = 256,
               k: int = 25, panel_size: int = 1 << 20,
               repeats: int = 3) -> dict:
    """Panel pulldown probe rate (BASELINE config 5, one device): wire-form
    reads packed (K1a) and probed against the device panel (K4)."""
    _, panel_keys, codes = _scan_fixture(n_reads, read_len, k, panel_size)
    panel = pulldown.panel_to_device(panel_keys, device=device)
    pw, mw, lengths = _wire(codes, device)

    def step():
        hits = pulldown.scan_batch_wire(pw, mw, lengths, panel, k)
        return int(hits.sum())  # fence

    total_hits = step()
    dt = _min_time(step, repeats)
    kmers = n_reads * (read_len - k + 1)
    return {
        "workload": "scan", "k": k, "panel": len(panel_keys),
        "kmers_probed": kmers, "total_hits": total_hits, "seconds": dt,
        "kmers_per_s": kmers / dt,
        "bases_per_s": n_reads * read_len / dt,
    }


def bench_scan_shard_model(n_reads: int = 1 << 17, *, device,
                           read_len: int = 256, k: int = 25,
                           panel_size: int = 1 << 20,
                           repeats: int = 3) -> dict:
    """Host-scale composition for BASELINE config 5: the full sharded
    pulldown step at D=1 on this device (panel partition, routing with
    global read-row ids, K4's tagged join, summed per-row hits), timed
    dispatch-amortized, plus the receive tree an 8-slot host would run on
    each slot (K7 over 8 sorted probe runs of the same volume with their
    row ids), measured here on synthetic runs. The 8-device line composes
    as 8 x the per-slot probe rate at a 0.8 efficiency floor."""
    rng, panel_keys, codes = _scan_fixture(n_reads, read_len, k, panel_size)
    inputs = [_wire(codes, device)]
    mesh = make_mesh(1, devices=[device])
    prow, _ = shuffle.partition_panel(panel_keys, k, 1)
    panels = [torch.from_numpy(prow[0]).to(device)]
    step = shuffle.make_pulldown_step(mesh, k, n_reads, read_len,
                                      capacity_factor=1.05, wire=True)

    def prog():
        row_hits, overflow = step(inputs, panels)
        return row_hits[0].sum() + overflow[0]

    total_hits = int(prog())  # warm-up
    dt, dt_sync = _amortized_time(prog, int, repeats=repeats)
    kmers = n_reads * (read_len - k + 1)
    out = {
        "workload": "scan_shard_model", "k": k, "panel": len(panel_keys),
        "kmers_probed": kmers, "total_hits": total_hits,
        "t_sharded_step_s": dt, "t_single_sync_s": dt_sync,
        "kmers_per_s_chip": kmers / dt,
        "alltoall_bytes_per_chip": kmers * 12,   # the JAX count
        "alltoall_bytes_per_chip_port": kmers * step.routed_bytes_per_probe,
    }
    # At D=1 the tree has no pass; an 8-slot host merges its 8 received
    # probe runs with log2(8) K7 passes, measured on this device
    D = 8
    cap8 = -(-kmers // D)
    h = np.sort(rng.integers(0, 1 << 50, size=D * cap8,
                             dtype=np.uint64).reshape(D, cap8), axis=1)
    tkeys = torch.from_numpy(h.astype(np.int64).reshape(-1)).to(device)
    ttag = torch.from_numpy(rng.integers(0, n_reads, size=D * cap8,
                                         dtype=np.int64)).to(device)

    def tree():
        qk, qt = shuffle.merge_received_runs_tag(tkeys, ttag, D, cap8, 0)
        return qk[-1] + qt[0]

    int(tree())  # warm-up
    t_tree8, _ = _amortized_time(tree, int, repeats=repeats)
    out["t_probe_tree8_s"] = t_tree8
    t8 = dt + t_tree8
    out["t_chip_model8_s"] = t8
    out["host8_kmers_per_s_at_0.8_eff"] = kmers / t8 * 8 * 0.8
    out["ici_gbps_needed_for_0.8_eff"] = kmers * 12 / (t8 / 4) / 1e9
    return out


def bench_setops_shard_model(n: int = 1 << 24, *, device, k: int = 25,
                             repeats: int = 3) -> dict:
    """Host-scale composition for BASELINE config 3: the sharded set op at
    D=1 on this device (key-prefix partition, K3 on the slot, cardinalities
    summed and read), 2 x n keys per slot (what each of 8 slots runs on an
    8-device host over a 2 x 8n-key pair), timed dispatch-amortized. The
    8-device line is 8 x the per-slot byte rate at a 0.8 efficiency
    floor; slots never exchange keys."""
    rng = np.random.default_rng(1)

    def mk():
        keys = np.unique(rng.integers(0, 1 << (2 * k), size=n)
                         .astype(np.uint64))
        return keys, np.ones(len(keys), np.uint32)

    a_keys, a_c = mk()
    b_keys, b_c = mk()
    mesh = make_mesh(1, devices=[device])
    rows_a, rows_b = ([setops._upload(kd, cd, device) for kd, cd in
                       setops._partition_sorted_prefix(keys, c, k, 1)]
                      for keys, c in ((a_keys, a_c), (b_keys, b_c)))

    def dispatch():
        return setops._run_slots(mesh, rows_a, rows_b, "merge", gather=False)

    dispatch()  # warm-up; every call reads its cardinalities (the fence)
    dt, dt_sync = _amortized_time(dispatch, lambda r: r, repeats=repeats)
    bytes_shard = (len(a_keys) + len(b_keys)) * 12
    return {
        "workload": "setops_shard_model", "n_per_shard": 2 * n,
        "t_shard_step_s": dt, "t_single_sync_s": dt_sync,
        "gb_per_s_shard": bytes_shard / dt / 1e9,
        "host8_gb_per_s_at_0.8_eff": bytes_shard / dt / 1e9 * 8 * 0.8,
    }


def _fence_step(out) -> int:
    """Fence of a sharded kmerize step: each slot's n_unique and
    overflow."""
    return sum(int(o[2]) + int(o[3]) for o in out)


def bench_scaling(*, device, reads_per_chip: int = 512, read_len: int = 256,
                  k: int = 25, repeats: int = 3) -> list[dict]:
    """Weak-scaling efficiency of the sharded kmerize step (BASELINE metric
    3): pack (u8 codes, K1b), owner sort, route, per-slot dedup (K2 at
    D=1; the K5/K6 tree at D >= 2) at D = 1, 2, 4, ... cards with constant
    per-card load; efficiency_D = t(1) / t(D). One card (or the CPU) gives
    the D=1 row only."""
    rng = np.random.default_rng(0)
    results = []
    t1 = None
    ndev = torch.cuda.device_count() if device.type == "cuda" else 1
    D = 1
    while D <= ndev:
        devices = ([device] if D == 1
                   else [torch.device("cuda", i) for i in range(D)])
        mesh = make_mesh(D, devices=devices)
        R = D * reads_per_chip
        codes = rng.integers(0, 4, size=(R, read_len)).astype(np.uint8)
        lengths = np.full(R, read_len, np.int32)
        inputs = []
        for d, dev in enumerate(devices):
            rows = slice(d * reads_per_chip, (d + 1) * reads_per_chip)
            inputs.append((torch.from_numpy(codes[rows]).to(dev),
                           torch.from_numpy(lengths[rows]).to(dev)))
        step, _ = shuffle.make_kmerize_step(mesh, k, reads_per_chip, read_len,
                                            capacity_factor=4.0)
        dt = _min_time(lambda: _fence_step(step(inputs)), repeats)
        if t1 is None:
            t1 = dt
        results.append({
            "workload": "kmerize_scaling", "devices": D,
            "bases": R * read_len, "seconds": dt,
            "bases_per_s": R * read_len / dt,
            "weak_scaling_efficiency": t1 / dt,
        })
        D *= 2
    return results


def bench_shard_model(total_bases: int = 1 << 25, *, device, k: int = 25,
                      read_len: int = 256, repeats: int = 3,
                      fixture: str = "uniform",
                      acc_batches: int = 8) -> dict:
    """Measured inputs of the multi-device projection (BASELINE metric 3),
    reported as a model, not as a measured efficiency:

    - ``t_plain_s``: the one-device kmerize step (``bench_kmerize``);
    - ``t_step_s``: the full sharded step at D=1 on this device (pack,
      owner sort, bucket fill, all-to-all, per-slot dedup);
      ``t_step_s / t_plain_s`` is the per-device price of the routing;
    - ``t_receive_tree8_fused_dedup_s``: the receive tree an 8-slot host
      runs on each slot per batch, 8 sorted runs of this batch's k-mers
      merged by K5 with the fused K6 last level, less the pack and sort
      that build the runs;
    - ``t_acc_amortized8_s``: the accumulator merges per batch,
      ``bench_sustained`` per batch less the plain step;
    - the per-device all-to-all volume (8 B per k-mer each way), from
      which the link rate for >= 0.8 weak-scaling efficiency follows:
      t_comm <= t8 / 4.

    One fixture generator feeds the plain step, the sharded step and the
    tree; ``bench_sustained`` builds its own of the same kind."""
    fx = _Fixture(fixture, total_bases=acc_batches * total_bases)
    reads = max(total_bases // read_len, 1)
    codes = fx.codes(reads, read_len)
    mesh = make_mesh(1, devices=[device])
    kmers = reads * (read_len - k + 1)
    bytes_each_way = kmers * 8           # an int64 key per k-mer
    out = {"workload": "kmerize_shard_model", "k": k,
           "bases": reads * read_len, "kmers": kmers, "fixture": fx.kind,
           "acc_batches": acc_batches,
           "alltoall_bytes_per_chip": bytes_each_way}

    plain = bench_kmerize(total_bases, k=k, read_len=read_len,
                          repeats=repeats, fx=fx, device=device)
    out["t_plain_s"] = plain["seconds"]
    out["plain_bases_per_s"] = plain["bases_per_s"]
    out["plain_seconds_single_sync"] = plain["seconds_single_sync"]

    step, _ = shuffle.make_kmerize_step(mesh, k, reads, read_len,
                                        capacity_factor=1.03, wire=True)
    inputs = [_wire(codes, device)]
    _fence_step(step(inputs))  # warm-up
    t_step, _ = _amortized_time(lambda: step(inputs), _fence_step,
                                repeats=repeats)
    out["t_step_s"] = t_step
    out["sharded_step_overhead"] = t_step / plain["seconds"]
    out["sharded_bases_per_s"] = reads * read_len / t_step

    D = 8
    cap8 = -(-kmers // D)
    pw, mw, lengths = inputs[0]

    def sorted_runs():
        # 8 independently sorted chunks of the unsorted k-mer stream:
        # interleaved key ranges, like the runs a slot receives
        keys = pack_canonical_wire(pw, mw, lengths, k)
        keys = torch.cat([keys, keys.new_full((D * cap8 - kmers,), SENTINEL)])
        return torch.sort(keys.view(D, cap8), dim=1).values.reshape(-1)

    def tree():
        return int(shuffle.merge_received_runs(sorted_runs(), D, cap8, 0,
                                               dedup=True)[2])

    def front():
        return int(sorted_runs()[-1])

    tt = _min_time(tree, repeats)
    tf = _min_time(front, repeats)
    out["t_receive_tree8_fused_dedup_s"] = max(tt - tf, 0.0)

    su = bench_sustained(total_bases=total_bases, k=k, read_len=read_len,
                         batches=acc_batches, fixture=fixture, device=device)
    out["sustained_per_batch_s"] = su["per_batch_s"]
    out["sustained_bases_per_s"] = su["bases_per_s"]
    out["t_acc_amortized8_s"] = max(su["per_batch_s"] - plain["seconds"], 0.0)
    t8 = (t_step + out["t_receive_tree8_fused_dedup_s"]
          + out["t_acc_amortized8_s"])
    out["t_chip_model8_s"] = t8
    out["host8_bases_per_s_at_0.8_eff"] = reads * read_len / t8 * 8 * 0.8
    out["ici_gbps_needed_for_0.8_eff"] = bytes_each_way / (t8 / 4) / 1e9
    return out


def bench_shard_sensitivity(total_bases: int = 1 << 25, *, device,
                            k: int = 25, read_len: int = 256,
                            repeats: int = 3) -> dict:
    """The scaling model beyond its steady-state point:

    - the D=1 sharded step with the overflow second round taken
      (capacity factor 0.85, ``force_second_round=True``) against the same
      program with the round gated off (1.03: every entry fits the first
      round), so the ratio is the taken round's cost;
    - a per-device load sweep of the sharded step (1x, 2x, 1/2x, 1/4x, 4x
      the batch): how the per-device rate moves with batch size. A point
      the device has no memory for is recorded with its error."""
    rng = np.random.default_rng(0)
    mesh = make_mesh(1, devices=[device])

    def measure(reads, capacity_factor):
        inputs = [_wire(_synth_codes(rng, reads, read_len), device)]
        step, _ = shuffle.make_kmerize_step(
            mesh, k, reads, read_len, capacity_factor=capacity_factor,
            wire=True, force_second_round=True)
        _fence_step(step(inputs))  # warm-up
        dt, _ = _amortized_time(lambda: step(inputs), _fence_step,
                                repeats=repeats)
        return dt

    reads = max(total_bases // read_len, 1)
    out = {"workload": "kmerize_shard_sensitivity", "k": k,
           "bases": reads * read_len, "load_sweep": []}
    t_gated = measure(reads, 1.03)
    t_taken = measure(reads, 0.85)
    out["t_second_round_gated_s"] = t_gated
    out["t_second_round_taken_s"] = t_taken
    out["second_round_overhead"] = t_taken / t_gated
    # the 4x point last: the largest, and the one that can run out of memory
    for num, den in ((1, 1), (2, 1), (1, 2), (1, 4), (4, 1)):
        r = reads * num // den
        try:
            t = t_gated if (num, den) == (1, 1) else measure(r, 1.03)
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            out["load_sweep"].append({"bases": r * read_len,
                                      "error": str(e)[:200]})
            continue
        out["load_sweep"].append({"bases": r * read_len, "seconds": t,
                                  "bases_per_s": r * read_len / t})
    out["load_sweep"].sort(key=lambda row: -row["bases"])
    return out


def bench_sustained(total_bases: int = 1 << 25, *, device, k: int = 25,
                    read_len: int = 256, batches: int = 8,
                    fixture: str = "uniform",
                    max_cap: int = 1 << 27) -> dict:
    """Sustained one-device rate: the per-batch step plus the LSM
    accumulator merges it amortizes (K3 with valid counts), over
    ``batches`` distinct device-resident batches (H2D excluded), the
    final transfer excluded. ``max_cap`` 2^27 keeps the JAX harness's
    workload: a run with more unique keys clamps its top levels (the
    deferred overflow, which only ``result()`` reports). Its JAX reason (a
    TPU memory ceiling) does not carry over to the card.
    ``fixture="coverage"`` draws every batch from one ~30x genome."""
    fx = _Fixture(fixture, total_bases=batches * total_bases)
    reads = max(total_bases // read_len, 1)
    devb = [_wire(fx.codes(reads, read_len), device) for _ in range(batches)]
    capacity = reads * (read_len - k + 1)

    def run_once():
        acc = DeviceAccumulator(capacity, max_cap=max_cap, device=device)
        for pw, mw, lengths in devb:
            acc.add(*kmer_sort_dedup(pack_canonical_wire(pw, mw, lengths, k)))
        # fence on every level's count, not result(): the final transfer
        # is a one-off outside the sustained rate
        return int(torch.stack([lvl[2] for lvl in acc.levels
                                if lvl is not None]).sum())

    dt = _min_time(run_once, 2)
    bases = batches * reads * read_len
    return {
        "workload": "kmerize_sustained", "k": k, "batches": batches,
        "fixture": fx.kind,
        "genome_bases": len(fx.genome) if fx.genome is not None else None,
        "bases": bases, "seconds": dt,
        "bases_per_s": bases / dt,
        "per_batch_s": dt / batches,
        "dense_dedup": True,
    }


def bench_parse(total_bases: int = 1 << 27, k: int = 25, read_len: int = 256,
                n_files: int = 4) -> dict:
    """Host-only input pipeline on .gz fixtures: inflate, parse, encode and
    wire pack, drained from the batch stream (``_iter_batches``, no device
    work) as uncompressed bases/s: n_files plain-gzip files in the parse
    worker pool against one worker, then one BGZF file of the same reads
    with the inflate pool against one inflate worker."""
    rng = np.random.default_rng(0)
    per_file_reads = max(total_bases // n_files // read_len, 1)
    lut = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, size=max(total_bases // 64, read_len + 1),
                          dtype=np.int64)
    qual = b"I" * read_len
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(n_files):
            offs = rng.integers(0, len(genome) - read_len, per_file_reads)
            p = os.path.join(d, f"r{i}.fastq.gz")
            with gzip.open(p, "wb", compresslevel=1) as f:
                for j in range(0, per_file_reads, 65536):
                    seqs = lut[genome[offs[j:j + 65536, None]
                                      + np.arange(read_len)[None, :]]]
                    f.write(b"".join(b"@r\n%s\n+\n%s\n" % (s.tobytes(), qual)
                                     for s in seqs))
            paths.append(p)
        gz_bytes = sum(os.path.getsize(p) for p in paths)

        def drain(parallel, ps=None):
            stats = W.Stats()
            t0 = time.perf_counter()
            for _ in W._iter_batches(ps or paths, 131072, read_len, k, stats,
                                     wire_pack=True, parallel=parallel):
                pass
            return stats.bases, time.perf_counter() - t0

        drain(True)                      # warm the page cache
        bases_seq, t_seq = drain(False)
        bases_par, t_par = min((drain(True) for _ in range(2)),
                               key=lambda r: r[1])

        raw = []
        for p in paths:
            with gzip.open(p, "rb") as f:
                raw.append(f.read())
        bz = os.path.join(d, "one.fastq.gz")
        bgzf.write_bgzf(bz, b"".join(raw))
        del raw
        drain(False, [bz])               # warm the page cache
        before = os.environ.get("ZOTPU_BGZF_WORKERS")
        os.environ["ZOTPU_BGZF_WORKERS"] = "1"
        try:
            bases_bz1, t_bz1 = drain(False, [bz])
        finally:
            if before is None:
                os.environ.pop("ZOTPU_BGZF_WORKERS", None)
            else:
                os.environ["ZOTPU_BGZF_WORKERS"] = before
        bases_bzp, t_bzp = min((drain(False, [bz]) for _ in range(2)),
                               key=lambda r: r[1])
    if not bases_par == bases_seq == bases_bz1 == bases_bzp:
        raise RuntimeError(f"the parse drains disagree on the bases: "
                           f"{bases_par}, {bases_seq}, {bases_bz1}, "
                           f"{bases_bzp}")
    return {
        "workload": "host_parse_gz", "bases": bases_par,
        "gz_bytes": gz_bytes, "files": n_files,
        "workers": int(os.environ.get("ZOTPU_PARSE_WORKERS",
                                      min(4, os.cpu_count() or 1))),
        "cores": os.cpu_count(),
        "seconds": t_par, "bases_per_s": bases_par / t_par,
        "sequential_bases_per_s": bases_seq / t_seq,
        "parallel_speedup": t_seq / t_par,
        "bgzf_workers": bgzf.default_workers(),
        "bgzf_single_file_bases_per_s": bases_bzp / t_bzp,
        "bgzf_serial_bases_per_s": bases_bz1 / t_bz1,
        "bgzf_speedup": t_bz1 / t_bzp,
    }


def _write_reads(path, seqs, qual):
    with open(path, "wb") as f:
        for i in range(0, len(seqs), 65536):
            f.write(b"".join(b"@r\n%s\n+\n%s\n" % (s.tobytes(), qual)
                             for s in seqs[i:i + 65536]))


def bench_e2e(total_bases: int = 1 << 25, *, device, k: int = 25,
              read_len: int = 128, repeats: int = 2) -> dict:
    """Whole-pipeline throughput: FASTQ on disk -> parse -> device batches
    -> device-resident merge -> the final set on the host
    (``kmerize_paths``, the CLI's path less the container write). The
    marginal rate differences out the fixed tail with a half-size run. The
    H2D link rate is that of one 32 MiB host array copied to the device;
    the wire form's 0.375 B a base turns it into a ceiling on bases/s."""
    rng = np.random.default_rng(0)
    n = max(total_bases // read_len, 1)
    lut = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, size=max(total_bases // 16, read_len + 1),
                          dtype=np.int64)
    offs = rng.integers(0, len(genome) - read_len, n)
    seqs = lut[genome[offs[:, None] + np.arange(read_len)[None, :]]]
    qual = b"I" * read_len

    def timed(path):
        stats = W.Stats()
        t0 = time.perf_counter()
        out = W.kmerize_paths([path], k, batch_reads=131072,
                              max_len=read_len, stats=stats, device=device)
        return time.perf_counter() - t0, stats, out

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bench.fastq")
        half = os.path.join(d, "bench_half.fastq")
        _write_reads(path, seqs, qual)
        _write_reads(half, seqs[:n // 2], qual)
        dt, stats, out = min((timed(path) for _ in range(max(repeats, 1))),
                             key=lambda r: r[0])
        dt_half, st2, _ = min((timed(half) for _ in range(max(repeats, 1))),
                              key=lambda r: r[0])
    marginal = ((stats.bases - st2.bases) / (dt - dt_half)
                if dt > dt_half else None)
    buf = np.frombuffer(bytearray(rng.bytes(32 << 20)), np.uint8)
    torch.from_numpy(buf[:1024]).to(device, copy=True)
    _sync(device)
    t0 = time.perf_counter()
    torch.from_numpy(buf).to(device, copy=True)
    _sync(device)
    up = time.perf_counter() - t0
    link = len(buf) / up
    ceiling = link / 0.375          # the wire form ships 0.375 B a base
    r = {
        "workload": "kmerize_e2e", "bases": stats.bases, "seconds": dt,
        "bases_per_s": stats.bases / dt, "unique": len(out[0]),
        "h2d_link_bytes_per_s": link,
        "link_bases_per_s_ceiling": ceiling,
        "fraction_of_link_ceiling": (stats.bases / dt) / ceiling,
    }
    if marginal is not None and marginal > 0:
        r["marginal_bases_per_s"] = marginal
    return r


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run(args) -> int:
    """Run ``args.workload`` (one of WORKLOADS, or "all") on
    ``args.device`` and print one JSON line per record as each workload
    ends. Size overrides (tests shrink these; the CLI passes None):
    ``setops_n``, ``scan_reads``, ``scan_panel``."""
    device = torch.device(args.device)
    setops_n = args.setops_n or (1 << 24)
    scan_reads = args.scan_reads or (1 << 17)
    scan_panel = args.scan_panel or (1 << 20)
    kw = {"device": device}
    jobs = {
        "kmerize": lambda: bench_kmerize(args.bases, k=args.k,
                                         repeats=args.repeats, **kw),
        "setops": lambda: bench_setops(n=setops_n, repeats=args.repeats,
                                       **kw),
        "setops-sort": lambda: bench_setops(n=setops_n, repeats=args.repeats,
                                            impl="sort", **kw),
        "scan": lambda: bench_scan(n_reads=scan_reads, panel_size=scan_panel,
                                   repeats=args.repeats, k=args.k, **kw),
        "scan-shard-model": lambda: bench_scan_shard_model(
            n_reads=scan_reads, panel_size=scan_panel,
            repeats=args.repeats, k=args.k, **kw),
        "setops-shard-model": lambda: bench_setops_shard_model(
            n=setops_n, repeats=args.repeats, **kw),
        "scaling": lambda: bench_scaling(repeats=args.repeats, **kw),
        "shard-model": lambda: bench_shard_model(
            total_bases=args.bases, k=args.k, repeats=args.repeats, **kw),
        "shard-sensitivity": lambda: bench_shard_sensitivity(
            total_bases=args.bases, k=args.k, repeats=args.repeats, **kw),
        "sustained": lambda: bench_sustained(total_bases=args.bases,
                                             k=args.k, **kw),
        "parse": lambda: bench_parse(total_bases=args.bases * 2, k=args.k),
        "e2e": lambda: bench_e2e(total_bases=args.bases, k=args.k,
                                 repeats=args.repeats, **kw),
    }
    name = _device_name(device)
    for workload in WORKLOADS:
        if args.workload != workload and not (
                args.workload == "all" and workload != "setops-sort"):
            continue
        before = kernels.launches()
        t0 = time.perf_counter()
        out = jobs[workload]()
        wall = time.perf_counter() - t0
        launches = {kname: n - before[kname]
                    for kname, n in kernels.launches().items()
                    if n > before[kname]}
        for r in out if isinstance(out, list) else [out]:
            r.update(device=name, launches=launches, wall_s=wall)
            print(json.dumps(r), flush=True)
    return 0
