"""On-device self-test: every device path against golden, in process.

Port of zotpu/selftest.py, the gate to run on a card before a benchmark:
the CPU test suite runs the kernels' plain PyTorch versions, and only a run
on the card shows that the CUDA kernels give the same bytes there. It runs
the five BASELINE configs on small deterministic fixtures through the
port's workload functions on the selected device, byte-compares each with
the golden reference, and prints one JSON line per check and a summary.

Checks beyond the five configs, on D slots (the largest power of two up to
8 that the slots hold): the sharded set op and jaccard, the chunk-streamed
sharded set op, the sharded scan, the chunk-streamed merge of the CLI, the
spill runs' layout stamps, the mixed-hash sharded kmerize step (D >= 2),
and on CUDA the receive tree with its fused dedup on one slot
(``make_kmerize_step(force_second_round=True)``), with the overflow round
gated off and taken.

The port's kmerize step always emits dense runs, so the last checks
compare each slot's ``[:n]`` directly; the JAX package's marked form
(``compact=False``) and its ``compact_sorted`` are not ported.
"""

from __future__ import annotations

import json
import os
import time
import types

import numpy as np
import torch

from zotpu_torch.reference_impl import golden as G


def _mk_reads(rng, genome: str, n: int, length: int, frac_genomic: float,
              with_n: bool = True) -> list[str]:
    reads = []
    for i in range(n):
        if rng.random() < frac_genomic:
            off = rng.integers(0, len(genome) - length)
            reads.append(genome[off:off + length])
        else:
            alpha = "ACGTN" if with_n and i % 4 == 0 else "ACGT"
            reads.append("".join(rng.choice(list(alpha), size=length)))
    return reads


def _slots(device, devices) -> list[torch.device]:
    """The device slots of the run: ``devices`` as given, else every
    visible card on cuda and one slot on the CPU."""
    if devices is not None:
        slots = [torch.device(d) for d in devices]
    elif torch.device(device).type == "cuda":
        slots = [torch.device(f"cuda:{i}")
                 for i in range(torch.cuda.device_count())]
    else:
        slots = [torch.device(device)]
    if not slots:
        raise ValueError(f"selftest on {device}: no device is visible")
    return slots


def _wire_inputs(codes: np.ndarray, lengths: np.ndarray, dev):
    """(rows, L) u8 codes -> the step's wire input tuple on ``dev``, as
    the kmerize path packs and uploads a batch."""
    from zotpu_torch.workloads import feed
    batch = types.SimpleNamespace(codes=codes, lengths=lengths)
    return tuple(t.to(dev) for t in feed.host_tensors(batch, wire_pack=True,
                                                      pin=False))


def _dense_set(out):
    """A step slot's (keys, counts, n, ...) -> host (u64 keys, u32 counts)
    of its dense prefix."""
    n = int(out[2])
    return (out[0][:n].cpu().numpy().astype(np.uint64),
            out[1][:n].cpu().numpy().astype(np.uint32))


def run_selftest(k: int = 25, verbose_print=print,
                 budget_s: float | None = None, device="cuda",
                 devices=None) -> int:
    """Returns 0 when every check that RAN is byte-equal, 1 otherwise.

    The single-device checks run on the first slot; the sharded ones on D
    slots, D the largest power of two <= min(len(slots), 8), where the
    slots are ``devices`` (several may name one card) or else every visible
    card on cuda and one slot on the CPU.

    ``budget_s`` (or env ``ZOTPU_SELFTEST_BUDGET``, seconds) makes the run
    deadline-aware: once elapsed time exceeds the budget, remaining checks
    are skipped between device operations and the summary says ``partial:
    true``. A partial run with zero failures still gates as a pass (no
    byte-inequality was observed)."""
    from zotpu_torch.io import container as C
    from zotpu_torch.workloads import kmerize as WK
    from zotpu_torch.workloads import pulldown as WP
    from zotpu_torch.workloads import setops as WS
    from zotpu_torch.workloads import spectrum as WSp

    if budget_s is None:
        budget_s = float(os.environ.get("ZOTPU_SELFTEST_BUDGET", 0)) or None
    slots = _slots(device, devices)
    dev = slots[0]

    checks: list[tuple[str, bool, str]] = []
    t_start = time.perf_counter()

    def over_budget() -> bool:
        return (budget_s is not None
                and time.perf_counter() - t_start > budget_s)

    def check(name: str, ok: bool, detail: str = ""):
        checks.append((name, bool(ok), detail))
        verbose_print(json.dumps({"check": name, "ok": bool(ok),
                                  **({"detail": detail} if detail else {})}))

    class _OverBudget(Exception):
        pass

    def guard():
        if over_budget():
            raise _OverBudget

    rng = np.random.default_rng(20260819)
    genome = "".join(rng.choice(list("ACGT"), size=20000))
    reads_a = _mk_reads(rng, genome, 600, 128, 0.7)
    reads_b = _mk_reads(rng, genome, 500, 128, 0.5)

    import tempfile
    partial = False
    try:
      with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "a.fastq")
        fb = os.path.join(d, "b.fastq")
        for path, reads in ((fa, reads_a), (fb, reads_b)):
            with open(path, "w") as f:
                for i, r in enumerate(reads):
                    f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")

        # config 1: kmerize, device accumulator path vs golden
        keys_a, cnt_a = WK.kmerize_paths([fa], k, batch_reads=256,
                                         max_len=128, device=dev)
        gk_a, gc_a = G.kmerize(k, reads_a)
        check("config1_kmerize",
              np.array_equal(keys_a, gk_a) and np.array_equal(cnt_a, gc_a),
              f"{len(gk_a)} unique")
        guard()

        keys_b, cnt_b = WK.kmerize_paths([fb], k, batch_reads=256,
                                         max_len=128, device=dev)
        gk_b, gc_b = G.kmerize(k, reads_b)

        # config 2: merge via the device tree
        mk, mc = WS.merge_tree_device([(keys_a, cnt_a), (keys_b, cnt_b)],
                                      device=dev)
        wk, wc = G.merge([(gk_a, gc_a), (gk_b, gc_b)])
        check("config2_merge",
              np.array_equal(mk, wk) and np.array_equal(mc, wc),
              f"{len(wk)} unique")
        guard()

        # config 3: set algebra (one K3 launch per op)
        ok3 = True
        for op, gold in (("union", G.union), ("intersect", G.intersect),
                         ("diff", G.difference)):
            dk, dc = WS.set_op((keys_a, cnt_a), (keys_b, cnt_b), op=op,
                               device=dev)
            wk3, wc3 = gold((gk_a, gc_a), (gk_b, gc_b))
            ok3 &= np.array_equal(dk, wk3) and np.array_equal(dc, wc3)
        check("config3_setops", ok3)
        guard()

        # config 4: spectrum + cutoff
        h_dev = WSp.spectrum(cnt_a, max_count=64, device=dev)
        h_gold = G.spectrum(gc_a, max_count=64)
        fit = WSp.spectrum_with_cutoff(cnt_a, device=dev)
        check("config4_hist",
              np.array_equal(np.asarray(h_dev), np.asarray(h_gold))
              and fit["cutoff"] >= 1)
        guard()

        # config 5: panel pulldown, incl. the sentinel-heavy probe regime
        # (short + N-laden reads -> many invalid windows) -- per-read hit
        # vectors must match exactly
        panel_src = [genome[:4000]]
        panel_keys, _ = G.kmerize(k, panel_src)
        samples = reads_b + ["".join(rng.choice(list("ACGTN"), size=40))
                             for _ in range(200)]  # short, N-heavy tail
        fs = os.path.join(d, "s.fastq")
        with open(fs, "w") as f:
            for i, r in enumerate(samples):
                f.write(f"@s{i}\n{r}\n+\n{'I' * len(r)}\n")
        (tot, rwh, per) = WP.pulldown_paths(panel_keys, [fs], k,
                                            batch_reads=256,
                                            max_len=128, device=dev)[0]
        want = G.scan_panel(k, panel_keys, samples)
        check("config5_scan",
              np.array_equal(np.asarray(per, np.int64), want)
              and tot == int(want.sum()) and rwh == int((want > 0).sum()),
              f"{tot} hits / {rwh} reads")

        # largest power-of-two slot count (1 on a one-card machine, 8 on
        # the CPU tests' slots or 4 slots placed on one card)
        D = 1
        while D * 2 <= min(len(slots), 8):
            D *= 2
        mesh_devs = slots[:D]

        # sharded set op + jaccard with summed cardinalities
        guard()
        gi_k, _ = G.intersect((gk_a, gc_a), (gk_b, gc_b))
        gu_k, gu_c = G.union((gk_a, gc_a), (gk_b, gc_b))
        sk, sc, cards = WS.set_op_sharded((keys_a, cnt_a), (keys_b, cnt_b),
                                          "union", k, D, devices=mesh_devs)
        jac = WS.jaccard_sharded(keys_a, keys_b, k, D, devices=mesh_devs)
        check("sharded_setop_psum",
              np.array_equal(sk, gu_k) and np.array_equal(sc, gu_c)
              and cards["intersect"] == len(gi_k)
              and jac["intersect"] == len(gi_k)
              and jac["union"] == len(gu_k), f"D={D}")

        # chunk-streamed sharded set op (a tiny chunk forces many chunks
        # per slot)
        guard()
        pa = os.path.join(d, "a.zkf")
        pb = os.path.join(d, "b.zkf")
        C.write(pa, C.KmerSet(k=k, keys=keys_a, counts=cnt_a))
        C.write(pb, C.KmerSet(k=k, keys=keys_b, counts=cnt_b))
        kk, sk2, sc2, cards2 = WS.set_op_sharded_stream(
            pa, pb, "union", D, chunk=2048, devices=mesh_devs)
        check("sharded_setop_stream",
              kk == k and np.array_equal(sk2, gu_k)
              and np.array_equal(sc2, gu_c)
              and cards2["intersect"] == len(gi_k))

        # sharded pulldown: routing with a row-id payload, the K7 receive
        # tree and K4's tagged entry; per-read hits must match golden
        # exactly, INCLUDING the sentinel-heavy sample tail (invalid
        # windows route as sentinel bucket padding with tag 0)
        guard()
        (stot, srwh, sper) = WP.pulldown_paths_sharded(
            panel_keys, [fs], k, n_shards=D, batch_reads=256,
            max_len=128, devices=mesh_devs)[0]
        check("sharded_scan_stream_join",
              np.array_equal(np.asarray(sper, np.int64), want)
              and stot == int(want.sum()) and srwh == int((want > 0).sum()),
              f"D={D}, {stot} hits")

        # chunk-streamed merge: container chunks -> DeviceAccumulator level
        # merges (the cmd_merge path)
        guard()
        import argparse

        from zotpu_torch import cli as CLI
        pm = os.path.join(d, "m.zkf")
        old_chunk = os.environ.get("ZOTPU_MERGE_CHUNK")
        os.environ["ZOTPU_MERGE_CHUNK"] = "4096"
        try:
            CLI.cmd_merge(argparse.Namespace(
                host=False, inputs=[pa, pb], output=pm, codec=None,
                merge_capacity=1 << 22, device=str(dev)))
        finally:
            if old_chunk is None:
                os.environ.pop("ZOTPU_MERGE_CHUNK", None)
            else:
                os.environ["ZOTPU_MERGE_CHUNK"] = old_chunk
        ms = C.read(pm)
        wmk, wmc = G.merge([(gk_a, gc_a), (gk_b, gc_b)])
        check("merge_chunk_streamed",
              np.array_equal(ms.keys, wmk) and np.array_equal(ms.counts, wmc))

        # spill/resume layout-stamp rejection (host logic, ~free): stale-k
        # and different-mode spills must be recomputed, matching loads kept
        ps = os.path.join(d, "run000001.zkf")
        stamp = {"k": k, "batch_reads": 256, "max_len": 128}
        C.write(ps, C.KmerSet(k=k, keys=keys_a[:4], counts=cnt_a[:4],
                              meta={"run": 1, **stamp}))
        ok_st = WK._load_run_if_valid(ps, stamp) is not None
        ok_st &= WK._load_run_if_valid(ps, {**stamp, "k": k + 2}) is None
        C.write(ps, C.KmerSet(k=k, keys=keys_a[:4], counts=cnt_a[:4],
                              meta={"run": 1, **stamp, "n_shards": 8}))
        ok_st &= WK._load_run_if_valid(ps, stamp) is None
        check("spill_stamp_rejection", ok_st)

        # mixed-hash sharded kmerize step (owner EMBEDDED in spare key bits
        # + strip after routing): the embedding only exists at D >= 2 (at
        # D=1 p_bits=0 degenerates to the prefix path), so this check is
        # adaptive
        if D >= 2:
            guard()
            from zotpu_torch.dist import mesh as M
            from zotpu_torch.dist import shuffle as SH
            codes_m = np.stack([G.encode(r) for r in reads_a])
            # pad rows to a multiple of D slots
            rpc = -(-len(reads_a) // D)
            pad_r = D * rpc - len(reads_a)
            codes_m = np.concatenate([codes_m, np.full(
                (pad_r, 128), 4, np.uint8)]) if pad_r else codes_m
            lengths_m = np.concatenate([np.full(len(reads_a), 128, np.int32),
                                        np.zeros(pad_r, np.int32)])
            step_m, _ = SH.make_kmerize_step(
                M.make_mesh(devices=mesh_devs), k, rpc, 128,
                capacity_factor=4.0, wire=True, shard_hash="mixed")
            out = step_m([_wire_inputs(codes_m[i * rpc:(i + 1) * rpc],
                                       lengths_m[i * rpc:(i + 1) * rpc], s)
                          for i, s in enumerate(mesh_devs)])
            okm = sum(int(o[3]) for o in out) == 0
            parts = [_dense_set(o) for o in out]
            gk2, gc2 = SH.gather_global([p[0] for p in parts],
                                        [p[1] for p in parts],
                                        [len(p[0]) for p in parts],
                                        reorder=True)
            okm &= (np.array_equal(gk2, gk_a)
                    and np.array_equal(gc2.astype(np.uint32), gc_a))
            check("mixed_hash_sharded_step", okm, f"D={D}")
        else:
            verbose_print(json.dumps({
                "check": "mixed_hash_sharded_step", "skipped":
                "1-device backend: owner embedding exists only at D >= 2 "
                "(p_bits=0 degenerates to the prefix path); covered by the "
                "8-fake-device suite and any multi-chip rig's gate"}))

      # sharded step with the receive tree + fused dedup on ONE slot
      # (force_second_round): gated-off AND taken overflow rounds.
      # guard() runs BEFORE each chunk of device work, never after the
      # last one -- a run whose final check completes just as the budget
      # expires is complete, not partial.
      if dev.type == "cuda":
        guard()
        from zotpu_torch.dist import mesh as M
        from zotpu_torch.dist import shuffle

        codes = np.stack([G.encode(r) for r in reads_a])
        lengths = np.full(len(reads_a), 128, np.int32)
        inputs = [_wire_inputs(codes, lengths, dev)]
        mesh = M.make_mesh(devices=[dev])
        for label, cf in (("gated", 1.05), ("taken", 0.8)):
            if label != "gated":
                guard()
            step, _ = shuffle.make_kmerize_step(
                mesh, k, len(reads_a), 128, capacity_factor=cf,
                wire=True, force_second_round=True)
            out = step(inputs)[0]
            okd = int(out[3]) == 0
            got_k, got_c = _dense_set(out)
            okd &= (np.array_equal(got_k, gk_a)
                    and np.array_equal(got_c, gc_a))
            check(f"sharded_fused_dedup_{label}", okd)
      else:
        verbose_print(json.dumps({
            "check": "sharded_fused_dedup", "skipped":
            "CPU backend (interpret-mode coverage lives in the test suite)"}))
    except _OverBudget:
        partial = True
        verbose_print(json.dumps({
            "selftest_budget_exceeded": budget_s,
            "note": ("remaining checks skipped CLEANLY between device ops "
                     "(no mid-op kill; every check that ran is reported)")}))

    n_fail = sum(1 for _, ok, _ in checks if not ok)
    verbose_print(json.dumps({
        "command": "selftest", "device": str(dev),
        "checks": len(checks), "failed": n_fail,
        "seconds": round(time.perf_counter() - t_start, 2),
        **({"partial": True} if partial else {}),
        "ok": n_fail == 0}))
    return 0 if n_fail == 0 else 1
