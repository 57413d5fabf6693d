"""``zotpu_torch.selftest.run_selftest`` against ``zotpu.selftest``: on the
CPU, with 8 slots as the JAX package's suite has 8 fake devices, both print
the same check lines (names, results, details, skip lines) and the same
summary apart from ``device`` and ``seconds``. The CLI's ``selftest``, the
time budget, and a set op that drops one key (the gate is not vacuous)."""

import json

import numpy as np
import pytest
import torch

from zotpu_torch import cli as tcli
from zotpu_torch.selftest import run_selftest

torch.set_num_threads(1)

K = 15


def _lines(fn):
    lines = []
    rc = fn(lines.append)
    return rc, [json.loads(x) for x in lines]


@pytest.fixture(scope="module")
def runs():
    from zotpu.selftest import run_selftest as jax_selftest
    return {"port": _lines(lambda p: run_selftest(
                k=K, verbose_print=p, device="cpu", devices=["cpu"] * 8)),
            "jax": _lines(lambda p: jax_selftest(k=K, verbose_print=p))}


def test_check_lines_match_jax(runs):
    (prc, port), (jrc, jax_) = runs["port"], runs["jax"]
    assert prc == jrc == 0
    assert port[:-1] == jax_[:-1]
    names = [r["check"] for r in port if "ok" in r and "check" in r]
    assert names == ["config1_kmerize", "config2_merge", "config3_setops",
                     "config4_hist", "config5_scan", "sharded_setop_psum",
                     "sharded_setop_stream", "sharded_scan_stream_join",
                     "merge_chunk_streamed", "spill_stamp_rejection",
                     "mixed_hash_sharded_step"]
    assert all(r["ok"] for r in port if "ok" in r)
    assert {"check": "mixed_hash_sharded_step", "ok": True,
            "detail": "D=8"} in port
    assert port[-2]["check"] == "sharded_fused_dedup" and "skipped" in port[-2]


def test_summary_matches_jax_but_device_and_seconds(runs):
    port, jax_ = runs["port"][1][-1], runs["jax"][1][-1]
    assert port.pop("device") == "cpu"
    assert port.pop("seconds") >= 0
    jax_.pop("device"), jax_.pop("seconds")
    assert port == jax_ == {"command": "selftest", "checks": 11,
                            "failed": 0, "ok": True}


def test_cli_selftest_on_one_cpu_slot(capsys):
    """``selftest --device cpu``: one slot, so D = 1 and the mixed-hash
    check prints its skip line; exit 0."""
    capsys.readouterr()
    assert tcli.main(["selftest", "-k", str(K), "--device", "cpu"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    summary = rows[-1]
    assert summary["ok"] is True and summary["failed"] == 0
    assert summary["checks"] == 10 and "partial" not in summary
    assert {"check": "sharded_setop_psum", "ok": True, "detail": "D=1"} in rows
    skip = [r for r in rows if r.get("check") == "mixed_hash_sharded_step"]
    assert len(skip) == 1 and "skipped" in skip[0]


def test_cli_selftest_without_a_card_exits_1(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    assert tcli.main(["selftest", "-k", str(K)]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "--device cuda" in out.err


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_selftest_budget_partial(monkeypatch, how):
    """An exhausted budget skips the remaining checks between device ops:
    the summary says partial, every check that ran is reported, and a
    zero-failure partial run still returns 0 (as the JAX package's
    ``test_selftest_budget_partial``)."""
    if how == "environment":
        monkeypatch.setenv("ZOTPU_SELFTEST_BUDGET", "1e-9")
        kw = {}
    else:
        kw = {"budget_s": 1e-9}
    rc, rows = _lines(lambda p: run_selftest(k=K, verbose_print=p,
                                             device="cpu", **kw))
    assert rc == 0
    summary = rows[-1]
    assert summary["partial"] is True and summary["ok"] is True
    assert summary["checks"] == 1                # config1 always completes
    assert any(r.get("selftest_budget_exceeded") == 1e-9 for r in rows)


def test_a_set_op_that_drops_a_key_fails_the_gate(monkeypatch):
    """Fault injection: ``workloads.setops.set_op`` loses one key of its
    result; config3_setops reports ok false and the run returns 1."""
    from zotpu_torch.workloads import setops as WS
    real = WS.set_op
    monkeypatch.setattr(WS, "set_op", lambda *a, **kw: tuple(
        x[1:] for x in real(*a, **kw)))
    rc, rows = _lines(lambda p: run_selftest(k=K, verbose_print=p,
                                             device="cpu",
                                             devices=["cpu"] * 2))
    assert rc == 1
    assert {"check": "config3_setops", "ok": False} in rows
    failed = [r.get("check") for r in rows if r.get("ok") is False]
    assert failed == ["config3_setops", None]          # and the summary
    assert rows[-1]["ok"] is False and rows[-1]["failed"] == 1


def test_selftest_fixture_is_the_jax_packages():
    """The same seed draws the same reads: ``_mk_reads`` of both packages
    on one generator state."""
    from zotpu.selftest import _mk_reads as jax_reads
    from zotpu_torch.selftest import _mk_reads
    genome = "".join(np.random.default_rng(3).choice(list("ACGT"), 2000))
    assert (_mk_reads(np.random.default_rng(9), genome, 50, 64, 0.6)
            == jax_reads(np.random.default_rng(9), genome, 50, 64, 0.6))
