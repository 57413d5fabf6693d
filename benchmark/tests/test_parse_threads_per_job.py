"""CPU tests of the reader ``parse_threads_per_job``: the threads that
parsed a job's input (the program's counter ``parse.threads``), per job
of the traced window.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import program, run  # noqa: E402

TINY = {"genome_bp": 20000, "coverage": 3, "batch_reads": 64,
        "panel_bp": 20000}


def reader():
    return run.load_module(os.path.join(run.HERE, "metrics",
                                        "parse_threads_per_job.py"))


@pytest.mark.parametrize("cell, workers, want", [
    # one file is cut into pieces for all 4 workers; 16 files or samples
    # are parsed whole by min(W, 16) of them
    ("kmerize.ecoli30x.1file", 4, 4), ("kmerize.ecoli30x.16files", 4, 4),
    ("scan.ecoli30x.16samples", 4, 4), ("scan.ecoli30x.16samples", 2, 2)])
def test_a_traced_cpu_run_reports_the_threads_per_job(capsys, monkeypatch,
                                                      cell, workers, want):
    from zotpu_torch import metrics
    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", str(workers))
    metrics.reset_counters()
    rc = run.main(["--workload", cell, "--seed", "2147483951", "--seconds",
                   "0.3", "--trace", "1"], root=ROOT,
                  devices=[torch.device("cpu")], cfg_patch=TINY)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    res = json.loads(out[-1])
    assert res["correct"]
    assert res["metrics"]["parse_threads_per_job"]["value"] == want


@pytest.mark.parametrize("counters, jobs, want", [
    ({"parse.threads": 12, "alloc.device": 6}, 3, 4.0),
    ({"parse.threads": 3}, 3, 1.0), ({"alloc.device": 6}, 3, None),
    ({"parse.threads": 12}, 0, None), ({}, 3, None), (None, 3, None)])
def test_parse_threads_per_job(monkeypatch, counters, jobs, want):
    monkeypatch.setattr(program, "counters", lambda: counters)
    ctx = SimpleNamespace(window=SimpleNamespace(jobs=[{}] * jobs))
    assert reader().read(ctx) == want
