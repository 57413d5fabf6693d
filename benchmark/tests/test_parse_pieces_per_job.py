"""CPU tests of the reader ``parse_pieces_per_job``: the pieces that a
job's plain FASTQ files were cut into for the parse pool (the program's
counter ``parse.pieces``), per job of the traced window.

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
                                        "parse_pieces_per_job.py"))


@pytest.mark.parametrize("cell, want", [
    # one file against 4 workers is cut, each job into ceil(400 reads /
    # 64) pieces; the pool takes the 16 files whole
    ("kmerize.ecoli30x.1file", 7), ("kmerize.ecoli30x.16files", 0)])
def test_a_traced_cpu_run_reports_the_pieces_per_job(capsys, monkeypatch,
                                                     cell, want):
    from zotpu_torch import metrics
    monkeypatch.setenv("ZOTPU_PARSE_WORKERS", "4")
    metrics.reset_counters()
    rc = run.main(["--workload", cell, "--seed", "2147483951", "--seconds",
                   "0.3", "--trace", "1"], root=ROOT,
                  devices=[torch.device("cpu")], cfg_patch=TINY)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    res = json.loads(out[-1])
    assert res["correct"]
    assert res["metrics"]["parse_pieces_per_job"]["value"] == want


@pytest.mark.parametrize("counters, jobs, want", [
    ({"parse.pieces": 45, "alloc.device": 6}, 3, 15.0),
    ({"parse.pieces": 0}, 3, 0.0), ({"alloc.device": 6}, 3, None),
    ({"parse.pieces": 45}, 0, None), ({}, 3, None), (None, 3, None)])
def test_parse_pieces_per_job(monkeypatch, counters, jobs, want):
    monkeypatch.setattr(program, "counters", lambda: counters)
    ctx = SimpleNamespace(window=SimpleNamespace(jobs=[{}] * jobs))
    assert reader().read(ctx) == want
