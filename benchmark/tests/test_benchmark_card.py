"""Card tests of the benchmark: the control at each one-card cell's own
size, and a short run of each one-card cell through ``benchmark/run.py``.

    python -m pytest -m cuda benchmark/tests/test_benchmark_card.py -q

They skip where there is no CUDA device; that is decided in a fixture.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import control  # noqa: E402

pytestmark = pytest.mark.cuda

ONE_CARD = ("kmerize.ecoli30x.1file", "scan.ecoli30x.16samples",
            "kmerize.ecoli30x.16files")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", ONE_CARD[:2])
def test_control_fails_at_the_cells_size(card, capsys, cell):
    """The reference with 32-bit keys in the program's place is not
    correct on three seeds (the 16-file cell's reads and reference are
    the one-file cell's)."""
    assert control.main(["--workload", cell, "--seeds", "2147483905",
                         "2147483906", "2147483907"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert all(json.loads(x)["control_correct"] is False for x in lines)


@pytest.mark.parametrize("cell", ONE_CARD)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0
    assert res["device"]["platform"] == "gpu"
