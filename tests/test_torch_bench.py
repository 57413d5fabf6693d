"""The port's performance harness on the CPU (zotpu_torch/bench/): the
``all`` run of zotpu's own ``test_bench_cli_small``, the fixtures byte for
byte against the JAX harness's, the CLI's ``bench`` flags against
``zotpu bench``'s, the micro-benchmark rows, and the card as the default
device of ``panel_to_device`` and ``DeviceAccumulator``. The JAX harness's
records are held against the port's in test_torch_bench_parity.py and
test_torch_bench_e2e.py."""

import contextlib
import inspect
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zotpu.bench import harness as JH
from zotpu import cli as jcli
from zotpu_torch import cli as tcli
from zotpu_torch.bench import harness as TH
from zotpu_torch.bench import micro
from zotpu_torch.workloads import accumulator as TA
from zotpu_torch.workloads import pulldown as TPD

SMALL = dict(bases=1 << 16, k=15, repeats=1, setops_n=1 << 12,
             scan_reads=1 << 8, scan_panel=1 << 10)


def run_port(workload):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert TH.run(SimpleNamespace(workload=workload, device="cpu",
                                      **SMALL)) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.fixture(scope="module")
def recs():
    return run_port("all")


def test_bench_cli_small(recs):
    """tests/test_stats.py::test_bench_cli_small, on the port."""
    names = {r["workload"] for r in recs}
    assert {"kmerize", "setops_merge", "kmerize_scaling",
            "kmerize_shard_model", "kmerize_shard_sensitivity",
            "kmerize_sustained", "host_parse_gz", "kmerize_e2e",
            "scan_shard_model", "setops_shard_model"} <= names
    sens = next(r for r in recs
                if r["workload"] == "kmerize_shard_sensitivity")
    assert sens["second_round_overhead"] > 0
    assert len(sens["load_sweep"]) == 5      # 4x 2x 1x 1/2 1/4
    e2e = next(r for r in recs if r["workload"] == "kmerize_e2e")
    assert e2e["bases"] > 0 and e2e["unique"] > 0


def test_all_runs_the_jax_harness_workloads_in_its_order(recs):
    """``all`` is every workload but setops-sort, in the JAX harness's
    order (one scaling row on the CPU's one slot)."""
    assert [(r["workload"], r.get("impl")) for r in recs] == [
        ("kmerize", None), ("setops_merge", "auto"), ("scan", None),
        ("scan_shard_model", None), ("setops_shard_model", None),
        ("kmerize_scaling", None), ("kmerize_shard_model", None),
        ("kmerize_shard_sensitivity", None), ("kmerize_sustained", None),
        ("host_parse_gz", None), ("kmerize_e2e", None)]


def test_records_name_the_cpu_and_launch_no_kernel(recs):
    """On the CPU every wrapper runs its plain version: no launch."""
    assert all(r["device"] == "cpu" and r["launches"] == {} for r in recs)


# differences of two times, clamped at 0 as in the JAX harness
CLAMPED = ("t_receive_tree8_fused_dedup_s", "t_acc_amortized8_s")


def test_times_and_rates_are_positive(recs):
    for r in recs:
        for key, v in r.items():
            if key.endswith(("_s", "seconds", "per_s")) and v is not None:
                assert np.isfinite(v), (r["workload"], key, v)
                assert v >= 0 if key in CLAMPED else v > 0, (key, v)


def test_d8_terms_run_off_pallas_too(recs):
    """The D=8 receive-tree terms and the sustained term always run (the
    JAX harness runs them only under Pallas)."""
    scan = next(r for r in recs if r["workload"] == "scan_shard_model")
    model = next(r for r in recs if r["workload"] == "kmerize_shard_model")
    assert scan["t_probe_tree8_s"] > 0
    for key in ("t_receive_tree8_fused_dedup_s", "t_acc_amortized8_s",
                "sustained_per_batch_s", "t_chip_model8_s",
                "host8_bases_per_s_at_0.8_eff"):
        assert key in model
    assert "t_step_nodedup_s" not in model and model["t_step_s"] > 0


def test_scan_shard_model_states_the_port_s_exchange_bytes(recs):
    """``alltoall_bytes_per_chip`` keeps the JAX count, 12 B a k-mer (held
    equal to the JAX record in test_torch_bench_parity.py); the port's
    exchange ships an int64 key and an int64 row id a k-mer, 16 B, under
    ``alltoall_bytes_per_chip_port``, a key with no JAX counterpart."""
    scan = next(r for r in recs if r["workload"] == "scan_shard_model")
    assert scan["alltoall_bytes_per_chip"] == scan["kmers_probed"] * 12
    assert scan["alltoall_bytes_per_chip_port"] == scan["kmers_probed"] * 16
    assert "alltoall_bytes_per_chip_port" not in TH.COUNT_KEYS


def test_setops_sort_is_its_own_workload():
    (rec,) = run_port("setops-sort")
    assert rec["workload"] == "setops_merge" and rec["impl"] == "sort"
    assert rec["n"] == 2 * SMALL["setops_n"]


@pytest.mark.parametrize("kind", ["uniform", "coverage"])
def test_fixture_codes_match_jax(kind):
    jfx = JH._Fixture(kind, total_bases=1 << 22)
    tfx = TH._Fixture(kind, total_bases=1 << 22)
    if kind == "coverage":
        assert np.array_equal(jfx.genome, tfx.genome)
    for reads, length in ((64, 256), (33, 100)):
        a, b = jfx.codes(reads, length), tfx.codes(reads, length)
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


def test_synth_codes_match_jax():
    a = JH._synth_codes(np.random.default_rng(7), 50, 96)
    b = TH._synth_codes(np.random.default_rng(7), 50, 96)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def _bench_parser(build):
    sub = next(a for a in build()._actions
               if a.dest == "command").choices["bench"]
    return {a.dest: (a.default, a.choices) for a in sub._actions
            if a.dest != "help"}


def test_cli_flags_are_zotpu_bench_s_plus_device():
    jax_flags, port_flags = (_bench_parser(jcli.build_parser),
                             _bench_parser(tcli.build_parser))
    assert port_flags.pop("device") == ("cuda", ("cuda", "cpu"))
    assert port_flags == jax_flags
    assert len(port_flags["workload"][1]) == 13


def test_cli_bench_on_the_cpu_prints_one_line(capsys):
    rc = tcli.main(["bench", "--device", "cpu", "--workload", "kmerize",
                    "--bases", str(1 << 15), "--k", "15", "--repeats", "1"])
    assert rc == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(line)
    assert rec["workload"] == "kmerize" and rec["bases"] == 1 << 15
    assert rec["device"] == "cpu"


def test_cli_bench_cuda_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tcli.main(["bench", "--workload", "kmerize"]) == 1
    assert "--device cuda needs a CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("fn", [TPD.panel_to_device,
                                TA.DeviceAccumulator.__init__])
def test_device_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_micro_rows_run_on_the_cpu():
    """The micro-benchmark's rows, as callables, on a tiny size: each
    computes what its name says (timing them needs a card)."""
    fns, reads, m = micro.rows(12, torch.device("cpu"))
    assert list(fns) == ["pack", "sort_i64", "sort+dedup", "scatter",
                         "gather", "cumsum_i32"]
    assert m == reads * (micro.READ_LEN - micro.K + 1)
    assert fns["pack"][0]().shape == (m,)
    keys, counts, n = fns["sort+dedup"][0]()
    assert int(counts[:int(n)].sum()) == m        # every window is valid
    sort = fns["sort_i64"][0]().values
    assert torch.equal(fns["gather"][0](), fns["scatter"][0]())
    assert bool((sort[1:] >= sort[:-1]).all())


def test_micro_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert micro.main(["10"]) == 1
    assert "need a CUDA device" in capsys.readouterr().err
