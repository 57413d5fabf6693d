"""The port's performance harness against the JAX package's, workload by
workload, both on the CPU at tiny sizes: every key of the JAX record (under
``harness.RENAMED_KEYS``) is in the port's record, and every count that
does not depend on time is equal. Each harness runs each workload once per
module. The e2e workload, the slowest on the CPU, is in
test_torch_bench_e2e.py."""

import contextlib
import io
import json
from types import SimpleNamespace

import pytest

from zotpu.bench import harness as JH
from zotpu_torch.bench import harness as TH

SMALL = dict(bases=1 << 16, k=15, repeats=1, setops_n=1 << 12,
             scan_reads=1 << 8, scan_panel=1 << 10)
PARITY = [w for w in TH.WORKLOADS if w != "e2e"]


def records(harness, workload, **extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert harness.run(SimpleNamespace(workload=workload, **SMALL,
                                           **extra)) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def assert_port_matches_jax(jax_recs, port_recs):
    """Every port record against the JAX record of the same mesh size:
    the JAX keys (renamed) are present and the counts are equal. The JAX
    suite has 8 fake devices, so its scaling workload has more rows than
    the port's one CPU slot; the rows both produce are compared."""
    by_devices = {r.get("devices"): r for r in jax_recs}
    assert port_recs and len(by_devices) == len(jax_recs)
    for port in port_recs:
        jax = by_devices[port.get("devices")]
        missing = {TH.RENAMED_KEYS.get(key, key) for key in jax} - set(port)
        assert not missing, (port["workload"], missing)
        for key in TH.COUNT_KEYS:
            assert jax.get(key) == port.get(key), (port["workload"], key)
        if "load_sweep" in jax:
            assert ([p["bases"] for p in jax["load_sweep"]]
                    == [p["bases"] for p in port["load_sweep"]])


@pytest.fixture(scope="module")
def jax_records():
    return {w: records(JH, w) for w in PARITY}


@pytest.fixture(scope="module")
def port_records():
    return {w: records(TH, w, device="cpu") for w in PARITY}


@pytest.mark.parametrize("workload", PARITY)
def test_port_record_matches_jax(workload, jax_records, port_records):
    assert_port_matches_jax(jax_records[workload], port_records[workload])


def test_scan_and_its_shard_model_count_the_same_hits(port_records):
    (scan,) = port_records["scan"]
    (shard,) = port_records["scan-shard-model"]
    assert scan["total_hits"] == shard["total_hits"] > 0
