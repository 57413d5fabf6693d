"""The port's e2e bench workload against the JAX harness's, both on the
CPU at a tiny size (the JAX one alone takes about 35 s here, so it has a
file of its own): the same keys and the same input bases and unique
k-mers, and the port's run through the CLI."""

import json

import pytest

from zotpu.bench import harness as JH
from zotpu_torch.bench import harness as TH
from test_torch_bench_parity import assert_port_matches_jax, records


@pytest.fixture(scope="module")
def pair():
    return records(JH, "e2e"), records(TH, "e2e", device="cpu")


def test_e2e_record_matches_jax(pair):
    assert_port_matches_jax(*pair)


def test_e2e_counts_every_base_of_the_fixture(pair):
    """512 reads of 128 bases, every base counted once, and a set that is
    not empty, in both packages."""
    (jax,), (port,) = pair
    assert port["bases"] == jax["bases"] == 1 << 16
    assert port["unique"] == jax["unique"] > 0
