"""The benchmark of zotpu_torch: one command runs one cell once.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` and found by name under this directory: a
configuration in ``configs/<config>.json``, a traffic mix in
``traffic/<mix>.json`` (its ``job`` names ``jobs/<job>.py``), and each
metric in ``metrics/<metric>.py``. Nothing here imports JAX or the JAX
package ``zotpu``.
"""
