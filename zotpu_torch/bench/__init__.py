"""The port's performance harness (``python -m zotpu_torch bench``) and
its micro-benchmarks (``python -m zotpu_torch.bench.micro``)."""
