"""zotpu_torch: the PyTorch/CUDA port of zotpu for NVIDIA Hopper (H100).

It shares the JAX package's host-only modules (semantics, golden reference,
FASTQ parsing, containers, the wire pack) and imports no JAX.
"""

__version__ = "0.1.0"
