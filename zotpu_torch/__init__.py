"""zotpu_torch: the PyTorch/CUDA port of zotpu for NVIDIA Hopper (H100).

It stands alone: it imports neither JAX nor the JAX package ``zotpu``, and
keeps its own copies of the host-only modules it needs (semantics, golden
reference, FASTQ parsing, containers, the wire pack, variants, stats).
"""

__version__ = "0.1.0"
