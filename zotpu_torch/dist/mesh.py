"""The device mesh of the sharded paths: D device slots driven from one
process.

Port of zotpu/dist/mesh.py for a single controller, the counterpart of
JAX's single-controller ``shard_map`` over a 1-D ``shards`` axis. The
k-mer key space is partitioned over the slots by key prefix or by a mixed
hash (dist/shuffle.py). A slot is a torch device; several slots may name
one device, as the JAX tests place 8 fake host devices on one CPU: the
slots then run one after another on that device's current stream.

The mesh provides the two collectives the step bodies use:

- ``all_to_all``: slot i's (D, C) send buffer row j goes to slot j, which
  receives the (D * C,) concatenation of every sender's row in sender
  order (``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``);
- ``psum``: the sum over slots, replicated on every slot.

Multi-controller runs on ``torch.distributed`` (NCCL) are not yet ported.
"""

from __future__ import annotations

import math

import torch


def shard_bits(n_shards: int) -> int:
    """log2(n_shards): number of leading key bits that select the owner."""
    p = int(math.log2(n_shards)) if n_shards > 0 else -1
    if p < 0 or (1 << p) != n_shards:
        raise ValueError(f"n_shards must be a power of two, got {n_shards}")
    return p


class Mesh:
    """D device slots (a power of two) of one process."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        n = len(self.devices)
        if n == 0 or n & (n - 1):
            raise ValueError(f"device count must be a power of two, got {n}")
        self.shared = len(set(self.devices)) == 1

    @property
    def size(self) -> int:
        return len(self.devices)

    def all_to_all(self, sends):
        """sends[i]: (D, C) tensor on slot i -> recv[j]: (D * C,) on slot j,
        sender i's row j at [i * C, (i + 1) * C)."""
        D = self.size
        if self.shared:  # one device: a stack and a transpose
            return list(torch.stack(sends).transpose(0, 1).reshape(D, -1))
        C = sends[0].shape[1]
        recv = []
        for j, dev in enumerate(self.devices):
            buf = torch.empty(D * C, dtype=sends[0].dtype, device=dev)
            for i in range(D):
                buf[i * C:(i + 1) * C].copy_(sends[i][j], non_blocking=True)
            recv.append(buf)
        return recv

    def psum(self, xs):
        """Per-slot tensors of one shape -> their sum on every slot."""
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        if self.shared:
            return [total] * self.size
        return [total.to(d) for d in self.devices]


def make_mesh(n_devices: int | None = None, device="cuda",
              devices=None) -> Mesh:
    """A mesh of n slots: ``cuda:0 .. cuda:n-1`` on ``cuda`` (n defaults to
    every visible card), or n CPU slots on ``cpu``. An explicit
    ``devices`` list places the slots as given, for instance D slots on one
    card."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"{n_devices} slots requested but "
                             f"{len(devices)} devices given")
        return Mesh(devices)
    dev = torch.device(device)
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        n = n_devices or avail
        if n & (n - 1):
            raise ValueError(f"device count must be a power of two, got {n}")
        if n > avail:
            raise ValueError(f"requested a {n}-device mesh but only {avail} "
                             f"device(s) are visible")
        return Mesh([f"cuda:{i}" for i in range(n)])
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return Mesh(["cpu"] * (n_devices or 1))
