"""Device-resident LSM merge accumulators for streaming kmerize.

Port of zotpu/workloads/accumulator.py ``DeviceAccumulator`` and, for the
sharded path, ``ShardedAccumulator`` (one DeviceAccumulator a slot). Level
i holds at most one run of capacity ``min(base_cap << i, max_cap)``. A new
run enters level 0; while a level is occupied the two runs merge through
the fused set-op kernel (op="merge", counts saturate) and carry to the next
level, so each key is merged O(log B) times over B batches. Every run is
dense, so every merge takes the fused kernel with the valid counts passed
as device tensors; nothing synchronizes with the host until ``result()``.
Capacity overflow accumulates in a device tensor and raises
``CapacityError`` there.

``CapacityError`` is raised iff the final unique count exceeds
``max(max_cap, base_cap)``: an intermediate merge holds a subset of the final
keys, and merges below the clamp cannot overflow (two level-i runs fit
level i+1). Unlike the JAX package, ``base_cap`` is the run capacity itself,
not rounded to a TPU tile.
"""

from __future__ import annotations

import numpy as np
import torch

from zotpu_torch import keys as K
from zotpu_torch.kernels.merge_fused import set_op_fused
from zotpu_torch.workloads.staging import to_host


class CapacityError(ValueError):
    pass


class DeviceAccumulator:
    def __init__(self, batch_capacity: int, max_cap: int = 1 << 26,
                 device="cuda"):
        self.base_cap = batch_capacity
        self.max_cap = max(max_cap, self.base_cap)
        self.overflow = torch.zeros((), dtype=torch.int64, device=device)
        # levels[i] = (keys, counts, n) with n a 0-d device tensor, or None
        self.levels: list = []

    def _cap(self, i: int) -> int:
        return min(self.base_cap << i, self.max_cap)

    def add(self, keys, counts, n) -> None:
        """Insert one dense sorted unique run (device tensors, n a 0-d
        int64 tensor). No host synchronization happens here."""
        cap0 = self._cap(0)
        if keys.shape[0] > cap0:
            raise ValueError(
                f"run capacity {keys.shape[0]} exceeds the accumulator's "
                f"level-0 capacity {cap0}; construct DeviceAccumulator with "
                f"batch_capacity >= the largest run")
        if keys.shape[0] < cap0:
            pad = cap0 - keys.shape[0]
            keys = torch.cat([keys, keys.new_full((pad,), K.SENTINEL)])
            counts = torch.cat([counts, counts.new_zeros(pad)])
        entry = (keys, counts, n)
        i = 0
        while True:
            if len(self.levels) <= i:
                self.levels.append(None)
            if self.levels[i] is None:
                self.levels[i] = entry
                return
            other = self.levels[i]
            self.levels[i] = None
            entry = self._merge(entry, other, self._cap(i + 1))
            i += 1

    def _merge(self, a, b, out_cap: int):
        """Merge two entries; the output is cut to out_cap only where the
        max_cap clamp makes it shorter than len(A) + len(B) (a view, no
        copy). out_cap is the overflow threshold either way."""
        keys, counts, n = set_op_fused(a[0], a[1], b[0], b[1], op="merge",
                                       n_a=a[2], n_b=b[2])
        self.overflow = torch.maximum(self.overflow, n - out_cap)
        if keys.shape[0] > out_cap:
            keys, counts = keys[:out_cap], counts[:out_cap]
        return keys, counts, n

    def final(self):
        """Merge the remaining levels into one entry (keys, counts, n), or
        None when nothing was added. No host synchronization."""
        entry = None
        cap_final = self._cap(len(self.levels))
        for lvl in self.levels:
            if lvl is None:
                continue
            entry = lvl if entry is None else self._merge(entry, lvl,
                                                          cap_final)
        return entry

    def result(self):
        """Merge the remaining levels, check the deferred overflow, and copy
        the dense prefix to the host: the single host sync of the run.
        Returns (u64 keys, u32 counts) numpy arrays."""
        entry = self.final()
        if entry is None:
            return K.to_numpy_set(torch.empty(0, dtype=torch.int64),
                                  torch.empty(0, dtype=torch.int64), 0)
        overflow, n = torch.stack([self.overflow, entry[2]]).tolist()
        if overflow > 0:
            raise CapacityError(
                f"accumulator overflowed its unique-key capacity by "
                f"{overflow}; rerun with a larger --merge-capacity")
        keys, counts = to_host([entry[0][:n], entry[1][:n]])
        return K.to_numpy_set(keys, counts, n)


class ShardedAccumulator:
    """Per-slot LSM accumulator of the sharded kmerize path.

    Port of zotpu/workloads/accumulator.py ``ShardedAccumulator``: each of
    this process's slots runs its own DeviceAccumulator on its device, with
    every level merge on K3 with device valid counts. Slot key ranges are
    disjoint, so slots never merge with each other. Nothing synchronizes
    with the host until ``result()``, which checks the deferred overflow of
    every slot with one read and copies the dense prefixes into one pinned
    buffer; with a multi-controller ``mesh`` it first gathers every
    process's slots, so that every process returns the global result.

    ``max_cap`` is the global unique-key capacity; each slot gets
    ``max(max_cap // D, batch_capacity)``, D the mesh's global slot count
    (``len(devices)`` without a mesh). ``CapacityError`` follows the port's
    rule (DeviceAccumulator): it is raised iff a slot's final unique count
    exceeds that, with ``batch_capacity`` the step's run capacity itself,
    not rounded up to a TPU tile as in the JAX package."""

    def __init__(self, devices, batch_capacity: int, max_cap: int = 1 << 26,
                 mesh=None):
        self.mesh = mesh
        D = mesh.size if mesh is not None else len(devices)
        per_slot = max(max_cap // D, batch_capacity)
        self.slots = [DeviceAccumulator(batch_capacity, max_cap=per_slot,
                                        device=dev) for dev in devices]

    def add(self, runs) -> None:
        """Insert one dense (keys, counts, n) run per slot."""
        for acc, (keys, counts, n) in zip(self.slots, runs):
            acc.add(keys, counts, n)

    def result(self):
        """Per-slot (int64 keys, int64 counts, n) numpy arrays of all D
        global slots, the layout of dist.shuffle.gather_global."""
        multi = self.mesh is not None and self.mesh.multi
        D = self.mesh.size if multi else len(self.slots)
        entries = [acc.final() for acc in self.slots]
        if entries[0] is None:      # add() fills every slot, or none
            z = np.zeros(0, np.int64)
            return [z] * D, [z] * D, [0] * D
        dev0 = entries[0][2].device
        stats = torch.stack([torch.stack([acc.overflow, e[2]]).to(dev0)
                             for acc, e in zip(self.slots, entries)])
        if multi:
            stats = self.mesh.allgather(stats)
        stats = stats.tolist()
        for d, (overflow, _) in enumerate(stats):
            if overflow > 0:
                raise CapacityError(
                    f"sharded accumulator overflowed its per-shard "
                    f"unique-key capacity by {overflow} (shard {d}); rerun "
                    f"with a larger --merge-capacity")
        ns = [n for _, n in stats]
        if multi:   # the local dense prefixes, gathered on the device
            local = ns[self.mesh.first:self.mesh.first + len(entries)]
            parts = [self.mesh.allgather(torch.cat([e[i][:n] for e, n in
                                                    zip(entries, local)]))
                     for i in (0, 1)]
        else:
            parts = ([e[0][:n] for e, n in zip(entries, ns)]
                     + [e[1][:n] for e, n in zip(entries, ns)])
        host = [t.numpy() for t in to_host(parts)]
        if multi:
            cuts = np.cumsum(ns)[:-1]
            host = np.split(host[0], cuts) + np.split(host[1], cuts)
        return host[:D], host[D:], ns
