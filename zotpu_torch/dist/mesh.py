"""The device mesh of the sharded paths: D device slots, driven from one
process or from P processes on ``torch.distributed``.

Port of zotpu/dist/mesh.py, the counterpart of JAX's ``shard_map`` over a
1-D ``shards`` axis. The k-mer key space is partitioned over the slots by
key prefix or by a mixed hash (dist/shuffle.py). A slot is a torch device;
several slots may name one device, as the JAX tests place 8 fake host
devices on one CPU: the slots then run one after another on that device's
current stream.

Single controller (no process group): the mesh's slots are all this
process's, and a slot may sit on any device. Multi-controller (the layout
of a run over ``init_distributed``): one process per device, each holding
L slots on its device, D = P * L in all; process p owns the global slots
p * L .. p * L + L - 1, contiguous and ascending with the process index, so
prefix-sharded results concatenate sorted in process order.

The mesh provides the collectives the step bodies and workloads use:

- ``all_to_all``: slot i's (D, C) send buffer row j goes to slot j, which
  receives the (D * C,) concatenation of every sender's row in global
  sender order (``lax.all_to_all(split_axis=0, concat_axis=0,
  tiled=True)``); across processes one ``all_to_all_single``;
- ``psum``: the sum over all D slots, replicated on every local slot (a
  local sum, then ``all_reduce``); ``allreduce`` reduces one tensor over
  the processes (sum, max or min);
- ``allgather``: every process's tensor, of any length, concatenated in
  process order on every process (``process_allgather(tiled=True)``).

Every exchanged tensor is int64 or int32 (gloo refuses uint64). The bytes
this process sends to other processes are counted (``sent_bytes``), and
apart from them the all-to-all rows each slot addresses to another slot,
in any process or on any device (``slot_bytes``: the exchange's volume,
which a single controller moves without a process boundary).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

_SENT = {"bytes": 0, "slot_bytes": 0}


def sent_bytes() -> int:
    """Bytes this process has sent to other processes through a mesh's
    collectives since the last ``reset_sent_bytes``."""
    return _SENT["bytes"]


def slot_bytes() -> int:
    """Bytes of the all-to-all rows that this process's slots addressed to
    other slots since the last ``reset_sent_bytes``."""
    return _SENT["slot_bytes"]


def reset_sent_bytes() -> None:
    _SENT["bytes"] = _SENT["slot_bytes"] = 0


def shard_bits(n_shards: int) -> int:
    """log2(n_shards): number of leading key bits that select the owner."""
    p = int(math.log2(n_shards)) if n_shards > 0 else -1
    if p < 0 or (1 << p) != n_shards:
        raise ValueError(f"n_shards must be a power of two, got {n_shards}")
    return p


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device="cuda", backend: str | None = None
                     ) -> torch.device:
    """Join the process group of a multi-controller run and return the
    device this process drives: ``cuda:{process_id % device_count}`` for
    a CUDA device (made the current device), else the CPU.

    ``init_process_group`` gets ``tcp://COORDINATOR`` (process 0's
    HOST:PORT), the world size and the rank. The backend is NCCL for a CUDA
    device and gloo for the CPU unless ``backend`` names one: NCCL refuses
    two ranks on one card, so processes that share a card pass
    ``backend="gloo"``. A group that exists already (made by the caller) is
    used as it is when its size and rank agree. A failed init raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        have = (dist.get_world_size(), dist.get_rank())
        if have != (num_processes, process_id):
            raise ValueError(
                f"the process group has size {have[0]} and rank {have[1]}, "
                f"not --num-processes {num_processes} --process-id "
                f"{process_id}")
        return dev
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)
    return dev


class Mesh:
    """D device slots (a power of two): this process's ``devices`` (L
    slots), times the P processes of ``group`` when one is given (all L
    slots then on one device)."""

    def __init__(self, devices, group=None):
        self.devices = [torch.device(d) for d in devices]
        self.group = group
        self.process_count = (1 if group is None
                              else dist.get_world_size(group))
        self.process_index = 0 if group is None else dist.get_rank(group)
        L = len(self.devices)
        n = L * self.process_count
        if L == 0 or n & (n - 1):
            raise ValueError(f"device count must be a power of two, got {n}")
        self.shared = len(set(self.devices)) == 1
        if self.multi and not self.shared:
            raise ValueError("a process of a multi-controller mesh holds its "
                             "slots on one device")
        self.first = self.process_index * L   # global index of slot 0

    @property
    def size(self) -> int:
        """D, the global slot count."""
        return len(self.devices) * self.process_count

    @property
    def multi(self) -> bool:
        return self.process_count > 1

    @property
    def owners(self) -> tuple:
        """The process index of every global slot."""
        L = len(self.devices)
        return tuple(d // L for d in range(self.size))

    def _count(self, t, share: float) -> None:
        _SENT["bytes"] += int(t.numel() * t.element_size() * share)

    def all_to_all(self, sends):
        """sends[i]: (D, C) tensor on local slot i -> recv[j]: (D * C,) on
        local slot j, global sender s's row for j at [s * C, (s + 1) * C)."""
        D, L = self.size, len(self.devices)
        C = sends[0].shape[1]
        _SENT["slot_bytes"] += (L * D * C * sends[0].element_size()
                                * (D - 1) // D)
        if self.multi:
            P = self.process_count
            # [sender slot, dest process, dest slot] -> dest process first,
            # so that all_to_all_single's P equal chunks are the processes'
            x = torch.stack(sends).reshape(L, P, L, C).permute(
                1, 0, 2, 3).contiguous()
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x, group=self.group)
            self._count(x, (P - 1) / P)
            # y[p, s, j]: process p's slot s's row for local slot j
            return list(y.permute(2, 0, 1, 3).reshape(L, D * C))
        if self.shared:  # one device: a stack and a transpose
            return list(torch.stack(sends).transpose(0, 1).reshape(D, -1))
        recv = []
        for j, dev in enumerate(self.devices):
            buf = torch.empty(D * C, dtype=sends[0].dtype, device=dev)
            for i in range(D):
                buf[i * C:(i + 1) * C].copy_(sends[i][j], non_blocking=True)
            recv.append(buf)
        return recv

    def allreduce(self, t, op: str = "sum"):
        """One tensor reduced over the processes (``sum``, ``max`` or
        ``min``) into a new tensor; the tensor itself on one process."""
        if not self.multi:
            return t
        out = t.clone()
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX,
                                 "min": dist.ReduceOp.MIN}[op],
                        group=self.group)
        self._count(out, 1.0)
        return out

    def psum(self, xs):
        """Per-slot tensors of one shape -> their sum over all D slots on
        every local slot."""
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        total = self.allreduce(total)
        if self.shared:
            return [total] * len(self.devices)
        return [total.to(d) for d in self.devices]

    def allgather(self, x):
        """Every process's tensor (lengths may differ along dim 0, and be
        0) concatenated in process order on every process: the lengths go
        first, then each tensor padded to the longest."""
        if not self.multi:
            return x
        P = self.process_count
        n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        ns = [torch.empty_like(n) for _ in range(P)]
        dist.all_gather(ns, n, group=self.group)
        ns = torch.cat(ns).tolist()
        buf = x.new_zeros((max(max(ns), 1), *x.shape[1:]))
        buf[:x.shape[0]] = x
        outs = [torch.empty_like(buf) for _ in range(P)]
        dist.all_gather(outs, buf, group=self.group)
        self._count(buf, P - 1)
        return torch.cat([o[:m] for o, m in zip(outs, ns)])


def make_mesh(n_devices: int | None = None, device="cuda",
              devices=None) -> Mesh:
    """A single-controller mesh of n slots: ``cuda:0 .. cuda:n-1`` on
    ``cuda`` (n defaults to every visible card), or n CPU slots on ``cpu``.
    An explicit ``devices`` list places the slots as given, for instance D
    slots on one card."""
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


def check_process_shards(n_shards: int, num_processes: int) -> None:
    """The slot count of a multi-controller run: a power of two and a
    multiple of the process count (each process holds n_shards / P)."""
    if n_shards & (n_shards - 1) or n_shards % num_processes or n_shards < 1:
        raise ValueError(f"--shards {n_shards} must be a power of two and a "
                         f"multiple of --num-processes {num_processes}")


def process_mesh(n_shards: int, device) -> Mesh:
    """The mesh of a multi-controller run over the default process group:
    n_shards global slots (``check_process_shards``), n_shards / P of them
    on this process's ``device``."""
    P = dist.get_world_size()
    check_process_shards(n_shards, P)
    return Mesh([device] * (n_shards // P), group=dist.group.WORLD)


def multi_controller() -> bool:
    """True inside a multi-controller run (a process group of two or more
    processes exists): the sharded workloads then build ``process_mesh``."""
    return dist.is_initialized() and dist.get_world_size() > 1
