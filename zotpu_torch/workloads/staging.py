"""The copies between the host and the devices, for every workload: a
``Stager`` a device (``Stagers`` over a mesh's slots), and ``to_host``.
"""

from __future__ import annotations

import torch

from zotpu_torch import metrics


class Stager:
    """The host<->device copies of one device: on CUDA an upload runs from
    pinned memory on a copy stream of the stager's own, so it overlaps the
    device's work; on the CPU tensors are copied or handed back as they
    are."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def upload(self, host):
        """Start copying host tensors to the device on the copy stream (on
        the CPU they are returned as they are). Counts their bytes as
        ``h2d.bytes``."""
        if metrics.tracing():
            metrics.count("h2d.bytes", sum(t.nbytes for t in host))
        with metrics.span("upload"):
            if self.stream is None:
                return tuple(t.to(self.device) for t in host)
            with torch.cuda.stream(self.stream):
                return tuple(t.to(self.device, non_blocking=True)
                             for t in host)

    def wait(self, tensors) -> None:
        """Make the device's compute stream wait for an upload."""
        if self.stream is None:
            return
        with metrics.span("upload"):
            compute = torch.cuda.current_stream(self.device)
            compute.wait_stream(self.stream)
            for t in tensors:
                t.record_stream(compute)

    def download(self, t):
        """Start copying a device tensor into pinned host memory, behind the
        work queued on the compute stream; returns the host tensor and an
        event to wait on (the tensor itself and None on the CPU)."""
        if not t.is_cuda:
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        return host, done


class Stagers:
    """Per-slot uploads of a batch's host tensors over ``mesh``: slot d
    takes rows [d * R, (d + 1) * R) of each, through the stager of its
    device (slots on one device share it)."""

    def __init__(self, mesh, rows_per_slot: int):
        self.rows = rows_per_slot
        by_device = {dev: Stager(dev) for dev in mesh.devices}
        self.slots = [by_device[dev] for dev in mesh.devices]

    def upload(self, host):
        R = self.rows
        return [s.upload(tuple(t[d * R:(d + 1) * R] for t in host))
                for d, s in enumerate(self.slots)]

    def wait(self, slots) -> None:
        for ts, s in zip(slots, self.slots):
            s.wait(ts)


def to_host(parts):
    """Copy device tensors to the host, CUDA ones into one pinned buffer
    (a slice each) behind one synchronize of each device; returns host
    tensors."""
    devices = {t.device for t in parts if t.is_cuda}
    if not devices:
        return [t.cpu() for t in parts]
    buf = torch.empty(sum(t.shape[0] for t in parts), dtype=torch.int64,
                      pin_memory=True)
    out, off = [], 0
    for t in parts:
        out.append(buf[off:off + t.shape[0]])
        out[-1].copy_(t, non_blocking=True)
        off += t.shape[0]
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out
