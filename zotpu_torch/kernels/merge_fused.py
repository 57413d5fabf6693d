"""K3: fused sorted set operation (merge + combine + compact).

Port of the Pallas kernel zotpu/kernels/merge_fused.py ``set_op_fused``;
its plain version follows ``setops.set_op`` (sort the concatenation,
combine neighbours, compact). ``setops_merge.set_op_merge_path`` is not
ported: ``set_op_fused`` supersedes it.

Inputs are DENSE sorted unique int64 key arrays with int64 counts and a
sentinel tail. Ops (semantics.py count policy, ``_combine_policy``):

- ``merge`` / ``union``: every key, counts summed (saturating at COUNT_MAX);
- ``intersect``: keys on both sides, counts summed;
- ``diff``: keys only in A, with A's count.

``n_a`` / ``n_b`` (optional 0-d int64 tensors on the inputs' device) are the
valid-prefix lengths: the kernel reads them on the device (no host sync) and
does no work past ``n_a + n_b``. Output capacity is len(A) + len(B);
``n_out`` is a 0-d int64 tensor.

The output contract: ``out[:n_out]`` is the dense result, the same with or
without the valid counts. What lies at or past ``n_out`` depends on how the
caller works. A caller that gives both ``n_a`` and ``n_b`` works with valid
counts (the accumulator's next merge reads ``[:n]``, ``result()`` copies
``[:n]``), so nothing reads those slots and on a CUDA tensor they are left
unwritten: treat them as unspecified. A caller that leaves a count out
works with whole sentinel-tailed arrays and may pass the output on the
same way, so every slot at or past ``n_out`` then holds SENTINEL / 0. The
plain version fills the tail with SENTINEL / 0 in both cases, which meets
either contract.
"""

from __future__ import annotations

import torch

from zotpu_torch import _build
from zotpu_torch.keys import COUNT_MAX, SENTINEL

OPS = {"merge": 0, "union": 0, "intersect": 1, "diff": 2}


def _prefix(x, n):
    return x if n is None else x[:max(int(n), 0)]


def set_op_plain(ka, ca, kb, cb, op: str = "merge", n_a=None, n_b=None):
    """Plain PyTorch version of set_op_fused (any device)."""
    code = OPS[op]
    cap = ka.shape[0] + kb.shape[0]
    ka, ca = _prefix(ka, n_a), _prefix(ca, n_a)
    kb, cb = _prefix(kb, n_b), _prefix(cb, n_b)
    if code == 2:
        cb = torch.zeros_like(cb)       # presence in A == count > 0
    keys, order = torch.sort(torch.cat([ka, kb]), stable=True)  # A first
    c = torch.cat([ca, cb])[order]
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    same_next = torch.zeros_like(first)
    same_next[:-1] = ~first[1:]
    next_c = torch.zeros_like(c)
    next_c[:-1] = c[1:]
    valid = keys != SENTINEL
    summed = torch.clamp(c + torch.where(same_next, next_c, 0), max=COUNT_MAX)
    if code == 0:
        keep, cnt = first & valid, summed
    elif code == 1:
        keep, cnt = first & valid & same_next, summed
    else:
        keep, cnt = first & valid & ~same_next & (c > 0), c
    n = int(keep.sum())
    out_k = torch.full((cap,), SENTINEL, dtype=torch.int64, device=ka.device)
    out_c = torch.zeros((cap,), dtype=torch.int64, device=ka.device)
    out_k[:n] = keys[keep]
    out_c[:n] = cnt[keep]
    return out_k, out_c, torch.tensor(n, dtype=torch.int64, device=ka.device)


def _check_side(k, c, n, device, name):
    if k.dtype != torch.int64 or c.dtype != torch.int64:
        raise ValueError(f"{name}: keys and counts must be int64")
    if k.dim() != 1 or c.shape != k.shape:
        raise ValueError(f"{name}: keys {tuple(k.shape)} and counts "
                         f"{tuple(c.shape)} must be 1-D of one length")
    if k.device != device or c.device != device:
        raise ValueError(f"{name}: all inputs must be on one device")
    if not (k.is_contiguous() and c.is_contiguous()):
        raise ValueError(f"{name}: keys and counts must be contiguous")
    if n is not None and not (isinstance(n, torch.Tensor)
                              and n.dtype == torch.int64 and n.numel() == 1
                              and n.device == device):
        raise ValueError(f"n_{name}: must be a 1-element int64 tensor on "
                         f"{device}")


def set_op_fused(ka, ca, kb, cb, op: str = "merge", n_a=None, n_b=None):
    """Two dense sorted unique (keys, counts) sets -> dense (keys, counts,
    n_out) of capacity len(A) + len(B). Only ``[:n_out]`` is defined when
    both valid counts are given; without one of them the tail is SENTINEL
    / 0 (see the module docstring)."""
    if op not in OPS:
        raise ValueError(f"unknown set op {op!r}")
    device = ka.device
    _check_side(ka, ca, n_a, device, "a")
    _check_side(kb, cb, n_b, device, "b")
    if device.type == "cpu":
        return set_op_plain(ka, ca, kb, cb, op, n_a, n_b)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    MA, MB = ka.shape[0], kb.shape[0]
    if MA + MB == 0:
        return ka.new_empty(0), ca.new_empty(0), ka.new_zeros(())
    out_k = torch.empty(MA + MB, dtype=torch.int64, device=device)
    out_c = torch.empty(MA + MB, dtype=torch.int64, device=device)
    n_out = torch.empty((), dtype=torch.int64, device=device)
    lib = _build.lib()
    scratch = torch.empty(lib.zt_set_op_scratch_elems(MA, MB),
                          dtype=torch.int64, device=device)
    _build.launch(device, "zt_set_op", OPS[op], ka.data_ptr(), ca.data_ptr(),
                  MA, None if n_a is None else n_a.data_ptr(),
                  kb.data_ptr(), cb.data_ptr(), MB,
                  None if n_b is None else n_b.data_ptr(), out_k.data_ptr(),
                  out_c.data_ptr(), n_out.data_ptr(), scratch.data_ptr())
    set_op_fused.launches += 1
    return out_k, out_c, n_out


set_op_fused.launches = 0
