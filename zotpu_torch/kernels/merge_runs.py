"""K5 and K7: merge passes over sorted int64 runs, with an optional int64
payload channel.

Port of the Pallas kernels ``sort_pallas.tree_merge_pass_alt`` /
``tree_merge_pair_alt`` (K5, the sharded kmerize receive tree) and
``sort_pallas.stream_merge_pass_pallas`` / ``stream_merge_pair_pallas``
(K7, the sharded pulldown's row-id payload tree), behind one CUDA kernel
(csrc/merge_runs.cu: a partition kernel for the tile boundaries of every
pair, then tiles of 2,048 elements merged 8 items a thread in registers).
Every run is ascending: the TPU's alternating
direction (odd runs stored descending, ``_route(reverse_odd=True)``)
served its bitonic network and is not kept. Capacities need not be
multiples of a tile.

- ``merge_runs_pass(keys, pay, run)``: sorted runs of length ``run`` (the
  length a multiple of 2 * run) become sorted runs of 2 * run;
- ``merge_runs_pair(keys, pay, nA)``: A = [:nA] and B = [nA:] become one
  sorted run.

A comes first on equal keys, and the payload rides with its key; ``pay``
may be None. The JAX network was not stable, so its payloads may come out
in another order within an equal-key segment: compare (key, payload) as a
multiset there. On a CPU tensor the wrapper runs the plain version (a
stable ``torch.sort`` of each pair); on a CUDA tensor it launches the
kernel or raises. ``KEYS_ONLY`` (K5) and ``WITH_PAYLOAD`` (K7) count the
launches without and with a payload. A K5 call counts its slots as
``tree.k5_slots`` (metrics.count): it reads and writes each once, sentinel
pads included.
"""

from __future__ import annotations

import torch

from zotpu_torch import _build, metrics


class Launches:
    """Launch count of one kernel that several wrappers share."""

    def __init__(self):
        self.launches = 0


KEYS_ONLY = Launches()      # K5
WITH_PAYLOAD = Launches()   # K7


def merge_plain(keys, pay, pair_len: int, a_len: int):
    """Plain PyTorch version (any device): each pair of pair_len elements,
    A = [:a_len] then B, sorted stably, so A stays first on ties."""
    n = keys.shape[0]
    if n == 0:
        return keys.clone(), None if pay is None else pay.clone()
    k, order = torch.sort(keys.view(n // pair_len, pair_len), dim=1,
                          stable=True)
    if pay is None:
        return k.reshape(-1), None
    return k.reshape(-1), torch.gather(pay.view(k.shape), 1,
                                       order).reshape(-1)


def _check(keys, pay):
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"keys must be 1-D int64, got {tuple(keys.shape)} "
                         f"{keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if pay is not None:
        if pay.dtype != torch.int64 or pay.shape != keys.shape:
            raise ValueError(f"payload must be int64 of the keys' shape, "
                             f"got {tuple(pay.shape)} {pay.dtype}")
        if pay.device != keys.device or not pay.is_contiguous():
            raise ValueError("payload must be contiguous on the keys' device")


def _merge(keys, pay, pair_len: int, a_len: int):
    _check(keys, pay)
    if pay is None:
        metrics.count("tree.k5_slots", keys.shape[0])
    if keys.device.type == "cpu":
        return merge_plain(keys, pay, pair_len, a_len)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    n = keys.shape[0]
    out_k = torch.empty_like(keys)
    out_p = None if pay is None else torch.empty_like(pay)
    if n == 0:
        return out_k, out_p
    scratch = torch.empty(
        _build.lib().zt_merge_runs_scratch_elems(n, pair_len),
        dtype=torch.int64, device=keys.device)
    _build.launch(keys.device, "zt_merge_runs", keys.data_ptr(),
                  None if pay is None else pay.data_ptr(), n, pair_len,
                  a_len, out_k.data_ptr(),
                  None if out_p is None else out_p.data_ptr(),
                  scratch.data_ptr())
    (KEYS_ONLY if pay is None else WITH_PAYLOAD).launches += 1
    return out_k, out_p


def merge_runs_pass(keys, pay, run: int):
    """Sorted runs of ``run`` -> sorted runs of 2 * run; returns (keys,
    payload or None)."""
    n = keys.shape[0]
    if run < 1 or n % (2 * run):
        raise ValueError(f"length {n} is not a multiple of 2 * run "
                         f"(run={run})")
    return _merge(keys, pay, 2 * run, run)


def merge_runs_pair(keys, pay, nA: int):
    """Sorted A = [:nA] and B = [nA:] -> one sorted run; returns (keys,
    payload or None)."""
    n = keys.shape[0]
    if not 0 <= nA <= n:
        raise ValueError(f"nA={nA} outside [0, {n}]")
    return _merge(keys, pay, max(n, 1), nA)
