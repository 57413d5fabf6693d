"""K1: fused tokenize -> 2-bit pack -> canonicalize (one key per k-window).

Port of zotpu/kernels/pack.py ``pack_canonical`` and of the Pallas kernels
``pack_pallas.pack_canonical_pallas`` / ``pack_canonical_wire_pallas`` (and
their dispatch in kernels/dispatch.py). Both entry points return flat int64
keys of length R*(L-k+1) in row-major window order, the sentinel for every
invalid window. The JAX package's derived weight channel ``w`` is not
ported: validity is the sentinel itself, and the sort-dedup drops ``w``.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA tensor
it launches the kernel of csrc/pack.cu or raises.
"""

from __future__ import annotations

import torch

from zotpu import semantics as S
from zotpu_torch import _build
from zotpu_torch.keys import SENTINEL


def _check_rows(lengths, rows, device):
    if lengths.dtype != torch.int32 or lengths.shape != (rows,):
        raise ValueError(f"lengths must be ({rows},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if lengths.device != device or not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous on the codes' device")


def _windows(L: int, k: int) -> int:
    S.check_k(k)
    if k > L:
        raise ValueError(f"k={k} exceeds the row length {L}")
    return L - k + 1


def _as_u32_bits(x):
    """u32 wire words travel as int32 bit patterns (torch's uint32 supports
    few operations); accept either dtype."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype != torch.int32:
        raise ValueError(f"wire words must be uint32 or int32, got {x.dtype}")
    return x


def _launch(wrapper, c_name, ptrs, R, L, k, device):
    """Run one pack kernel (c_name) over R rows of L bases; count it on
    the wrapper."""
    lib = _build.lib()
    if L > lib.zt_pack_max_len():
        raise ValueError(f"row length {L} exceeds the kernel's "
                         f"{lib.zt_pack_max_len()}")
    out = torch.empty(R * (L - k + 1), dtype=torch.int64, device=device)
    if R:
        _build.launch(device, c_name, *ptrs, R, L, k, out.data_ptr())
        wrapper.launches += 1
    return out


def pack_canonical_plain(codes, lengths, k: int):
    """Plain PyTorch version of pack_canonical (any device)."""
    R, L = codes.shape
    m = _windows(L, k)
    c = codes.to(torch.int64)
    b = c & 3
    fwd = torch.zeros((R, m), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        bj = b[:, j:j + m]
        fwd = (fwd << 2) | bj                  # first base most significant
        rc = rc | ((bj ^ 3) << (2 * j))        # complement, reversed order
    canon = torch.minimum(fwd, rc)
    bad = torch.cumsum((c >= S.INVALID_CODE).to(torch.int32), dim=1)
    bad = torch.cat([torch.zeros_like(bad[:, :1]), bad], dim=1)
    clean = bad[:, k:k + m] == bad[:, :m]      # no invalid base in [i, i+k)
    start = torch.arange(m, device=codes.device)
    ok = clean & (start[None, :] + k <= lengths[:, None].to(torch.int64))
    return torch.where(ok, canon, SENTINEL).reshape(-1)


def unpack_wire_plain(packed, mask):
    """Striped wire form (zotpu/io/wire.py) -> (R, L) u8 codes, 4 = invalid."""
    packed, mask = _as_u32_bits(packed), _as_u32_bits(mask)
    W = packed.shape[1]
    L, M = 16 * W, mask.shape[1]
    i = torch.arange(L, device=packed.device)
    words = (packed.to(torch.int64) & 0xFFFFFFFF)[:, i % W]
    c = (words >> (2 * (i // W))) & 3
    mw = (mask.to(torch.int64) & 0xFFFFFFFF)[:, i % M]
    bad = (mw >> (i // M)) & 1
    return torch.where(bad != 0, S.INVALID_CODE, c).to(torch.uint8)


def pack_canonical_wire_plain(packed, mask, lengths, k: int):
    """Plain PyTorch version of pack_canonical_wire (any device)."""
    return pack_canonical_plain(unpack_wire_plain(packed, mask), lengths, k)


def pack_canonical(codes, lengths, k: int):
    """(R, L) u8 codes + (R,) int32 lengths -> flat int64 keys of R*(L-k+1)."""
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be (R, L) uint8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    R, L = codes.shape
    _windows(L, k)
    _check_rows(lengths, R, codes.device)
    if codes.device.type == "cpu":
        return pack_canonical_plain(codes, lengths, k)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    return _launch(pack_canonical, "zt_pack_codes",
                   (codes.data_ptr(), lengths.data_ptr()), R, L, k,
                   codes.device)


def pack_canonical_wire(packed, mask, lengths, k: int):
    """(R, L/16) packed + (R, L/32) mask u32 wire words (io/wire.py) +
    (R,) int32 lengths -> flat int64 keys of R*(L-k+1)."""
    packed, mask = _as_u32_bits(packed), _as_u32_bits(mask)
    if packed.dim() != 2 or mask.dim() != 2:
        raise ValueError("packed and mask must be 2-D")
    R, W = packed.shape
    if W % 2 or mask.shape != (R, W // 2):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not match "
                         f"packed {tuple(packed.shape)} (need (R, W/2), "
                         f"W even)")
    if mask.device != packed.device:
        raise ValueError("packed and mask must be on one device")
    if not (packed.is_contiguous() and mask.is_contiguous()):
        raise ValueError("packed and mask must be contiguous")
    L = 16 * W
    _windows(L, k)
    _check_rows(lengths, R, packed.device)
    if packed.device.type == "cpu":
        return pack_canonical_wire_plain(packed, mask, lengths, k)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    return _launch(pack_canonical_wire, "zt_pack_wire",
                   (packed.data_ptr(), mask.data_ptr(), lengths.data_ptr()),
                   R, L, k, packed.device)


pack_canonical.launches = 0
pack_canonical_wire.launches = 0
