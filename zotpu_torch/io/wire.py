"""Host<->device wire format: 2-bit packed base codes + validity bitmask.

The kmerize/scan pipelines ship read batches to the device as u8 code arrays
(1 byte/base).  On hosts where the H2D link is the end-to-end bottleneck
(PCIe hosts at high aggregate rates)
that byte is 8x wider than the information it carries.  This module packs a
code batch into 0.375 B/base on the host -- 16 codes/u32 word plus a
1-bit/base invalid mask -- and the pack kernel (kernels/pack.py) reads it
on the device.  A copy of zotpu/io/wire.py's host half (``pack_codes``); the
device-side ``unpack_codes`` of the original is jax.numpy and is not
carried, since the port's pack kernel and its plain version read the wire
form themselves.

Wire layout v2, STRIPED (transport only -- no output byte depends on it, so
it lives outside semantics.py). Per row of L codes, W = L/16 code words and
M = L/32 mask words:

- packed[r, w] u32 holds the codes of bases {j*W + w : j in 0..15}, base
  j*W + w at bits 2j..2j+1.
- mask[r, w] u32 holds invalid flags of bases {j*M + w : j in 0..31}, base
  j*M + w at bit j; 1 = invalid.
- Invalid bases are packed as code 0; the mask restores INVALID_CODE on
  unpack, so sentinel-reset semantics are preserved exactly.
- Row length must be a multiple of 32 (batch buffers are padded anyway;
  producers fall back to shipping raw codes otherwise).

Why striped rather than consecutive (v1 packed bases 16w..16w+15 into word
w): the layout was chosen for the JAX package's device, where "base i <-
word i//16" is a cross-lane permutation and the striped form is not. The
port keeps it so that both packages read the same wire bytes; the GPU pack
kernel de-stripes a row once into a linear 2-bit stream in shared memory.
"""

from __future__ import annotations

import numpy as np


def pack_codes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack a (rows, L) u8 code batch -> ((rows, L/16) u32, (rows, L/32) u32).

    Single-pass C++ when the native library is available (the numpy version
    below is slower than the device step it feeds); numpy otherwise. Runs in
    the prefetch thread so it overlaps device compute. L must be a multiple
    of 32.
    """
    rows, L = codes.shape
    if L % 32:
        raise ValueError(f"row length {L} not a multiple of 32")
    from zotpu_torch.io import native
    out = native.pack_wire(codes)
    if out is not None:
        return out
    invalid = codes >= 4
    c = np.where(invalid, 0, codes).astype(np.uint32)
    W, M = L // 16, L // 32
    # base j*W + w -> word w bits 2j: reshape to (rows, 16, W), reduce over j
    c3 = c.reshape(rows, 16, W)
    packed = np.zeros((rows, W), np.uint32)
    for j in range(16):
        packed |= c3[:, j, :] << np.uint32(2 * j)
    i3 = invalid.reshape(rows, 32, M)
    mask = np.zeros((rows, M), np.uint32)
    for j in range(32):
        mask |= i3[:, j, :].astype(np.uint32) << np.uint32(j)
    return packed, mask
