"""ctypes bridge to the native C++ FASTQ parser (zotpu_torch/native/).

A copy of zotpu/io/native.py. Builds the parser with g++ on first use into
``zotpu_torch/_build/``, named by a hash of its source; every entry point
has a numpy fallback (io/fastq.py), so the package works -- just slower on
the host side -- if no compiler exists. ``backend()`` says which of the two
is in use, so that a measurement can refuse the slow one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

from zotpu_torch import metrics

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "fastq_parser.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build() -> tuple[str | None, float]:
    """Build the .so unless the one for this source exists; its name carries
    a hash of the source, so a stale or foreign binary is never loaded.
    Returns its path, or None when it cannot be built, and the seconds
    spent compiling (0.0 when it existed)."""
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(_BUILD_DIR, f"libzotpu_native-{digest}.so")
        if os.path.exists(so):
            return so, 0.0
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        # Portable flags only: -march=native output SIGILLs on older hosts.
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True)
        os.replace(tmp, so)
        return so, time.perf_counter() - t0
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return None, 0.0


def get_lib():
    """Load (building if needed) the native library, or None on failure.

    Every failure mode -- missing compiler, failed dlopen, missing symbols --
    degrades to the numpy fallback instead of raising."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        t0 = time.perf_counter()
        so, build_s = _build()
        if so is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.zotpu_parse_fastq.restype = ctypes.c_int64
            lib.zotpu_parse_fastq.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
            lib.zotpu_skip_lines.restype = ctypes.c_int64
            lib.zotpu_skip_lines.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.zotpu_encode.restype = None
            lib.zotpu_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p]
            lib.zotpu_pack_wire.restype = None
            lib.zotpu_pack_wire.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int64,
                                            ctypes.c_void_p, ctypes.c_void_p]
        except (OSError, AttributeError):
            _lib_failed = True
            return None
        _lib = lib
        metrics.count_load(time.perf_counter() - t0, build_s)
        return _lib


def backend() -> str:
    """``"native"`` when the C++ parser is built and loaded (building it now
    if need be), ``"numpy"`` when the fallback is in use."""
    return "native" if get_lib() is not None else "numpy"


def parse_fastq_buffer(buf: bytes | np.ndarray, max_reads: int, max_len: int,
                       offset: int = 0):
    """One native parse call. Returns (codes, lengths, n_reads, consumed,
    max_seen) or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(buf, dtype=np.uint8)
    codes = np.empty((max_reads, max_len), np.uint8)
    lengths = np.empty(max_reads, np.int32)
    consumed = ctypes.c_int64(0)
    max_seen = ctypes.c_int64(0)
    base = arr.ctypes.data + offset
    n = lib.zotpu_parse_fastq(
        ctypes.c_void_p(base), ctypes.c_int64(len(arr) - offset),
        ctypes.c_int64(max_reads), ctypes.c_int64(max_len),
        ctypes.c_void_p(codes.ctypes.data), ctypes.c_void_p(lengths.ctypes.data),
        ctypes.byref(consumed), ctypes.byref(max_seen))
    return codes, lengths, int(n), int(consumed.value), int(max_seen.value)


def pack_wire(codes: np.ndarray):
    """Single-pass C++ wire pack (see io/wire.py for the STRIPED u32
    layout), or None if the native library is unavailable. codes: contiguous
    (rows, L) u8 with L % 32 == 0."""
    lib = get_lib()
    if lib is None:
        return None
    rows, L = codes.shape
    codes = np.ascontiguousarray(codes)
    packed = np.empty((rows, L // 16), np.uint32)
    mask = np.empty((rows, L // 32), np.uint32)
    lib.zotpu_pack_wire(
        ctypes.c_void_p(codes.ctypes.data), ctypes.c_int64(rows),
        ctypes.c_int64(L),
        ctypes.c_void_p(packed.ctypes.data), ctypes.c_void_p(mask.ctypes.data))
    return packed, mask


def skip_lines(buf: np.ndarray, n: int, offset: int = 0):
    """Find the first ``n`` newlines of ``buf[offset:]`` (a contiguous u8
    array) with the native memchr loop, out of the GIL. Returns (bytes up
    to and including the last newline found, newlines found), or None if
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    found = ctypes.c_int64(0)
    used = lib.zotpu_skip_lines(
        ctypes.c_void_p(buf.ctypes.data + offset),
        ctypes.c_int64(len(buf) - offset), ctypes.c_int64(n),
        ctypes.byref(found))
    return int(used), int(found.value)
