"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles every source to an object file, one process per source,
all started together, and links the objects into one shared library with a
plain C interface, loaded with ``ctypes``. The library's name carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
binary is never loaded (the scheme of zotpu/io/native.py). Output goes to
``zotpu_torch/_build/``. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# entry point -> (restype, argtypes); every pointer and the stream is c_void_p
_SIGNATURES = {
    "zt_error_string": (ctypes.c_char_p, [_I32]),
    "zt_pack_max_len": (_I32, []),
    "zt_pack_wire": (_I32, [_P, _P, _P, _I64, _I32, _I32, _P, _P]),
    "zt_pack_codes": (_I32, [_P, _P, _I64, _I32, _I32, _P, _P]),
    "zt_dedup_scratch_elems": (_I64, [_I64]),
    "zt_dedup_compact": (_I32, [_P, _I64, _P, _P, _P, _P, _P]),
    "zt_set_op_scratch_elems": (_I64, [_I64, _I64]),
    "zt_set_op": (_I32, [_I32, _P, _P, _I64, _P, _P, _P, _I64, _P, _P, _P,
                         _P, _P, _P]),
    "zt_join_scratch_elems": (_I64, [_I64]),
    "zt_join_row_hits": (_I32, [_P, _I64, _P, _I64, _I32, _P, _P, _P]),
    "zt_join_row_hits_tagged": (_I32, [_P, _I64, _P, _P, _I64, _I64, _P,
                                       _P, _P]),
    "zt_merge_runs": (_I32, [_P, _P, _I64, _I64, _I64, _P, _P, _P]),
    "zt_merge_dedup_scratch_elems": (_I64, [_I64]),
    "zt_merge_dedup": (_I32, [_P, _I64, _I64, _P, _P, _P, _P, _P]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the zotpu_torch "
                       "CUDA kernels cannot be built")


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libzotpu_torch-{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile the kernels unless the current build exists. Returns the
    library path and the seconds spent compiling (0.0 when cached)."""
    so = library_path()
    if os.path.exists(so):
        return so, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{so}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        jobs = []
        for src in (s for s in _sources() if s.endswith(".cu")):
            obj = os.path.join(objdir, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so, _ = build()
            loaded = ctypes.CDLL(so)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = loaded
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = lib().zt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(device, name: str, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and, last, the current
    stream of ``device``, with ``device`` made the current device (a kernel
    launched on a stream of another device fails), and raise on a CUDA
    error."""
    with torch.cuda.device(device):
        check(getattr(lib(), name)(
            *args, torch.cuda.current_stream(device).cuda_stream), name)
