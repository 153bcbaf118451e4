"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file —
all sources at once, one ``nvcc`` process each — and the objects are
linked into ONE shared library with a plain C interface, loaded through
``ctypes``. Nothing here runs at import: the first CUDA launch calls
``library()``, so the CPU tests import every kernel module without a
compiler.

The library lands in ``<repo>/build/repro_torch/`` (listed in
``.gitignore``) under a name that hashes the sources and flags, so a
changed source rebuilds and an unchanged one loads at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

__all__ = ["BUILD_DIR", "SOURCES", "nvcc_path", "build", "build_log",
           "library", "check", "stream_of", "dtype_code"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("gather_rows.cu", "scatter_add_rows.cu", "bsr_spmm.cu",
           "bsr_sddmm.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (pointers and the stream as c_void_p, sizes as int64)
    "repro_gather_rows": [_P, _P, _P, _I64, _I64, _I64, _I64, _I32, _P],
    "repro_scatter_add_rows": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32,
                               _P],
    "repro_bsr_spmm": [_P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I64,
                       _I64, _I64, _I32, _I32, _P],
    "repro_bsr_spmm_acc": [_P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                           _I64, _I64, _I64, _I32, _I32, _P],
    "repro_bsr_sddmm": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I64,
                        _I64, _I32, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin); the CUDA kernels "
            "are built from src/repro_torch/csrc at first use on the card")
    return nvcc


def _digest() -> str:
    h = hashlib.sha1()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    digest = _digest()
    lib_path = BUILD_DIR / f"librepro_torch_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        objs = [tmp / (Path(src).stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        log = []
        failed = []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            log.append(f"== nvcc {src} (rc {proc.returncode})\n{out}")
            if proc.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, NVCC_FLAGS[0], "-shared", *map(str, objs),
             "-o", str(tmp / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("linking the kernel library failed:\n"
                               + "\n".join(log))
        (BUILD_DIR / f"build_{digest}.log").write_text("\n".join(log))
        os.replace(tmp / "lib.so", lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def build_log() -> str:
    """The compiler output (``-Xptxas -v``) of the current build, if any."""
    path = BUILD_DIR / f"build_{_digest()}.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype: torch.dtype, kernel: str) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"{kernel} kernel takes float32 or bfloat16, "
                        f"got {dtype}") from None
