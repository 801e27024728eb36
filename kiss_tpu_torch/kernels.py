"""Build, load and count the port's hand-written CUDA kernels.

The three kernels (``csrc/radix_sort.cu``, ``csrc/fm_search.cu``,
``csrc/fm_locate.cu``) have a plain C interface. They are compiled by
``nvcc`` for ``sm_90a`` into one shared library under
``kiss_tpu_torch/build/`` at first use, and loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an
edited source is rebuilt and a current build is reused. Nothing here
runs when the module is imported: a machine without ``nvcc`` or a GPU
can import every module of the port and use the plain PyTorch versions.

Every kernel wrapper adds one to its entry in :data:`LAUNCHES` when it
launches its kernel, and nowhere else, so a run can show that it went
through the kernels (``reset_launch_counts`` before, read after).
"""

from __future__ import annotations

import ctypes
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
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("radix_sort.cu", "fm_search.cu", "fm_locate.cu")
HEADERS = ("fm_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES = {
    "radix_sort_words": 0,
    "fm_backward_search": 0,
    "fm_locate_rows": 0,
    "fm_locate_stats": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of kiss_tpu_torch are built "
        "from kiss_tpu_torch/csrc/*.cu at first use and need the CUDA "
        "toolkit"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkiss_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if no current build exists; return the path.
    The library is linked into a temporary file and moved into place,
    so a concurrent loader never sees a partial file."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp] + [
            os.path.join(CSRC, s) for s in SOURCES
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed (" + " ".join(cmd) + "):\n" + proc.stdout
                + proc.stderr
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "kt_radix_digit_counts": [_P, _I, _L, _P, _P],
    "kt_radix_sort_pass": [_P, _P, _P, _P, _L, _I, _P, _P, _P],
    "kt_gather_words": [_P, _I, _L, _P, _P, _P],
    "kt_fm_backward_search": [
        _P, _P, _P, _P, _L, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P,
    ],
    "kt_fm_locate_rows": [_P, _P, _P, _P, _P, _I, _P, _L, _P, _P],
    "kt_fm_locate_stats": [_P, _P, _P, _P, _P, _I, _P, _P, _L, _L, _P, _P],
}


def library():
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kt_error_string.argtypes = [ctypes.c_int]
            lib.kt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def timed_build() -> float:
    """Build and load the library; return the seconds it took."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


def check(rc: int, name: str) -> None:
    """Raise when a kernel entry point reported a CUDA error (its
    ``cudaGetLastError()`` after the launches)."""
    if rc != 0:
        msg = library().kt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``, for a launch."""
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    """Validate a tensor handed to a kernel entry point."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def require_cuda(tensors: dict, device: torch.device) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(
                f"{name} is on {t.device}, expected {device}: every input "
                "of a kernel must be on the same CUDA device"
            )
