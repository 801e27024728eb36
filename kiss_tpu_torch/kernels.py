"""Build, load and count the port's hand-written CUDA kernels.

The kernel sources (``csrc/radix_sort.cu``, ``csrc/seed_pack.cu``,
``csrc/occ_tables.cu``, ``csrc/fm_search.cu``, ``csrc/fm_locate.cu``,
``csrc/fm_bfs.cu``, ``csrc/micro_probes.cu``) have
a plain C interface. They are compiled by ``nvcc`` for ``sm_90a``, one ``nvcc``
process per source and all started together, and linked into one shared
library under ``kiss_tpu_torch/build/`` at first use, which is loaded
with ``ctypes``.
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
SOURCES = ("radix_sort.cu", "seed_pack.cu", "occ_tables.cu", "fm_search.cu",
           "fm_locate.cu", "fm_bfs.cu", "micro_probes.cu")
HEADERS = ("fm_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

LAUNCHES = {
    "radix_sort_words": 0,
    "seed_key_words": 0,
    "occ_tables": 0,
    "fm_backward_search": 0,
    "fm_locate_rows": 0,
    "fm_locate_stats": 0,
    "fm_bfs_stats": 0,
    "fm_bfs_locate": 0,
    "stream_copy": 0,
    "one_stage": 0,
    "tile_sort": 0,
    "kernel_gather": 0,
    "copy_grid": 0,
    "copy_2d": 0,
    "run_heavy": 0,
}


# Queries that kernel K4 walked on its spill route (their levels in global
# scratch, not shared memory), as the kernel reports them, by entry point.
SPILLED = {"fm_bfs_stats": 0, "fm_bfs_locate": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, SPILLED):
        for name in counts:
            counts[name] = 0


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


def _run_all(cmds) -> None:
    """Start every command at once, wait for all, raise on a failure."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (" + " ".join(cmd) + "):\n" + out)


def build() -> str:
    """Compile the kernels if no current build exists; return the path.
    Each source becomes an object file by its own ``nvcc`` process (all
    run at once), then one link makes the library. Everything is made in
    a temporary directory and the library moved into place, so a
    concurrent loader never sees a partial file."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, s + ".o") for s in SOURCES]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, s), "-o", obj]
            for s, obj in zip(SOURCES, objects)
        ])
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects]])
        os.replace(lib, path)
    return path


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_SIGNATURES = {
    "kt_radix_digit_counts": [_P, _I, _L, _P, _P],
    "kt_radix_tile_keys": [],
    "kt_radix_onesweep_pass": [
        _P, _P, _P, _P, _L, _I, _P, _P, _P, _L, _P, _P,
    ],
    "kt_gather_words": [_P, _I, _L, _P, _U, _U, _P, _I, _P, _P],
    "kt_gather_rows4": [_P, _L, _P, _I, _I, _I, _I, _P, _P, _P],
    "kt_seed_key_words": [_P, _L, _I, _I, _P, _P],
    "kt_occ_tables": [_P, _L, _L, _P, _P, _L, _P, _P, _P, _P, _P, _P],
    "kt_fm_backward_search": [
        _P, _P, _P, _P, _L, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P,
    ],
    "kt_fm_locate_rows": [_P, _P, _P, _P, _I, _P, _L, _P, _P],
    "kt_fm_locate_stats": [_P, _P, _P, _P, _I, _P, _P, _L, _P, _P],
    "kt_fm_bfs_stats": [_P, _P, _P, _P, _I, _P, _P, _L, _P, _L, _P, _P],
    "kt_fm_bfs_stats_split": [
        _I, _P, _P, _P, _P, _I, _P, _P, _L, _P, _L, _P, _P,
    ],
    "kt_fm_bfs_segments": [
        _P, _P, _P, _I, _P, _P, _L, _P, _L, _P, _P, _L, _P, _P,
    ],
    "kt_fm_bfs_expand": [_P, _P, _P, _L, _L, _P, _P],
    "kt_probe_stream_copy": [_P, _P, _L, _L, _P],
    "kt_probe_copy_grid": [_P, _P, _L, _L, _P],
    "kt_probe_heavy": [_P, _P, _L, _L, _U, _U, _P],
    "kt_probe_copy_2d": [_P, _P, _L, _L, _P],
    "kt_probe_gather": [_P, _I, _P, _P, _L, _L, _I, _P],
    "kt_probe_one_stage": [_P, _P, _P, _P, _L, _L, _L, _L, _P],
    "kt_probe_sort_local": [_P, _P, _P, _P, _L, _L, _L, _P],
    "kt_probe_sort_wide": [_P, _P, _L, _L, _L, _L, _L, _P],
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
