"""ctypes bridge to the native C++ IO library (csrc/kiss_io.cpp).

Copy of ``kiss_tpu.utils.native`` for the PyTorch port, with one change
to how the library is found: the repository ships a prebuilt
``csrc/build/libkiss_io.so``, and this module loads it as it is. It
builds the library only when that file is missing, and then links into
a temporary directory and moves the result into place with
``os.replace``, so two processes (or two packages under pytest-xdist)
that load the library at once never see a half-written file. Streaming
FASTA/FASTQ parsing and bit packing run through the library when it is
available, with pure-numpy fallbacks otherwise.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_SO = os.path.join(_CSRC, "build", "libkiss_io.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build_missing() -> None:
    """Build ``libkiss_io.so`` with the repository's Makefile into a
    private temporary directory beside the target, then move it into
    place atomically. Failures leave the numpy fallbacks in charge."""
    if not os.path.exists(os.path.join(_CSRC, "Makefile")):
        return
    build_dir = os.path.dirname(_SO)
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".build-", dir=build_dir)
    try:
        subprocess.run(
            ["make", "-C", _CSRC, "-s", f"BUILD={tmp}"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(os.path.join(tmp, "libkiss_io.so"), _SO)
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO):
            _build_missing()
        if not os.path.exists(_SO):
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.ki_parse_sequence.restype = ctypes.c_int64
        lib.ki_parse_sequence.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i8p,
        ]
        lib.ki_fold_acgt.restype = None
        lib.ki_fold_acgt.argtypes = [i8p, ctypes.c_int64]
        lib.ki_pack_dibits.restype = None
        lib.ki_pack_dibits.argtypes = [i8p, ctypes.c_int64, u8p]
        lib.ki_unpack_dibits.restype = None
        lib.ki_unpack_dibits.argtypes = [u8p, ctypes.c_int64, i8p]
        lib.ki_pack_bits.restype = None
        lib.ki_pack_bits.argtypes = [u8p, ctypes.c_int64, u64p]
        if hasattr(lib, "ki_lms_induced_sort"):
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.ki_lms_induced_sort.restype = ctypes.c_int
            lib.ki_lms_induced_sort.argtypes = [
                i8p, ctypes.c_int64, ctypes.c_int64, i64p,
            ]
            lib.ki_set_threads.restype = None
            lib.ki_set_threads.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_sequence(data: bytes) -> np.ndarray | None:
    """Native FASTA/FASTQ/text parse -> int8 codes, or None if the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(len(data), dtype=np.int8)
    n = lib.ki_parse_sequence(data, len(data), out)
    return out[:n].copy()


def fold_acgt_inplace(buf: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    assert buf.dtype == np.int8 and buf.flags.c_contiguous
    lib.ki_fold_acgt(buf, buf.shape[0])
    return True


def pack_dibits(vals: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.int8)
    out = np.empty((len(vals) + 3) // 4, dtype=np.uint8)
    lib.ki_pack_dibits(vals, len(vals), out)
    return out


def set_threads(n: int) -> None:
    """Cap OpenMP threads for native sort stages (the -t knob)."""
    lib = _load()
    if lib is not None and hasattr(lib, "ki_set_threads"):
        lib.ki_set_threads(n)


def lms_induced_sort(seq: np.ndarray, k: int) -> np.ndarray | None:
    """Native LMS + induced k-ordered suffix sort (csrc/kiss_lms.cpp),
    or None if the library is unavailable. ``k = -1`` = full sort.
    Returns the n+1-slot SA as int64 (callers narrow the dtype)."""
    lib = _load()
    if lib is None or not hasattr(lib, "ki_lms_induced_sort"):
        return None
    seq = np.ascontiguousarray(seq, dtype=np.int8)
    sa = np.empty(len(seq) + 1, dtype=np.int64)
    rc = lib.ki_lms_induced_sort(seq, len(seq), k, sa)
    if rc != 0:
        raise ValueError(
            f"ki_lms_induced_sort rejected n={len(seq)}, k={k} (rc={rc})"
        )
    return sa
