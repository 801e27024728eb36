"""The least time one H100 could take for a kernel's work: its bytes over
the memory rate or its integer operations over the integer rate, whichever
is larger. ``chip_smoke.py`` and the timing experiments give every kernel
this bound beside its measured time (K1's is :func:`k1_bound`)."""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet). The sheet gives no
# rate for 32-bit integer arithmetic outside the tensor cores; Hopper runs
# it on half of the lanes that give the sheet's 67 TFLOP/s in float32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 2


def bound_ms(bytes_moved: float, int_ops: float):
    """(least milliseconds the card could take, what bounds it): the
    larger of the bytes over the memory rate and the integer operations
    over the integer rate."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = int_ops / PEAK_INT32_OPS_PER_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def k1_bound(keys):
    """K1 ``radix_sort_words``' bound on a key set (int32 [W, N]): the W key
    words read and written once and the permutation written (8 bytes a
    key); one digit step a key byte."""
    W, N = keys.shape
    return bound_ms(2 * W * N * 4 + 8 * N, W * N * 4)


def k5_bound(words):
    """K5 ``seed_key_words``' bound on the words it wrote (int32 [W, N]):
    the words written once and a text byte a row read once."""
    W, N = words.shape
    return bound_ms(4 * W * N + N, 0)


def k6_bound(occ):
    """K6 ``occ_tables``' bound on the tables it wrote (an ``OccTables``):
    a packed word read and 36 bytes written (occ2 and lf_tab) a table row,
    and 32 bytes of occ1 a superblock."""
    return bound_ms(40 * occ.lf_tab.shape[0] + 32 * occ.occ1.shape[0], 0)
