"""The least time one H100 could take for a query kernel's work, frozen
here so that the yardstick does not move with the program.

Copied from ``kiss_tpu_torch/utils/roofline.py`` (the peaks and
``bound_ms``) and ``kiss_tpu_torch/experiments/fm_query_time.py``
(``index_bytes``, ``k2_bound``, ``k3_bound``, ``k4_bound``, ``BfsWork``),
with one change: the sizes of the index's tables are computed from the
number of rows N = n + 1 and ``sa_intv`` by :class:`IndexSizes`, not read
from the program's live tensors, so a later change of the program's table
layout does not move the bound. ``tests/test_kissbench_frozen.py`` holds
each function against its source on indexes the program built.
"""

from __future__ import annotations

from typing import NamedTuple

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


class IndexSizes(NamedTuple):
    """Bytes of the FM-index tables of a text of ``n`` characters sampled
    every ``sa_intv`` positions with a ``lookup_len`` table: the fused LF
    table (a 20-byte row per 16 rows and one more), the mark table (a
    12-byte row per started 64), the block table (a 32-byte entry per 64 rows, a 64-byte
    superblock value per 65,536) and the sampled SA (8 bytes a sample)."""

    lf_tab: int
    b_tab: int
    blk: int
    sup: int
    sa_samp: int
    lookup_entries: int

    @classmethod
    def of(cls, n: int, sa_intv: int, lookup_len: int = 0) -> "IndexSizes":
        N = n + 1
        samples = N if sa_intv == 1 else n // sa_intv + 1
        return cls(20 * (N // 16 + 1), 12 * -(-N // 64),
                   32 * (N // 64 + 1), 64 * (N // 65536 + 1), 8 * samples,
                   4**lookup_len + 1 if lookup_len else 2)


# The K2 and K3 bounds count what the data needs: the LF steps the queries
# really take (early stop), the walk steps the rows really take and 8 bytes
# per sa_samp read. The index is counted in whichever of its two layouts
# needs fewer bytes for those steps, each capped at its own size, since
# each input byte counts once.
def index_bytes(sizes: IndexSizes, lfs: int, probes: int) -> int:
    """Least bytes of the index that ``lfs`` LF steps and ``probes`` mark
    probes read (an LF at a probed row shares its entry)."""
    split = min(sizes.lf_tab, lfs * 20) + min(sizes.b_tab, probes * 12)
    reads = max(lfs, probes)
    table = min(sizes.blk, reads * 32) + min(sizes.sup, reads * 8)
    return min(split, table)


def k2_bound(sizes: IndexSizes, nq: int, qwords: int, lf_steps: int,
             lookup_reads: int = 0):
    """K2: packed queries in, three int64 outputs, the index the steps
    read and the ``lookup_reads`` lookup-table entries the seeded queries
    read (capped at the table's size); about 16 integer operations per
    LF."""
    return bound_ms(
        qwords * 4 + 24 * nq + index_bytes(sizes, 2 * lf_steps, 0)
        + min(sizes.lookup_entries, lookup_reads) * 8,
        2 * lf_steps * 16,
    )


def k3_bound(sizes: IndexSizes, io_bytes: int, walk: int, rows: int):
    """K3: ranges or rows in, result out; per walk step one LF, a mark
    probe per row visited, an sa_samp entry per row."""
    samp = min(sizes.sa_samp, rows * 8)
    return bound_ms(
        io_bytes + samp + index_bytes(sizes, walk, walk + rows),
        walk * 16 + rows * 8,
    )


class BfsWork(NamedTuple):
    """What K4's pruned walk of a batch's trees visits and emits."""

    nodes: int  # non-empty nodes
    entries: int  # block-table entries they read: one a row, else two
    lfs: int  # LF steps: one for a row's child (none at the sentinel
    # row), four for each endpoint of a wider node above the last depth
    segments: int  # non-empty segments
    positions: int


def k4_bound(sizes: IndexSizes, nq: int, work: BfsWork, stats: bool):
    """K4: the ranges in (16 bytes a query); the block-table entries its
    walk reads (32 bytes each, capped at the table); the samples: 8 bytes
    of sa_samp a position, or for the stats, where fewer, two 8-byte
    samp_sum values a non-empty segment; the output (the positions, or the
    two integers). Operations: about 16 a mark rank (one an entry) and 16
    an LF."""
    samp = 8 * work.positions
    if stats:
        samp = min(samp, 16 * work.segments)
    out = 16 if stats else 8 * work.positions
    return bound_ms(
        16 * nq + min(sizes.blk, 32 * work.entries) + samp + out,
        16 * (work.entries + work.lfs),
    )
