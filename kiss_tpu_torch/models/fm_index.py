"""k-ordered FM-index, PyTorch port.

Port of ``kiss_tpu.models.fm_index`` (itself a re-design of the reference
``FMIndex<SA_INTV, uint32_t, Sorter>``, reference:
include/biovoltron/algo/align/exact_match/fm_index.hpp:99-652):

  - The build is tensor code over blocks of SA rows
    (:func:`build_index_rows`; the whole SA is one block in
    :func:`build_index_device`, and the mesh build gives each shard one):
    the BWT by the gather ``text[sa - 1]``, the sampled SA by a boolean
    mask select. (The TPU build used sorts in place of the gather and the
    select; the outputs are the same.) The occurrence tables (occ1, occ2
    and the fused ``lf_tab``) come from the packed BWT words in one pass
    of kernel K6 (``csrc/occ_tables.cu``); :func:`occ_tables_plain`,
    masked popcounts and exclusive scans, is its plain version.
  - Queries are batched: the backward search (kernel K2,
    ``csrc/fm_search.cu``) runs one thread per pattern; locate (kernel K3,
    ``csrc/fm_locate.cu``) walks each row to a sampled one, and its stats
    entry point expands the query ranges, walks and sums the positions in
    one pass. Both read the block table (:class:`FMBlocks`, built with the
    index): an LF step or a walk step reads one aligned 32-byte entry.
    Each kernel has its plain PyTorch version beside it here, which reads
    ``lf_tab`` and ``b_tab`` and is what runs on a CPU tensor.
  - ``save``/``load`` produce byte-identical ``.fmi`` archives
    (reference: fm_index.hpp:591-646 + serializer.hpp layout).

Dtypes on the device: rows, positions and counts are int64; the 32-bit
bit tables (``bwt_words``, ``b_words``, ``lf_tab``, ``b_tab``) are int32
tensors holding the uint32 bits the TPU kept, and ``occ2`` holds uint8
content in int32. Files keep the reference's ``<u4`` layout.

The per-row walk is exact only when the index was built from a FULLY
sorted SA; other indexes (bounded ``-k`` builds, archives loaded without
a ``full_sa`` sidecar, archives written by the reference binary, which
are 32-ordered) locate through the range BFS (kernel K4,
``csrc/fm_bfs.cu``; plain version ``bfs_locate_device_plain``), which
applies LF to range endpoints only and is exact on any k-ordered source
SA with k >= sa_intv - 1 + pattern length. (In the JAX package the BFS is
jitted XLA, not a hand-written kernel.)
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from kiss_tpu_torch import kernels
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
from kiss_tpu_torch.utils import serializer, timing
from kiss_tpu_torch.utils.device import resolve_device

OCC1_INTV = 256
OCC2_INTV = 16
B_OCC_INTV = 64

# The reference build hardcodes a 32-ordered SA (reference:
# fm_index.hpp:384-386); this library's default build sorts fully, which
# keeps the per-row locate walk exact for every pattern length (see the
# SORT_LEN note in kiss_tpu/models/fm_index.py).
SORT_LEN = None


class FMArrays(NamedTuple):
    """Device-resident index (fields and shapes as kiss_tpu's)."""

    bwt_words: torch.Tensor  # int32 bits [ceil(N/16)], 2-bit LSB-first
    occ1: torch.Tensor  # int64 [N//256+1, 4]
    occ2: torch.Tensor  # int32 [N//16+1, 4] (uint8 content)
    cnt: torch.Tensor  # int64 [4]
    pri: torch.Tensor  # int64 scalar: row of the sentinel
    sa_samp: torch.Tensor  # int64 [ceil(N/SA_INTV)] (or full SA if INTV==1)
    b_words: torch.Tensor  # int32 bits [2*ceil(N/64)] sampled-row marks
    b_occ: torch.Tensor  # int64 [N//64+1]
    lookup: torch.Tensor  # int64 [4^LOOKUP_LEN + 1]
    # device-only fusions (not serialized): every table an LF step or a
    # mark probe touches lives in one row
    #   lf_tab[j] = [occ1[j//16] + occ2[j] for each symbol (4 cols),
    #                bwt word j]
    #   b_tab[blk] = [b_occ[blk], b_words[2blk], b_words[2blk+1]]
    lf_tab: torch.Tensor  # int32 bits [N//16+1, 5]
    b_tab: torch.Tensor  # int32 bits [N//64+1, 3]


_BIT_FIELDS = ("bwt_words", "b_words", "lf_tab", "b_tab")

SUP_BLOCKS = 1024  # 64-row entries a superblock spans: 65,536 rows, so
# counts within a superblock fit 16 bits


class FMBlocks(NamedTuple):
    """The query kernels' device-only table (never serialized), derived
    from ``lf_tab`` and ``b_tab`` by :func:`block_table`: everything an LF
    step or a locate step needs at row i lies in the one aligned 32-byte
    entry ``blk[i >> 6]``.

    ``blk`` int32 bits [N//64 + 1, 8], entry j for rows [64j, 64j + 64):
      words 0-3  BWT words 4j .. 4j+3 (64 dibits, LSB-first; 0 past N)
      words 4-5  mark words 2j, 2j+1 (row r marked: bit r % 64; 0 when
                 the index samples every row)
      word 6     occ of symbol 0 (low 16 bits), of symbol 1 (high)
      word 7     occ of symbol 2 (low), marks (high)
    The counts are those of rows [65536 s, 64 j) of the entry's superblock
    s = j // 1024. Symbol 3's is 64 (j % 1024) less the other three, less
    one if the sentinel row lies among those rows (it packs as symbol 0
    but counts as none).

    ``sup`` int64 [N//65536 + 1, 8]: LF(c, 65536 s) = cnt[c] + occ(c,
    65536 s) for symbols 0-3, the marks before row 65536 s, a zero column,
    then the range BFS kernel's (K4) 32-bit copy of LF(0..2, 65536 s) and
    of the marks, as four uint32 in the last 16 bytes (64-byte rows). So
    LF(c, i) is sup[i >> 16, c] plus counts from i's entry alone.

    ``samp_sum`` int64 [len(sa_samp) + 1]: the prefix sums of ``sa_samp``
    (samp_sum[k] = sa_samp[0] + ... + sa_samp[k - 1], modulo 2^64), so
    the sum of a run of samples is one difference: what the range BFS's
    stats kernel (K4) adds for each node of a query's tree."""

    blk: torch.Tensor
    sup: torch.Tensor
    samp_sum: torch.Tensor


def _table_rows(idx: FMArrays) -> tuple[int, int]:
    """(entries, superblocks) of the block table of ``idx``: N // 64 + 1
    and N // 65536 + 1, from lf_tab's N // 16 + 1 rows."""
    nblk = (idx.lf_tab.shape[0] - 1) // 4 + 1
    return nblk, (nblk - 1) // SUP_BLOCKS + 1


def block_table(idx: FMArrays, sa_intv: int) -> FMBlocks:
    """The block table of ``idx`` (see :class:`FMBlocks`), on its device.
    Built once an index (``FMIndex.build`` / ``load``), next to
    ``lf_tab`` and ``b_tab``, whose rows it re-lays: lf_tab row 4j holds
    the counts before row 64j, b_tab row j the marks of block j. b_tab
    has no row for a block that starts at row N (N a multiple of 64):
    that entry gets no mark bits and the count of all marks. An index
    that samples every row (``sa_intv == 1``) has no marks."""
    with timing.span("kiss.build.block_table", device=True):
        return _block_table(idx, sa_intv)


def _block_table(idx: FMArrays, sa_intv: int) -> FMBlocks:
    lf_rows = idx.lf_tab.shape[0]
    nblk, nsup = _table_rows(idx)
    dev = idx.lf_tab.device
    occ = pack.as_u32(idx.lf_tab[0::4, :4])  # before row 64 j
    words = torch.zeros(4 * nblk, dtype=torch.int32, device=dev)
    words[:lf_rows] = idx.lf_tab[:, 4]
    marks = torch.zeros((nblk, 3), dtype=torch.int64, device=dev)
    if sa_intv != 1:
        rows = idx.b_tab.shape[0]
        if rows not in (nblk - 1, nblk):
            raise ValueError(
                f"b_tab has {rows} rows; an index of {nblk} 64-row "
                "blocks has one per block that starts before row N"
            )
        marks[:rows] = pack.as_u32(idx.b_tab)
        marks[rows:, 0] = idx.sa_samp.shape[0]
    counts = torch.cat([occ, marks[:, :1]], dim=1)  # [nblk, 5]
    base = counts[0::SUP_BLOCKS]
    rel = counts - torch.repeat_interleave(base, SUP_BLOCKS, dim=0)[:nblk]
    sup = torch.zeros((nsup, 8), dtype=torch.int64, device=dev)
    sup[:, :5] = base
    sup[:, :4] += idx.cnt
    low = sup[:, [0, 1, 2, 4]] & 0xFFFFFFFF  # K4's words (rows below 2^32)
    sup[:, 6] = low[:, 0] | (low[:, 1] << 32)
    sup[:, 7] = low[:, 2] | (low[:, 3] << 32)
    blk = torch.cat(
        [pack.as_u32(words.reshape(nblk, 4)), marks[:, 1:],
         (rel[:, 0] | (rel[:, 1] << 16))[:, None],
         (rel[:, 2] | (rel[:, 4] << 16))[:, None]],
        dim=1,
    )
    samp_sum = torch.zeros(idx.sa_samp.shape[0] + 1, dtype=torch.int64,
                           device=dev)
    torch.cumsum(idx.sa_samp, dim=0, out=samp_sum[1:])
    return FMBlocks(pack.to_u32_bits(blk), sup, samp_sum)


def arrays_from_numpy(d, device) -> FMArrays:
    """The port's ``FMArrays`` on ``device`` from ``kiss_tpu``'s (given as
    a mapping of field name -> numpy array, e.g. ``{k: np.asarray(v) for
    k, v in fmi.arrays._asdict().items()}``): uint32 bit tables become
    int32 bits, ``occ2`` int32, everything else int64."""
    dev = resolve_device(device)
    out = {}
    for name in FMArrays._fields:
        x = np.asarray(d[name])
        if name in _BIT_FIELDS:
            x = x.astype(np.uint32).view(np.int32)
        elif name == "occ2":
            x = x.astype(np.int32)
        else:
            x = x.astype(np.int64)
        out[name] = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return FMArrays(**out)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


class OccTables(NamedTuple):
    """The occurrence tables of a run of packed BWT words
    (:func:`occ_tables`), ``R`` table rows of 16 BWT rows each."""

    occ1: torch.Tensor  # int64 [ceil(R / 16), 4]: counts before row 256 s
    occ2: torch.Tensor  # int32 [R, 4]: counts in j's superblock before 16 j
    lf_tab: torch.Tensor  # int32 bits [R, 5]: occ1[j // 16] + occ2[j], word j
    totals: torch.Tensor  # int64 [4]: every word's counts, without the offset


# K6's table rows a tile and 64-bit status words a tile (csrc/occ_tables.cu)
_OCC_TILE_ROWS = 1024
_OCC_STATUS_WORDS = 4


def _occ_table_rows(bwt_words: torch.Tensor, rows: int,
                    table_rows: int | None) -> int:
    W = bwt_words.shape[0]
    if table_rows is None:
        table_rows = rows // OCC2_INTV + 1
    if not 0 <= rows <= OCC2_INTV * W or table_rows < W:
        raise ValueError(
            f"occ_tables: {W} words hold {OCC2_INTV * W} rows and need "
            f"{W} table rows; got rows={rows}, table_rows={table_rows}")
    return table_rows


def occ_tables_plain(bwt_words: torch.Tensor, rows: int, pri: torch.Tensor,
                     occ_off: torch.Tensor,
                     table_rows: int | None = None) -> OccTables:
    """Plain version of K6 ``occ_tables`` (the build's occ scans,
    reference: fm_index.hpp:277-308, as whole-array tensor code): each
    word's symbol counts among the first ``rows`` rows by XOR + masked
    popcount (the whole-array form of the reference's cnt_table byte
    scan, fm_index.hpp:158-164), the row ``pri`` counted as none; occ2 the
    exclusive cumsum within each 256-row superblock, occ1 that of the
    superblock totals plus ``occ_off``, and lf_tab their sum beside each
    word (0 past the last)."""
    table_rows = _occ_table_rows(bwt_words, rows, table_rows)
    dev = bwt_words.device
    W = bwt_words.shape[0]
    per_sup = OCC1_INTV // OCC2_INTV
    nsup = -(-table_rows // per_sup)
    starts = torch.arange(W, dtype=torch.int64, device=dev) * OCC2_INTV
    t = torch.clamp(rows - starts, 0, OCC2_INTV)
    c16 = torch.zeros((nsup * per_sup, 4), dtype=torch.int64, device=dev)
    for c in range(4):
        c16[:W, c] = pack.count_symbol_prefix(bwt_words, c, t)
    # the sentinel row packs as symbol 0 but counts as none
    here = (pri >= 0) & (pri < rows)
    c16[:, 0].index_add_(0, (torch.where(here, pri, 0) // OCC2_INTV)
                         .reshape(1), -here.to(torch.int64).reshape(1))
    g = c16.reshape(nsup, per_sup, 4)
    # occ2's content fits uint8; full counts only at the occ1 level
    occ2 = (torch.cumsum(g, dim=1) - g).reshape(-1, 4)[:table_rows]
    sup_tot = g.sum(dim=1)
    occ1 = torch.cumsum(sup_tot, dim=0) - sup_tot + occ_off
    words = torch.zeros(table_rows, dtype=torch.int64, device=dev)
    words[:W] = pack.as_u32(bwt_words)
    lf = torch.cat([torch.repeat_interleave(occ1, per_sup, dim=0)[:table_rows]
                    + occ2, words[:, None]], dim=1)
    return OccTables(occ1, occ2.to(torch.int32), pack.to_u32_bits(lf),
                     sup_tot.sum(dim=0))


def occ_tables(bwt_words: torch.Tensor, rows: int, pri: torch.Tensor,
               occ_off: torch.Tensor,
               table_rows: int | None = None) -> OccTables:
    """The occurrence tables (occ1, occ2, lf_tab and the symbol totals) of
    the packed BWT words ``bwt_words`` (int32 bits, 16 rows a word,
    LSB-first), of which the first ``rows`` rows count, the row ``pri``
    (an int64 scalar on the words' device, the sentinel's row among them;
    a value outside [0, rows) counts none) as no symbol; that row must
    hold symbol 0, as a BWT's sentinel row does (the kernel leaves the row
    out, the plain version takes one from symbol 0). ``occ_off`` (int64
    [4]) the counts before the first row. ``table_rows`` rows of occ2 and
    lf_tab (default rows // 16 + 1, the canonical shape of an index of
    ``rows`` rows); at least one a word. Bit for bit
    :func:`occ_tables_plain`: on a CUDA tensor the hand-written kernel K6
    (``csrc/occ_tables.cu``) writes them in one pass; on a CPU tensor the
    plain version runs. There is no fallback between the two."""
    table_rows = _occ_table_rows(bwt_words, rows, table_rows)
    dev = bwt_words.device
    if dev.type == "cpu":
        return occ_tables_plain(bwt_words, rows, pri, occ_off, table_rows)
    if dev.type != "cuda":
        raise ValueError(f"occ_tables: unsupported device {dev}")
    kernels.require(bwt_words, "bwt_words", torch.int32, 1)
    kernels.require(pri, "pri", torch.int64, 0)
    kernels.require(occ_off, "occ_off", torch.int64, 1)
    kernels.require_cuda({"pri": pri, "occ_off": occ_off}, dev)
    if occ_off.shape[0] != 4:
        raise ValueError(
            f"occ_off: expected 4 counts, got {occ_off.shape[0]}")
    if rows >= 2**32:
        raise ValueError(f"occ_tables takes rows < 2**32, got {rows}")
    sups = -(-table_rows // (OCC1_INTV // OCC2_INTV))
    tiles = -(-table_rows // _OCC_TILE_ROWS)
    with torch.cuda.device(dev):
        occ1 = torch.empty((sups, 4), dtype=torch.int64, device=dev)
        occ2 = torch.empty((table_rows, 4), dtype=torch.int32, device=dev)
        lf_tab = torch.empty((table_rows, 5), dtype=torch.int32, device=dev)
        totals = torch.empty(4, dtype=torch.int64, device=dev)
        scratch = torch.empty(1 + _OCC_STATUS_WORDS * tiles,
                              dtype=torch.int64, device=dev)
        kernels.check(
            kernels.library().kt_occ_tables(
                bwt_words.data_ptr(), bwt_words.shape[0], rows,
                pri.data_ptr(), occ_off.data_ptr(), table_rows,
                occ2.data_ptr(), occ1.data_ptr(), lf_tab.data_ptr(),
                totals.data_ptr(), scratch.data_ptr(),
                kernels.stream_of(dev),
            ),
            "kt_occ_tables",
        )
    kernels.count_launch("occ_tables")
    timing.add("occ_words", table_rows)  # the work K6's roofline counts
    timing.add("occ_sups", sups)
    return OccTables(occ1, occ2, lf_tab, totals)


def build_index_device(text: torch.Tensor, sa: torch.Tensor, sa_intv: int):
    """text int8[n], sa int64[N=n+1] (same device) -> FMArrays (without
    lookup): :func:`build_index_rows` over the whole SA as one block."""
    return build_index_rows(text, sa, sa_intv, block_rows=sa.shape[0])


class BlockCounts(NamedTuple):
    """What the tables of one block of rows are made from
    (:func:`block_counts`)."""

    words: torch.Tensor  # int32 bits [B / 16]: the BWT, 16 dibits a word
    rows: int  # the block's rows before row N
    at: torch.Tensor  # int64 scalar: the sentinel's row in the block, or -1
    marks: torch.Tensor | None  # bool [B]: sampled rows (None: sa_intv 1)
    pri: torch.Tensor  # int64 scalar: the sentinel's row if here, else 0


def block_counts(row0: int, N: int, bwt: torch.Tensor, sa: torch.Tensor,
                 sa_intv: int) -> BlockCounts:
    """The counts of the rows [row0, row0 + B) of an index of N rows from
    their BWT symbols (int8 [B]) and SA entries (int64, the block's first
    B or fewer rows), on one device; row0 and B multiples of 256, so every
    occ2 block, mark word and b_occ block lies in one block of rows. Rows
    from N on are pads: BWT symbol 0, and SA 1 or no entry at all (never
    the sentinel, never marked)."""
    B = bwt.shape[0]
    rows = min(max(N - row0, 0), B)
    # the sentinel row packs as symbol 0 but counts as none
    hit = sa == 0
    here, first = hit.view(torch.uint8).max(dim=0)  # its first row, if any
    here = here.bool()
    marks = None
    if sa_intv != 1:
        marks = torch.zeros(B, dtype=torch.bool, device=bwt.device)
        marks[:sa.shape[0]] = sa % sa_intv == 0
    return BlockCounts(pack.pack_dibits_u32(bwt), rows,
                       torch.where(here, first, -1), marks,
                       torch.where(here, first + row0, 0))


def block_tables(counts: BlockCounts, occ_off, mark_off):
    """The table rows of one block of rows (occ1, occ2, lf_tab and, unless
    the index samples every row, b_words, b_occ and b_tab, as a dict) and
    the block's symbol totals (int64 [4], the sentinel counted as none)
    from its :func:`block_counts`, given what the rows before it carry:
    each symbol's count (``occ_off``, int64 [4] on the block's device) and
    the marks (``mark_off``). The occurrence tables and the totals are
    :func:`occ_tables`'."""
    occ = occ_tables(counts.words, counts.rows, counts.at, occ_off,
                     table_rows=counts.words.shape[0])
    out = {"occ1": occ.occ1, "occ2": occ.occ2, "lf_tab": occ.lf_tab}
    if counts.marks is not None:
        shifts = torch.arange(32, dtype=torch.int64,
                              device=counts.marks.device)
        w = (counts.marks.reshape(-1, 32).to(torch.int64) << shifts).sum(1)
        c64 = pack.popcount_u32(w[0::2]) + pack.popcount_u32(w[1::2])
        b_occ = torch.cumsum(c64, dim=0) - c64 + mark_off
        b_words = pack.to_u32_bits(w)
        out.update(b_words=b_words, b_occ=b_occ,
                   b_tab=_fuse_b_tab(b_occ, b_words))
    return out, occ.totals


def trim_canonical(arrays: FMArrays, N: int, sa_intv: int) -> FMArrays:
    """Slice an FMArrays built in blocks of rows down to the canonical
    (serialization-layout) row counts: occ1 N//256+1, occ2 and lf_tab
    N//16+1, bwt words ceil(N/16), mark words 2*ceil(N/64), b_occ and
    b_tab ceil(N/64) (reference layout: fm_index.hpp:106-148); an index
    that samples every row keeps 1-row placeholders for the mark
    structures."""
    nb1 = N // OCC1_INTV + 1
    nb2 = N // OCC2_INTV + 1
    nw = -(-N // 16)
    if sa_intv == 1:
        nbw, nbo = 1, 1
        ns = N
    else:
        nbw = 2 * (-(-N // 64))
        nbo = -(-N // B_OCC_INTV)
        ns = -(-N // sa_intv)
    return arrays._replace(
        bwt_words=arrays.bwt_words[:nw],
        occ1=arrays.occ1[:nb1],
        occ2=arrays.occ2[:nb2],
        sa_samp=arrays.sa_samp[:ns],
        b_words=arrays.b_words[:nbw],
        b_occ=arrays.b_occ[:nbo],
        lf_tab=arrays.lf_tab[:nb2],
        b_tab=arrays.b_tab[:nbo],
    )


# SA rows a block of build_index_rows uploads: 2**26, about 2.5 GB of the
# block's temporaries on the card
BUILD_BLOCK_ROWS = 1 << 26


def _sa_rows(sa, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of a suffix array given as a numpy array or a tensor
    (uint32 values: uint32 or int32 bits; or int64), as int64 on
    ``device``."""
    x = sa[lo:hi]
    if isinstance(x, np.ndarray):
        if x.dtype.itemsize == 4:
            x = torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
        else:
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))
    x = x.to(device)
    return x if x.dtype == torch.int64 else pack.as_u32(x)


def build_index_rows(text: torch.Tensor, sa, sa_intv: int = 4,
                     block_rows: int = BUILD_BLOCK_ROWS) -> FMArrays:
    """The index of ``text`` (int8 [n], on the device that builds) and its
    suffix array ``sa`` (N = n + 1 entries, uint32 values: a host numpy
    array as the out-of-core sorter returns it, or a tensor, also on the
    card), built ``block_rows`` SA rows at a time, rounded up to a
    multiple of 256 so that every block starts on an occ1 superblock:
    the one place the BWT, the sentinel's row, the marks, the occurrence
    tables, the sampled SA and ``b_tab`` are made
    (:func:`build_index_device` is its one-block case). It holds the
    text, one block's temporaries and the tables it fills.

    A block's rows are uploaded, their BWT symbols gathered from the text
    (``text[sa - 1]``) and their tables made by :func:`block_counts` and
    :func:`block_tables` (which the mesh build shares), each block's
    carrying what the rows before it counted: each symbol's occurrences
    (occ1's offset, and ``cnt`` at the end), the marks (b_occ's offset and
    the sampled SA's next slot) and the sentinel's row. The last block
    reaches past row N to the next multiple of 256 (BWT symbol 0, no SA
    entry: never the sentinel, never marked), and the tables are cut to
    the canonical shapes. Returns ``FMArrays`` with ``lf_tab`` and
    ``b_tab`` and the lookup [0, N], on ``text``'s device."""
    n = text.shape[0]
    N = n + 1
    dev = text.device
    if len(sa) != N:
        raise ValueError(f"sa has {len(sa)} rows; a text of {n} has {N}")
    if block_rows < 1:
        raise ValueError("block_rows must be at least 1")
    P = (N // OCC1_INTV + 1) * OCC1_INTV  # rows with the pads: row N's too
    step = -(-block_rows // OCC1_INTV) * OCC1_INTV

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    tabs = {"bwt_words": empty(P // 16, torch.int32),
            "occ1": empty((P // OCC1_INTV, 4), torch.int64),
            "occ2": empty((P // OCC2_INTV, 4), torch.int32),
            "lf_tab": empty((P // OCC2_INTV, 5), torch.int32)}
    if sa_intv == 1:
        # the SA is its own sample, and the marks are 1-row placeholders
        sa = sa_samp = _sa_rows(sa, 0, N, dev)
        for name, shape, dtype in (("b_words", 1, torch.int32),
                                   ("b_occ", 1, torch.int64),
                                   ("b_tab", (1, 3), torch.int32)):
            tabs[name] = torch.zeros(shape, dtype=dtype, device=dev)
    else:
        tabs.update(b_words=empty(P // 32, torch.int32),
                    b_occ=empty(P // B_OCC_INTV, torch.int64),
                    b_tab=empty((P // B_OCC_INTV, 3), torch.int32))
        sa_samp = empty(-(-N // sa_intv), torch.int64)
    occ_off = torch.zeros(4, dtype=torch.int64, device=dev)
    pri = torch.zeros((), dtype=torch.int64, device=dev)
    marks_before = 0  # the sampled SA's next slot
    # bwt[i] = ref[sa[i] - 1], 0 at the sentinel row (reference:
    # fm_index.hpp:310-329): one gather from the text shifted by one
    prev = text.new_zeros(n + 1)
    prev[1:] = text
    for lo in range(0, N, step):
        hi = min(lo + step, N)
        rows_sa = _sa_rows(sa, lo, hi, dev)
        bwt = text.new_zeros((P if hi == N else hi) - lo)  # pads: symbol 0
        bwt[:hi - lo] = prev[rows_sa]
        counts = block_counts(lo, N, bwt, rows_sa, sa_intv)
        block, totals = block_tables(counts, occ_off, marks_before)
        block["bwt_words"] = counts.words
        for name, x in block.items():
            span = P // tabs[name].shape[0]  # rows a table row spans
            tabs[name][lo // span : lo // span + x.shape[0]] = x
        occ_off += totals
        pri += counts.pri
        if sa_intv != 1:
            # the marked rows in row order: the sampled SA (the TPU used a
            # 2-operand sort for this compaction, fm_index.py:213-224)
            picked = rows_sa[counts.marks[:hi - lo]]
            sa_samp[marks_before : marks_before + picked.shape[0]] = picked
            marks_before += picked.shape[0]
        del counts, block, rows_sa, bwt
    # cnt[c] = 1 + the counts of the smaller symbols (the +1 is the
    # sentinel, reference: fm_index.hpp:303-307)
    cnt = torch.cumsum(occ_off, dim=0) - occ_off + 1
    lookup = torch.tensor([0, N], dtype=torch.int64, device=dev)
    return trim_canonical(
        FMArrays(cnt=cnt, pri=pri, sa_samp=sa_samp, lookup=lookup, **tabs),
        N, sa_intv)


def _fuse_lf_tab(occ1, occ2, bwt_words) -> torch.Tensor:
    """lf_tab[j] = [absolute per-symbol counts before 16-block j
    (occ1[j // 16] + occ2[j], 4 cols), packed BWT word j], as uint32 bits:
    an LF step reads ONE table row. Device-side only; the serialized
    ``.fmi`` keeps the reference's two-level layout (fm_index.hpp:
    106-128) byte-exactly."""
    nb2 = occ2.shape[0]
    reps = torch.repeat_interleave(
        occ1.to(torch.int64), OCC1_INTV // OCC2_INTV, dim=0
    )[:nb2]
    occf = reps + occ2.to(torch.int64)
    words = torch.zeros(nb2, dtype=torch.int64, device=occ2.device)
    k = min(bwt_words.shape[0], nb2)
    words[:k] = pack.as_u32(bwt_words[:k])
    return pack.to_u32_bits(torch.cat([occf, words[:, None]], dim=1))


def _fuse_b_tab(b_occ, b_words) -> torch.Tensor:
    """b_tab[blk] = [mark-rank prefix b_occ[blk], mark words 2blk and
    2blk+1] as uint32 bits: mark probes and mark ranks (compute_b_occ,
    reference: fm_index.hpp:189-208) each read ONE row."""
    nb = b_occ.shape[0]
    w = torch.zeros(2 * nb, dtype=torch.int64, device=b_occ.device)
    k = min(b_words.shape[0], 2 * nb)
    w[:k] = pack.as_u32(b_words[:k])
    return pack.to_u32_bits(
        torch.stack([b_occ.to(torch.int64), w[0::2], w[1::2]], dim=1)
    )


# ---------------------------------------------------------------------------
# query primitives (plain PyTorch; the kernels' counterparts)
# ---------------------------------------------------------------------------


def _sel4(row4: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """row4[..., c]."""
    return torch.gather(row4, -1, c.unsqueeze(-1)).squeeze(-1)


def _occ(idx: FMArrays, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Vectorized compute_occ (reference: fm_index.hpp:166-182) from ONE
    ``lf_tab`` row: the absolute counts of all 4 symbols plus the packed
    BWT word. The sentinel row packs as symbol 0 but counts as none."""
    row = pack.as_u32(idx.lf_tab[i // OCC2_INTV])
    t = i % OCC2_INTV
    partial_cnt = pack.count_symbol_prefix(row[..., 4], c, t)
    beg = i - t
    pass_pri = (c == 0) & (beg <= idx.pri) & (idx.pri < i)
    return _sel4(row[..., :4], c) + partial_cnt - pass_pri.to(torch.int64)


def _lf(idx: FMArrays, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return idx.cnt[c] + _occ(idx, c, i)


def _bwt_at(idx: FMArrays, i: torch.Tensor) -> torch.Tensor:
    word = pack.as_u32(idx.lf_tab[i // OCC2_INTV, 4])
    return (word >> (2 * (i % OCC2_INTV))) & 3


def _lf_own_symbol(idx: FMArrays, i: torch.Tensor) -> torch.Tensor:
    """lf(bwt[i], i) (compute_sa's step, reference: fm_index.hpp:
    210-222)."""
    return _lf(idx, _bwt_at(idx, i), i)


def _lf_all4(idx: FMArrays, i: torch.Tensor) -> torch.Tensor:
    """lf(c, i) for ALL 4 symbols from ONE ``lf_tab`` row gather, shape
    [..., 4]: the fused row carries every symbol's absolute count plus
    the packed word, so a 4-way range expansion costs one gather per
    endpoint, not four (reference runs compute_occ once per (symbol,
    bound), fm_index.hpp:453-501 + 166-182)."""
    row = pack.as_u32(idx.lf_tab[i // OCC2_INTV])
    t = i % OCC2_INTV
    occ = row[..., :4] + torch.stack(
        [pack.count_symbol_prefix(row[..., 4], c, t) for c in range(4)],
        dim=-1,
    )
    # the sentinel row packs as symbol 0 but counts as none
    pass_pri = (i - t <= idx.pri) & (idx.pri < i)
    occ[..., 0] -= pass_pri.to(torch.int64)
    return idx.cnt + occ


def _b_rank(idx: FMArrays, i: torch.Tensor) -> torch.Tensor:
    """Vectorized compute_b_occ (reference: fm_index.hpp:189-208): marks
    in rows [0, i) from one ``b_tab`` row. ``b_tab`` has no row for a
    block that starts at row N (N a multiple of 64), which a range
    endpoint reaches: there the count is that of all marks, as in
    :func:`block_table`."""
    rows = idx.b_tab.shape[0]
    blk = i // B_OCC_INTV
    off = i - blk * B_OCC_INTV  # 0..63
    past = blk >= rows
    row = pack.as_u32(idx.b_tab[torch.clamp(blk, max=rows - 1)])
    one = torch.ones_like(off)
    m0 = (one << torch.clamp(off, max=32)) - 1
    m1 = (one << torch.clamp(off - 32, min=0)) - 1
    cnt = pack.popcount_u32(row[..., 1] & m0) + pack.popcount_u32(
        row[..., 2] & m1
    )
    return torch.where(past, idx.sa_samp.shape[0], row[..., 0] + cnt)


def _b_at(idx: FMArrays, i: torch.Tensor) -> torch.Tensor:
    row = pack.as_u32(idx.b_tab[i // B_OCC_INTV])
    odd = ((i // 32) % 2) == 1
    w = torch.where(odd, row[..., 2], row[..., 1])
    return ((w >> (i % 32)) & 1) == 1


def _device_of(idx: FMArrays) -> torch.device:
    return idx.lf_tab.device


def _kernel_inputs(idx: FMArrays, blocks: FMBlocks, **extra) -> None:
    """Validate an index, its block table and extra inputs handed to a
    kernel."""
    dev = _device_of(idx)
    kernels.require(blocks.blk, "blocks.blk", torch.int32, 2)
    kernels.require(blocks.sup, "blocks.sup", torch.int64, 2)
    kernels.require(blocks.samp_sum, "blocks.samp_sum", torch.int64, 1)
    kernels.require(idx.pri, "pri", torch.int64, 0)
    kernels.require(idx.sa_samp, "sa_samp", torch.int64, 1)
    kernels.require(idx.lookup, "lookup", torch.int64, 1)
    nblk, nsup = _table_rows(idx)
    if (blocks.blk.shape != (nblk, 8) or blocks.sup.shape != (nsup, 8)
            or blocks.samp_sum.shape[0] != idx.sa_samp.shape[0] + 1):
        raise ValueError("blocks is not the block table of this index")
    kernels.require_cuda(
        {"blocks.blk": blocks.blk, "blocks.sup": blocks.sup,
         "blocks.samp_sum": blocks.samp_sum, "pri": idx.pri,
         "sa_samp": idx.sa_samp, "lookup": idx.lookup, **extra},
        dev,
    )


# ---------------------------------------------------------------------------
# K2: backward search
# ---------------------------------------------------------------------------


def get_range_packed_device_plain(idx: FMArrays, qwords: torch.Tensor,
                                  qlen: int, lookup_len: int,
                                  early_stop: bool = True):
    """Plain version of K2: the per-step loop over the whole batch."""
    q = qwords.shape[0]
    dev = qwords.device
    qw = pack.as_u32(qwords)

    def char(j: int) -> torch.Tensor:
        return (qw[:, j // 16] >> (2 * (j % 16))) & 3

    beg = torch.zeros(q, dtype=torch.int64, device=dev)
    end = idx.lookup[-1].expand(q).clone()
    steps = qlen
    if lookup_len and qlen >= lookup_len:
        # seed from the lookup table on the last lookup_len characters
        # (reference: fm_index.hpp:574-584)
        key = torch.zeros(q, dtype=torch.int64, device=dev)
        for j in range(qlen - lookup_len, qlen):
            key = (key << 2) | char(j)
        beg = idx.lookup[key]
        end = idx.lookup[key + 1]
        steps = qlen - lookup_len
    offs = torch.full((q,), steps, dtype=torch.int64, device=dev)
    for j in range(steps - 1, -1, -1):
        # walk characters right-to-left (reference: compute_range,
        # fm_index.hpp:224-235)
        c = char(j)
        nbeg = _lf(idx, c, beg)
        nend = _lf(idx, c, end)
        if early_stop:
            alive = end > beg
            beg = torch.where(alive, nbeg, beg)
            end = torch.where(alive, nend, end)
            offs = torch.where(alive, j, offs)
        else:
            beg, end = nbeg, nend
            offs = torch.full_like(offs, j)
    return beg, end, offs


def get_range_packed_device(idx: FMArrays, qwords: torch.Tensor, qlen: int,
                            lookup_len: int, early_stop: bool = True, *,
                            blocks: FMBlocks):
    """Backward search of Q patterns of length ``qlen``, 2-bit packed
    (``qwords``: int32 bits [Q, ceil(qlen/16)], symbol j of query q at
    bits 2*(j%16) of word j//16). Returns (beg, end, offs) int64[Q];
    ``offs`` counts the unmatched leading characters (0 on success),
    compute_range's early-stop semantics (reference: fm_index.hpp:
    224-235). ``early_stop=False`` keeps walking an empty range (the
    lookup-table build). CUDA tensors launch kernel K2
    ``fm_backward_search`` (csrc/fm_search.cu), which reads ``blocks``,
    the index's :func:`block_table`; CPU tensors run the plain version,
    which reads ``lf_tab`` and not ``blocks``."""
    with timing.span("kiss.query.search"):
        kernels.require(qwords, "qwords", torch.int32, 2)
        if qwords.shape[1] != -(-qlen // 16):
            raise ValueError(
                f"qwords has {qwords.shape[1]} words per query; qlen "
                f"{qlen} needs {-(-qlen // 16)}"
            )
        if lookup_len and 4**lookup_len + 1 != idx.lookup.shape[0]:
            raise ValueError(
                "lookup_len does not match the index's lookup table")
        q = qwords.shape[0]
        timing.add("k2_queries", q)
        # one seed lookup a query: the pair lookup[key], lookup[key + 1]
        timing.add("k2_lookup_reads",
                   q if lookup_len and qlen >= lookup_len else 0)
        if qwords.device.type == "cpu":
            return get_range_packed_device_plain(idx, qwords, qlen,
                                                 lookup_len, early_stop)
        _kernel_inputs(idx, blocks, qwords=qwords)
        dev = qwords.device
        beg = torch.empty(q, dtype=torch.int64, device=dev)
        end = torch.empty(q, dtype=torch.int64, device=dev)
        offs = torch.empty(q, dtype=torch.int64, device=dev)
        lib = kernels.library()
        with torch.cuda.device(dev):
            kernels.check(
                lib.kt_fm_backward_search(
                    blocks.blk.data_ptr(), blocks.sup.data_ptr(),
                    idx.pri.data_ptr(),
                    idx.lookup.data_ptr(), idx.lookup.shape[0],
                    qwords.data_ptr(),
                    q, qwords.shape[1], qlen, lookup_len, int(early_stop),
                    beg.data_ptr(), end.data_ptr(), offs.data_ptr(),
                    kernels.stream_of(dev),
                ),
                "kt_fm_backward_search",
            )
        kernels.count_launch("fm_backward_search")
        return beg, end, offs


def _packed_queries(queries, device) -> torch.Tensor:
    """Host int8[Q, m] patterns -> int32-bit packed words on ``device``."""
    words = pack.np_pack_queries_2bit(np.asarray(queries))
    return torch.from_numpy(words.view(np.int32)).to(device)


def get_range_device(idx: FMArrays, queries, lookup_len: int,
                     early_stop: bool = True, *,
                     blocks: FMBlocks):
    """Backward search for int8[Q, m] patterns (symbols 0..3): packed on
    the host, then the same kernel as :func:`get_range_packed_device`."""
    if isinstance(queries, torch.Tensor):
        queries = queries.cpu().numpy()
    m = np.asarray(queries).shape[1]
    return get_range_packed_device(
        idx, _packed_queries(queries, _device_of(idx)), m, lookup_len,
        early_stop, blocks=blocks,
    )


def counts_packed_device(idx: FMArrays, qwords: torch.Tensor, qlen: int,
                         lookup_len: int, *,
                         blocks: FMBlocks) -> torch.Tensor:
    """Per-query occurrence counts (end - beg), int64 -- the count-only
    form of the batch loop (reference: include/command/
    fmindex_query.hpp:66-99 accumulates ``occ += end - beg``)."""
    beg, end, _ = get_range_packed_device(idx, qwords, qlen, lookup_len,
                                          blocks=blocks)
    return end - beg


# ---------------------------------------------------------------------------
# K3: locate walk and batch stats
# ---------------------------------------------------------------------------


def locate_rows_device_plain(idx: FMArrays, rows: torch.Tensor,
                             sa_intv: int):
    """Plain version of K3's row entry point: masked LF walk of at most
    sa_intv-1 steps until a sampled row, then one sa_samp read."""
    if sa_intv == 1:
        return idx.sa_samp[rows]
    i = rows.to(torch.int64)
    steps = torch.zeros_like(i)
    done = _b_at(idx, i)
    for _ in range(sa_intv - 1):
        nxt = _lf_own_symbol(idx, i)
        i = torch.where(done, i, nxt)
        steps = steps + (~done).to(torch.int64)
        done = _b_at(idx, i)
    return idx.sa_samp[_b_rank(idx, i)] + steps


def locate_rows_device(idx: FMArrays, rows: torch.Tensor, sa_intv: int, *,
                       blocks: FMBlocks):
    """Text positions (int64) of suffix-array ``rows`` (int64): the
    vectorized compute_sa (reference: fm_index.hpp:210-222). CUDA
    tensors launch kernel K3's ``fm_locate_rows`` entry point
    (csrc/fm_locate.cu), which reads ``blocks``, the index's
    :func:`block_table`; CPU tensors run the plain version, which reads
    ``lf_tab`` and ``b_tab`` and not ``blocks``."""
    kernels.require(rows, "rows", torch.int64, 1)
    if rows.device.type == "cpu":
        return locate_rows_device_plain(idx, rows, sa_intv)
    _kernel_inputs(idx, blocks, rows=rows)
    out = torch.empty_like(rows)
    lib = kernels.library()
    with torch.cuda.device(rows.device):
        kernels.check(
            lib.kt_fm_locate_rows(
                blocks.blk.data_ptr(), blocks.sup.data_ptr(),
                idx.pri.data_ptr(),
                idx.sa_samp.data_ptr(), sa_intv,
                rows.data_ptr(), rows.shape[0], out.data_ptr(),
                kernels.stream_of(rows.device),
            ),
            "kt_fm_locate_rows",
        )
    kernels.count_launch("fm_locate_rows")
    return out


def batch_locate_stats_device_plain(idx: FMArrays, beg: torch.Tensor,
                                    end: torch.Tensor, sa_intv: int):
    """Plain version of K3's stats entry point: ragged expansion of the
    ranges into rows, the walk, and the sum."""
    lens = end - beg
    total = int(lens.sum())
    if total == 0:
        return 0, 0
    starts = torch.cumsum(lens, dim=0) - lens
    r = torch.arange(total, dtype=torch.int64, device=beg.device)
    q = torch.searchsorted(starts, r, right=True) - 1
    rows = beg[q] + (r - starts[q])
    pos = locate_rows_device_plain(idx, rows, sa_intv)
    return total, int(pos.sum())


def batch_locate_stats_device(idx: FMArrays, beg: torch.Tensor,
                              end: torch.Tensor, sa_intv: int, *,
                              blocks: FMBlocks):
    """(total occurrences, location checksum) of the row ranges
    [beg, end) of a query batch -- the two accumulators of the reference
    batch loop (reference: include/command/fmindex_query.hpp:87-94) --
    as Python ints. The checksum is the sum of every located position,
    the integer that kiss_tpu assembles as sum(lo) + (sum(hi) << 16).
    CUDA tensors launch kernel K3's ``fm_locate_stats`` entry point, a
    fused expand + walk + reduce pass over ``blocks``, the index's
    :func:`block_table` (csrc/fm_locate.cu); CPU tensors run the plain
    version, which reads ``lf_tab`` and ``b_tab`` and not ``blocks``. The host waits once, for the two integers, which are all
    that leaves the device."""
    with timing.span("kiss.query.locate"):
        kernels.require(beg, "beg", torch.int64, 1)
        kernels.require(end, "end", torch.int64, 1)
        if beg.shape != end.shape:
            raise ValueError("beg and end differ in shape")
        if beg.device.type == "cpu":
            return batch_locate_stats_device_plain(idx, beg, end, sa_intv)
        _kernel_inputs(idx, blocks, beg=beg, end=end)
        if beg.shape[0] == 0:
            return 0, 0
        # the kernel reads the total from the inclusive prefix sum of the
        # lengths and writes (total, checksum): no wait before the launch
        incl = torch.cumsum(end - beg, dim=0)
        out = torch.empty(2, dtype=torch.int64, device=beg.device)
        lib = kernels.library()
        with torch.cuda.device(beg.device):
            kernels.check(
                lib.kt_fm_locate_stats(
                    blocks.blk.data_ptr(), blocks.sup.data_ptr(),
                    idx.pri.data_ptr(),
                    idx.sa_samp.data_ptr(), sa_intv, beg.data_ptr(),
                    incl.data_ptr(),
                    beg.shape[0], out.data_ptr(),
                    kernels.stream_of(beg.device),
                ),
                "kt_fm_locate_stats",
            )
        kernels.count_launch("fm_locate_stats")
        with timing.span("kiss.query.wait"):
            total, checksum = out.tolist()
        return total, checksum


# ---------------------------------------------------------------------------
# range BFS: locate on an index whose source SA is only k-ordered
# ---------------------------------------------------------------------------


# The largest sa_intv kernel K4 takes: its level bookkeeping is sized at
# compile time (csrc/fm_bfs.cu).
BFS_MAX_INTV = 32
BFS_TILE = 128  # queries a block of K4 walks together
_BFS_NODE_BYTES = 9  # a node of K4's pool: two int32 rows, its query (int8)


def bfs_locate_device_plain(idx: FMArrays, beg: torch.Tensor,
                            end: torch.Tensor, sa_intv: int) -> torch.Tensor:
    """Plain version of K4's locate entry point: the vectorized FMTree BFS
    (reference: fm_index.hpp:453-501).

    Expands every query range by all 4 symbols per depth -- lf applied
    to RANGE ENDPOINTS only, never per row -- and emits, at each depth d,
    the sa_samp span of marked rows inside each range, +d. Endpoint lf
    is pure counting, so this is exact for an index whose source SA is
    only k-ordered (k >= sa_intv - 1 + pattern length), in particular
    for ``.fmi`` archives written by the reference binary (its build is
    32-ordered, fm_index.hpp:384-386), where the per-row walk returns
    wrong positions on long repeats. The reference expands singleton
    ranges via bwt[beg] only (fm_index.hpp:486-489); uniform all-4
    expansion is the same set (the other 3 subranges are empty).

    Each occurrence at text position p is emitted exactly once, at depth
    p % sa_intv, so the emission count equals sum(end - beg). Returns the
    positions, int64[sum of the segment lengths], in kiss_tpu's order:
    query-major, within a query by depth, within a depth by column (child
    = parent * 4 + symbol). The output is sized by the true total (one
    host sync), so there is no capacity padding and no validity mask.

    Memory: the widest intermediate is the ``lf_tab`` row gather of the
    last widening, int64 [Q, 4 ** (sa_intv - 2), 5] per endpoint (64 MB
    at Q = 100,000, sa_intv = 4).
    """
    Q = beg.shape[0]
    dev = beg.device
    bs, es = beg[:, None], end[:, None]
    seg_b, seg_l, seg_d = [], [], []
    for d in range(sa_intv):
        rb = _b_rank(idx, bs)
        seg_b.append(rb)
        seg_l.append(_b_rank(idx, es) - rb)
        seg_d.append(torch.full((bs.shape[1],), d, dtype=torch.int64,
                                device=dev))
        if d + 1 < sa_intv:
            w = 4 * bs.shape[1]  # child = parent * 4 + symbol
            bs = _lf_all4(idx, bs).reshape(Q, w)
            es = _lf_all4(idx, es).reshape(Q, w)
    segb = torch.cat(seg_b, dim=1).reshape(-1)
    segl = torch.cat(seg_l, dim=1).reshape(-1)
    segd = torch.cat(seg_d).repeat(Q)
    total = int(segl.sum())
    starts = torch.cumsum(segl, dim=0) - segl  # exclusive prefix
    # slot r of segment s reads sa_samp[segb[s] + (r - starts[s])]
    base = torch.repeat_interleave(segb - starts, segl, output_size=total)
    depth = torch.repeat_interleave(segd, segl, output_size=total)
    r = torch.arange(total, dtype=torch.int64, device=dev)
    return idx.sa_samp[base + r] + depth


def batch_bfs_stats_device_plain(idx: FMArrays, beg: torch.Tensor,
                                 end: torch.Tensor, sa_intv: int):
    """Plain version of K4's stats entry point: the BFS's positions,
    counted and summed."""
    pos = bfs_locate_device_plain(idx, beg, end, sa_intv)
    return pos.shape[0], int(pos.sum())


def _check_ranges(beg: torch.Tensor, end: torch.Tensor) -> None:
    kernels.require(beg, "beg", torch.int64, 1)
    kernels.require(end, "end", torch.int64, 1)
    if beg.shape != end.shape:
        raise ValueError("beg and end differ in shape")


def _bfs_kernel_inputs(idx: FMArrays, blocks, sa_intv: int,
                       **extra) -> None:
    """Validate what kernel K4 reads: the index, its block table (which
    the CPU's plain version does not need), sa_intv and ``extra``."""
    if blocks is None:
        raise ValueError(
            "the range BFS of CUDA tensors launches kernel K4, which reads "
            "the index's block table: pass blocks="
        )
    if not 2 <= sa_intv <= BFS_MAX_INTV:
        raise ValueError(
            f"kernel K4 takes sa_intv 2 .. {BFS_MAX_INTV}, not {sa_intv}"
        )
    _kernel_inputs(idx, blocks, **extra)
    if blocks.blk.shape[0] * 64 > 2**32:
        raise ValueError("kernel K4 holds rows in 32 bits: the index has "
                         "2^32 rows or more")


def bfs_guess(q: int) -> tuple[int, int]:
    """(segments, pool nodes) a K4 launch of ``q`` ranges is first given:
    about one segment a range and a few spilled nodes a range on a batch of
    reads; a launch that needs more says so and runs again."""
    return 2 * q + 4096, q + 65536


def bfs_until_it_fits(run, seg_cap: int, pool_cap: int):
    """Run a K4 launch until its outputs fit. ``run(seg_cap, pool_cap)``
    launches with those capacities and returns (its result, the segments
    it found, the pool nodes its spilled queries need). The pool need
    depends on the ranges alone; the segments are counted in full even
    where the writes were dropped, but may be short when the pool did not
    fit, so a third launch is possible. Returns the result of the launch
    that fit."""
    while True:
        result, segs, pool = run(seg_cap, pool_cap)
        if segs <= seg_cap and pool <= pool_cap:
            return result
        seg_cap, pool_cap = max(seg_cap, segs), max(pool_cap, pool)


def bfs_locate_device(idx: FMArrays, beg: torch.Tensor, end: torch.Tensor,
                      sa_intv: int, *, blocks: FMBlocks | None = None
                      ) -> torch.Tensor:
    """Positions (int64, grouped query-major) of the row ranges
    [beg, end) by the range BFS: kiss_tpu's ``bfs_locate_device`` without
    its capacity padding (its ``pos[:total]``), in its order. CUDA tensors
    launch kernel K4's locate entry point (csrc/fm_bfs.cu), which reads
    ``blocks``, the index's :func:`block_table` (required there): one walk
    of each tree writes the segments in order, the host reads their count
    and the positions' once, and a second kernel writes the positions. CPU
    tensors run the plain version."""
    _check_ranges(beg, end)
    if beg.device.type == "cpu":
        return bfs_locate_device_plain(idx, beg, end, sa_intv)
    _bfs_kernel_inputs(idx, blocks, sa_intv, beg=beg, end=end)
    dev = beg.device
    q = beg.shape[0]
    if q == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    tabs = (blocks.blk.data_ptr(), blocks.sup.data_ptr(), idx.pri.data_ptr())
    # the report (segments, positions, spilled queries, pool need), the
    # tile ticket and each tile's look-back status
    scratch = torch.empty(5 + 5 * -(-q // BFS_TILE), dtype=torch.int64,
                          device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = kernels.stream_of(dev)

        def run(seg_cap, pool_cap):
            pool = torch.empty(_BFS_NODE_BYTES * pool_cap, dtype=torch.uint8,
                               device=dev)
            segs = torch.empty((2, seg_cap), dtype=torch.int64, device=dev)
            kernels.check(
                lib.kt_fm_bfs_segments(
                    *tabs, sa_intv, beg.data_ptr(), end.data_ptr(), q,
                    pool.data_ptr(), pool_cap, segs[0].data_ptr(),
                    segs[1].data_ptr(), seg_cap, scratch.data_ptr(), stream,
                ),
                "kt_fm_bfs_segments",
            )
            nseg, total, spilled, need = scratch[:4].tolist()
            return (segs, nseg, total, spilled), nseg, need

        segs, nseg, total, spilled = bfs_until_it_fits(run, *bfs_guess(q))
        out = torch.empty(total, dtype=torch.int64, device=dev)
        kernels.check(
            lib.kt_fm_bfs_expand(
                idx.sa_samp.data_ptr(), segs[0].data_ptr(),
                segs[1].data_ptr(), nseg, total, out.data_ptr(), stream,
            ),
            "kt_fm_bfs_expand",
        )
    kernels.count_launch("fm_bfs_locate")
    kernels.SPILLED["fm_bfs_locate"] += spilled
    return out


def batch_bfs_stats_device(idx: FMArrays, beg: torch.Tensor,
                           end: torch.Tensor, sa_intv: int, *,
                           blocks: FMBlocks | None = None):
    """(positions emitted, location checksum) of the range BFS of the row
    ranges [beg, end) -- the locate path for indexes whose SA order is not
    known fully sorted. Inside the BFS contract (k >= sa_intv - 1 + the
    pattern length) the count is sum(end - beg), like
    :func:`batch_locate_stats_device`'s; :func:`bfs_query_stats` reports
    that sum in any case. The checksum is one int64 sum of the positions,
    the integer kiss_tpu assembles as sum(lo) + (sum(hi) << 16). CUDA
    tensors launch kernel K4's stats entry point (csrc/fm_bfs.cu), one walk
    of the queries' trees that reads ``blocks`` (required there) and sums
    each node's positions from ``blocks.samp_sum``; the host waits once,
    for the integers. CPU tensors run the plain version."""
    emitted, checksum, _ = _bfs_stats(idx, beg, end, sa_intv, blocks)
    return emitted, checksum


def bfs_query_stats(idx: FMArrays, beg: torch.Tensor, end: torch.Tensor,
                    sa_intv: int, *, blocks: FMBlocks | None = None):
    """(total occurrences, location checksum) of a query batch on the BFS
    route, as kiss_tpu's ``batch_query_stats`` reports them: the total is
    the ranges' rows, sum(end - beg) (outside the BFS contract the BFS
    emits another number of positions), the checksum the BFS's. On a card
    the sum comes back in the kernel's one download."""
    _, checksum, rows = _bfs_stats(idx, beg, end, sa_intv, blocks)
    return rows, checksum


def _bfs_stats(idx: FMArrays, beg: torch.Tensor, end: torch.Tensor,
               sa_intv: int, blocks):
    """(positions emitted, checksum, sum(end - beg)) by kernel K4's stats
    entry point, or its plain version on CPU tensors."""
    with timing.span("kiss.query.bfs"):
        _check_ranges(beg, end)
        if beg.device.type == "cpu":
            emitted, checksum = batch_bfs_stats_device_plain(idx, beg, end,
                                                             sa_intv)
            return emitted, checksum, int((end - beg).sum())
        _bfs_kernel_inputs(idx, blocks, sa_intv, beg=beg, end=end)
        q = beg.shape[0]
        if q == 0:
            return 0, 0, 0
        dev = beg.device
        # the kernel's report (total, checksum, spilled, pool need), then
        # the ranges' rows, summed here before the launch
        out = torch.empty(5, dtype=torch.int64, device=dev)
        out[4] = (end - beg).sum()
        lib = kernels.library()
        with torch.cuda.device(dev):
            stream = kernels.stream_of(dev)

            def run(_, pool_cap):
                pool = torch.empty(_BFS_NODE_BYTES * pool_cap,
                                   dtype=torch.uint8, device=dev)
                kernels.check(
                    lib.kt_fm_bfs_stats(
                        blocks.blk.data_ptr(), blocks.sup.data_ptr(),
                        idx.pri.data_ptr(), blocks.samp_sum.data_ptr(),
                        sa_intv,
                        beg.data_ptr(), end.data_ptr(), q, pool.data_ptr(),
                        pool_cap, out.data_ptr(), stream,
                    ),
                    "kt_fm_bfs_stats",
                )
                with timing.span("kiss.query.wait"):
                    total, checksum, spilled, need, rows = out.tolist()
                return (total, checksum, spilled, rows), 0, need

            total, checksum, spilled, rows = bfs_until_it_fits(
                run, 0, bfs_guess(q)[1])
        kernels.count_launch("fm_bfs_stats")
        kernels.SPILLED["fm_bfs_stats"] += spilled
        return total, checksum, rows


# ---------------------------------------------------------------------------
# archive provenance sidecar (verbatim from kiss_tpu.models.fm_index)
# ---------------------------------------------------------------------------

# The `.fmi` format records no sort depth (reference: fm_index.hpp:
# 591-646), so builds written by this tool record their provenance in a
# JSON sidecar next to the archive, bound to the archive's content.
META_SUFFIX = ".meta"
_META_PROBE = 1 << 16  # bytes hashed per probe window (large archives)
_META_STRIDE = 1 << 24  # probe every 16 MiB across large archives
_META_FULL_HASH = 1 << 28  # archives up to 256 MiB are hashed in full


def _archive_fingerprint(fmi_path: str) -> tuple[int, int]:
    """(size, crc32 over 64 KiB windows every 16 MiB plus the tail):
    cheap content binding for the sidecar, so a sidecar does not survive
    the archive being rebuilt by another writer. Archives up to
    ``_META_FULL_HASH`` are hashed in FULL; larger ones are sampled
    every 16 MiB plus the tail."""
    import zlib

    size = os.path.getsize(fmi_path)
    crc = 0
    with open(fmi_path, "rb") as f:
        if size <= _META_FULL_HASH:
            while True:
                chunk = f.read(1 << 22)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
            return size, crc
        for off in range(0, size, _META_STRIDE):
            f.seek(off)
            crc = zlib.crc32(f.read(_META_PROBE), crc)
        f.seek(size - _META_PROBE)
        crc = zlib.crc32(f.read(_META_PROBE), crc)
    return size, crc


def write_meta(fmi_path: str, *, full_sa: bool, sort_len,
               lookup_len: int) -> None:
    """Record build provenance for ``fmi_path`` in ``<path>.meta``,
    bound to the archive's content fingerprint."""
    size, crc = _archive_fingerprint(fmi_path)
    meta = {
        "format": 2,
        "writer": "kiss-tpu",
        "full_sa": bool(full_sa),
        "sort_len": sort_len,
        "lookup_len": int(lookup_len),
        "fmi_size": size,
        "fmi_crc32": crc,
    }
    with open(fmi_path + META_SUFFIX, "w") as f:
        json.dump(meta, f)
        f.write("\n")


def read_meta(fmi_path: str) -> dict | None:
    """Provenance for ``fmi_path``, or None when the sidecar is absent,
    unreadable, or no longer matches the archive's content."""
    try:
        with open(fmi_path + META_SUFFIX) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(meta, dict):
        return None
    if "fmi_size" in meta:
        try:
            size, crc = _archive_fingerprint(fmi_path)
        except OSError:
            return None
        if meta.get("fmi_size") != size or meta.get("fmi_crc32") != crc:
            return None
    return meta


def lookup_seed_words(L: int, device) -> torch.Tensor:
    """Every length-L seed, 2-bit packed (int32 bits [4**L, ceil(L/16)]),
    seed i's symbol j the j-th most significant digit of i in base 4: the
    queries of the lookup table's build."""
    keys = torch.arange(4**L, dtype=torch.int64, device=device)
    words = torch.zeros((4**L, -(-L // 16)), dtype=torch.int64, device=device)
    for j in range(L):  # symbol j: first = most significant
        words[:, j // 16] |= ((keys >> (2 * (L - 1 - j))) & 3) << (
            2 * (j % 16)
        )
    return pack.to_u32_bits(words)


def _ragged_rows(beg: np.ndarray, lens: np.ndarray):
    """Host-side ragged expansion of per-query [beg, beg+len) row
    ranges: returns (rows int64[R], starts int64[Q+1]) with
    rows[starts[q]:starts[q+1]] belonging to query q."""
    starts = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    total = int(starts[-1])
    rows = np.repeat(beg.astype(np.int64), lens) + (
        np.arange(total, dtype=np.int64) - np.repeat(starts[:-1], lens)
    )
    return rows, starts


def _u32_tensor(x: np.ndarray, dev) -> torch.Tensor:
    """uint32 host data -> int32-bit tensor on ``dev``."""
    x = np.ascontiguousarray(x, dtype="<u4").view(np.int32)
    return torch.from_numpy(x).to(dev)


# ---------------------------------------------------------------------------
# host-facing model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FMIndex:
    """Host-facing FM-index with the reference's public surface:
    ``build``, ``get_range``, ``get_offsets``, ``save``, ``load``.

    Template parameters of the reference class become constructor
    arguments; the CLI instantiation is ``FMIndex(sa_intv=4,
    lookup_len=0)`` (reference: include/command/fmindex_build.hpp:27-29).
    ``device`` is where the index lives ("cuda" or "cpu"; CUDA that is
    not there is an error).
    """

    sa_intv: int = 4
    lookup_len: int = 0
    arrays: FMArrays | None = None
    n_rows: int = 0  # N = n + 1
    # True when the index is known built from a FULLY sorted SA: locate
    # may use the per-row LF walk. False (bounded-sort_len builds,
    # archives loaded from disk): locate needs the range BFS.
    full_sa: bool = True
    device: str | torch.device = "cuda"
    # the query kernels' table (block_table of arrays), made with them
    blocks: FMBlocks | None = None

    @property
    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    # -- build ------------------------------------------------------------

    def build(
        self, ref: np.ndarray, sa=None, sort_len: int | None = SORT_LEN
    ) -> "FMIndex":
        """Build from an int8 reference (values 0..3). Unless a suffix
        array is supplied, sorts the full suffix order (the reference's
        counterpart is fm_index.hpp:379-388)."""
        with timing.span("kiss.build", device=True):
            return self._build(ref, sa, sort_len)

    def _build(self, ref, sa, sort_len) -> "FMIndex":
        dev = self._dev
        ref = np.ascontiguousarray(ref, dtype=np.int8)
        if sa is None:
            self.full_sa = (
                sort_len is None or sort_len < 0 or sort_len >= len(ref)
            )
            sa = k_ordered_suffix_array(
                ref, -1 if sort_len is None else sort_len, as_numpy=False,
                device=dev,
            )
        elif isinstance(sa, torch.Tensor):
            sa = sa.to(device=dev, dtype=torch.int64)
        else:
            sa = torch.from_numpy(np.asarray(sa).astype(np.int64)).to(dev)
        # the stopwatch line's time includes the block table, made last
        with timing.span(None, log="fmindex build") as sp:
            with timing.span("kiss.build.tables", device=True):
                arrays = build_index_device(torch.from_numpy(ref).to(dev),
                                            sa, self.sa_intv)
            self.blocks = sp.result(block_table(arrays, self.sa_intv))
        self.arrays = arrays
        self.n_rows = len(ref) + 1
        self._build_lookup()
        return self

    def build_rows(self, ref, sa, *, full_sa: bool,
                   block_rows: int = BUILD_BLOCK_ROWS) -> "FMIndex":
        """Build from int8 text (numpy or a tensor) and its suffix array,
        ``block_rows`` SA rows at a time (:func:`build_index_rows`): the
        text goes to the index's device, the SA (uint32 values, as the
        out-of-core sorter returns it) may stay on the host. ``full_sa``
        says whether the SA is fully sorted (a k-ordered one locates by
        the range BFS). Same tables as :meth:`build` on the same SA."""
        dev = self._dev
        if not isinstance(ref, torch.Tensor):
            ref = torch.from_numpy(np.ascontiguousarray(ref, dtype=np.int8))
        text = ref.to(dev)
        with timing.span(None, log="fmindex build (rows in blocks)") as sp:
            arrays = build_index_rows(text, sa, self.sa_intv, block_rows)
            self.blocks = sp.result(block_table(arrays, self.sa_intv))
        self.arrays = arrays
        self.n_rows = text.shape[0] + 1
        self.full_sa = full_sa
        self._build_lookup()
        return self

    def _build_lookup(self) -> None:
        """Vectorized build_lookup (reference: fm_index.hpp:237-269): one
        batched backward search of every length-L seed, generated on the
        device, with ``early_stop=False`` so absent seeds store their
        sorted insertion point."""
        N = self.n_rows
        dev = _device_of(self.arrays)
        if self.lookup_len == 0:
            lookup = torch.tensor([0, N], dtype=torch.int64, device=dev)
        else:
            L = self.lookup_len
            with timing.span("kiss.build.lookup", device=True):
                beg, _end, _ = get_range_packed_device(
                    self.arrays, lookup_seed_words(L, dev), L, 0,
                    early_stop=False, blocks=self.blocks,
                )
                lookup = torch.cat([beg, torch.tensor([N], device=dev)])
        self.arrays = self.arrays._replace(lookup=lookup)

    # -- queries ----------------------------------------------------------

    def _routes_to_bfs(self) -> bool:
        return self.sa_intv != 1 and not self.full_sa

    def _ranges(self, queries: np.ndarray):
        """Device (beg, end, offs) for int8[Q, m] host patterns."""
        return get_range_device(self.arrays, queries, self.lookup_len,
                                blocks=self.blocks)

    def get_range(self, query: np.ndarray):
        """Single-pattern range; returns (beg, end, offs)."""
        beg, end, offs = self.get_ranges(
            np.asarray(query, dtype=np.int8)[None, :]
        )
        return int(beg[0]), int(end[0]), int(offs[0])

    def get_ranges(self, queries: np.ndarray):
        """Batch backward search: queries int8[Q, m] -> 3 x int64[Q]."""
        queries = np.ascontiguousarray(queries, dtype=np.int8)
        return tuple(x.cpu().numpy() for x in self._ranges(queries))

    def counts(self, queries: np.ndarray) -> np.ndarray:
        """Per-query occurrence counts, uint32[Q] -- the count-only
        batch loop (reference: include/command/fmindex_query.hpp:66-99
        with the locate body skipped)."""
        queries = np.ascontiguousarray(queries, dtype=np.int8)
        if queries.size == 0:
            return np.empty(0, dtype=np.uint32)
        beg, end, _ = self._ranges(queries)
        return (end - beg).cpu().numpy().astype(np.uint32)

    def locate_rows(self, rows: np.ndarray) -> np.ndarray:
        """Text positions (uint32) of suffix-array rows (per-row walk)."""
        rows = np.ascontiguousarray(rows).astype(np.int64)
        if rows.size == 0:
            return np.empty(0, dtype=np.uint32)
        out = locate_rows_device(
            self.arrays, torch.from_numpy(rows).to(_device_of(self.arrays)),
            self.sa_intv, blocks=self.blocks,
        )
        return out.cpu().numpy().astype(np.uint32)

    def _bfs_positions(self, beg, end) -> np.ndarray:
        """Positions (uint32) for per-query ranges via the range BFS
        (grouped query-major; exact on any k-ordered source SA)."""
        dev = _device_of(self.arrays)
        beg = np.atleast_1d(np.asarray(beg)).astype(np.int64)
        end = np.atleast_1d(np.asarray(end)).astype(np.int64)
        pos = bfs_locate_device(
            self.arrays, torch.from_numpy(beg).to(dev),
            torch.from_numpy(end).to(dev), self.sa_intv, blocks=self.blocks,
        )
        return pos.cpu().numpy().astype(np.uint32)

    def get_offsets(self, beg: int, end: int) -> np.ndarray:
        """Positions for one row range (reference: fm_index.hpp:453-501).
        Same result set as the FMTree BFS: computed by the per-row walk
        when the index is known built from a fully sorted SA, and by the
        vectorized BFS itself otherwise (loaded archives, bounded
        sort_len builds)."""
        if self._routes_to_bfs():
            return self._bfs_positions(beg, end)
        return self.locate_rows(np.arange(beg, end, dtype=np.int64))

    def get_offsets_traditional(self, beg: int, end: int) -> np.ndarray:
        """Alias of :meth:`get_offsets` for API parity: the reference's
        "traditional" per-row LF walk (fm_index.hpp:435-447)."""
        return self.get_offsets(beg, end)

    def fmtree(self, seed: np.ndarray) -> np.ndarray:
        """Locate by first searching seed[1:] then extending by the first
        character (reference: fm_index.hpp:503-551). The vectorized
        locate makes the staging unnecessary; the result set matches."""
        seed = np.asarray(seed, dtype=np.int8)
        beg, end, _ = self.get_range(seed)
        return self.get_offsets(beg, end)

    def batch_query(self, queries: np.ndarray):
        """Count + locate a batch of equal-length patterns.

        Returns (counts int64[Q], positions uint32[R], starts int64[Q+1])
        where positions[starts[q]:starts[q+1]] belong to query q
        (reference: include/command/fmindex_query.hpp:66-99).
        """
        beg, end, _ = self.get_ranges(queries)
        lens = (end - beg).astype(np.int64)
        rows, starts = _ragged_rows(beg, lens)
        if self._routes_to_bfs():
            # BFS emission is grouped query-major, so the same starts
            # partition applies
            return lens, self._bfs_positions(beg, end), starts
        return lens, self.locate_rows(rows), starts

    def batch_query_stats(self, queries: np.ndarray) -> tuple[int, int]:
        """(total occurrences, location checksum) for a batch -- the two
        accumulators of the reference batch loop (reference:
        include/command/fmindex_query.hpp:87-94). Everything except two
        integers stays on the device."""
        queries = np.ascontiguousarray(queries, dtype=np.int8)
        if queries.size == 0:
            return 0, 0
        beg, end, _ = self._ranges(queries)
        if self._routes_to_bfs():
            return bfs_query_stats(self.arrays, beg, end, self.sa_intv,
                                   blocks=self.blocks)
        return batch_locate_stats_device(self.arrays, beg, end, self.sa_intv,
                                         blocks=self.blocks)

    # -- serialization ----------------------------------------------------

    def save(self, fout) -> None:
        """Byte-compatible ``.fmi`` writer (reference: fm_index.hpp:
        591-615 + serializer.hpp layout)."""
        a = self.arrays
        N = self.n_rows

        def host(x):
            return x.cpu().numpy()

        def host_u32(x):  # low 32 bits, moved as 4 bytes per entry
            return host(pack.to_u32_bits(x)).view(np.uint32)

        fout.write(host(a.cnt).astype("<u4").tobytes())
        fout.write(np.uint32(int(a.pri)).tobytes())
        # bwt: element count = N, payload = ceil(N/4) bytes
        bwt_bytes = host(a.bwt_words).view(np.uint32).astype("<u4").tobytes()
        serializer.save_range(fout, N, bwt_bytes[: serializer.dibit_bytes(N)])
        occ1 = host_u32(a.occ1).astype("<u4")
        serializer.save_range(fout, occ1.shape[0], occ1)
        occ2 = host(a.occ2).astype(np.uint8)
        serializer.save_range(fout, occ2.shape[0], occ2)
        sa_samp = host_u32(a.sa_samp).astype("<u4")
        serializer.save_range(fout, sa_samp.shape[0], sa_samp)
        lookup = host(a.lookup).astype("<u4")
        serializer.save_range(fout, lookup.shape[0], lookup)
        if self.sa_intv != 1:
            b_bytes = host(a.b_words).view(np.uint32).astype("<u4").tobytes()
            serializer.save_range(
                fout, N, b_bytes[: serializer.bit_u64_bytes(N)]
            )
            b_occ = host_u32(a.b_occ).astype("<u4")
            serializer.save_range(fout, b_occ.shape[0], b_occ)

    def load(self, fin) -> "FMIndex":
        """Byte-compatible ``.fmi`` reader (reference: fm_index.hpp:
        620-646). The loaded index has ``full_sa = False``: the format
        records no sort depth."""
        dev = self._dev
        cnt = np.frombuffer(fin.read(16), dtype="<u4").copy()
        pri = np.frombuffer(fin.read(4), dtype="<u4")[0]
        N, bwt_raw = serializer.load_range(fin, serializer.dibit_bytes)
        pad = -len(bwt_raw) % 4
        bwt_words = np.frombuffer(bwt_raw + b"\0" * pad, dtype="<u4").copy()
        n1, occ1_raw = serializer.load_range(fin, serializer.scalar_bytes(16))
        occ1 = np.frombuffer(occ1_raw, dtype="<u4").reshape(n1, 4).copy()
        n2, occ2_raw = serializer.load_range(fin, serializer.scalar_bytes(4))
        occ2 = np.frombuffer(occ2_raw, dtype=np.uint8).reshape(n2, 4).copy()
        ns, sa_raw = serializer.load_range(fin, serializer.scalar_bytes(4))
        sa_samp = np.frombuffer(sa_raw, dtype="<u4").copy()
        nl, lut_raw = serializer.load_range(fin, serializer.scalar_bytes(4))
        lookup = np.frombuffer(lut_raw, dtype="<u4").copy()
        if self.sa_intv != 1:
            nb, b_raw = serializer.load_range(fin, serializer.bit_u64_bytes)
            if nb != N:
                raise ValueError(".fmi archive: mark vector length != N")
            padb = -len(b_raw) % 4
            b_words = np.frombuffer(b_raw + b"\0" * padb, dtype="<u4").copy()
            nbo, bo_raw = serializer.load_range(
                fin, serializer.scalar_bytes(4)
            )
            b_occ = np.frombuffer(bo_raw, dtype="<u4").copy()
        else:
            b_words = np.zeros(1, np.uint32)
            b_occ = np.zeros(1, np.uint32)
        if fin.read(1):
            raise ValueError(".fmi archive has trailing bytes")

        self.n_rows = N
        self.full_sa = False
        self.lookup_len = max(len(lookup) - 1, 1).bit_length() // 2

        def i64(x):
            return torch.from_numpy(x.astype(np.int64)).to(dev)

        occ1_d, b_occ_d = i64(occ1), i64(b_occ)
        occ2_d = torch.from_numpy(occ2.astype(np.int32)).to(dev)
        bwt_words_d, b_words_d = _u32_tensor(bwt_words, dev), _u32_tensor(
            b_words, dev
        )
        self.arrays = FMArrays(
            bwt_words=bwt_words_d,
            occ1=occ1_d,
            occ2=occ2_d,
            cnt=i64(cnt),
            pri=torch.tensor(int(pri), dtype=torch.int64, device=dev),
            sa_samp=i64(sa_samp),
            b_words=b_words_d,
            b_occ=b_occ_d,
            lookup=i64(lookup),
            lf_tab=_fuse_lf_tab(occ1_d, occ2_d, bwt_words_d),
            b_tab=_fuse_b_tab(b_occ_d, b_words_d),
        )
        self.blocks = block_table(self.arrays, self.sa_intv)
        return self

    def __eq__(self, other) -> bool:
        if not isinstance(other, FMIndex):
            return NotImplemented
        if self.n_rows != other.n_rows or self.sa_intv != other.sa_intv:
            return False
        return all(
            torch.equal(x.cpu(), y.cpu())
            for x, y in zip(self.arrays, other.arrays)
        )
