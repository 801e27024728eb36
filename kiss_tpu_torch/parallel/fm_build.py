"""Sharded FM-index build, PyTorch port.

Port of ``kiss_tpu.parallel.fm_build``: the single-device build
(:func:`kiss_tpu_torch.models.fm_index.build_index_device`) with its
tables made block by block over the mesh:

  - **BWT without a global gather.** ``prev = sa - 1`` over the
    non-sentinel rows is a permutation of [0, n), so after a mesh sort of
    (prev, row) by prev, slot j asks for text[j]; one more mesh sort of
    (row, text) by row delivers the symbols in BWT order. Two 2-word sorts
    (:mod:`kiss_tpu_torch.parallel.dsort`, kernel K1 locally) replace the
    gather ``text[sa - 1]``.
  - **occ, cnt and marks shard by shard.** The rows a shard holds are a
    multiple of 256, so every occ2 block, mark word and b_occ block lies
    in one shard; the only traffic is an all-gather of each shard's
    symbol and mark totals for the exclusive prefix offsets.
  - **Sampled SA by one more sort**: each row's target slot (its global
    mark rank) is computed in its shard, and one 2-word mesh sort by
    target slot is the compaction.

The build takes the SA as blocks in the pipeline's layout
(:func:`kiss_tpu_torch.parallel.mesh.block_rows`, as
:func:`kiss_tpu_torch.parallel.sharded_plan.sharded_sa_blocks` returns
it) and keeps every table in its shards (:func:`build_index_blocks`): no
device holds a length-N array. :func:`tables_to_host` assembles the
canonical tables on the host for ``FMIndex.save``;
:func:`build_index_sharded` is the form with the whole SA on the lead
device and the tables joined there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.parallel.dsort import sort_blocks
from kiss_tpu_torch.parallel.fm_sharded import ShardedArrays, sharded_get_ranges
from kiss_tpu_torch.parallel.mesh import block_rows

# the sampled SA's shard blocks are a multiple of this: one occ1
# superblock, as every row table's (block_rows rounds B to it)
_ROW_ALIGN = fm.OCC1_INTV

class ShardedTables(NamedTuple):
    """An index built on the mesh: this process's blocks of each row
    table (lists over the local shards, on their devices; shard s holds
    the table rows of the global rows [s B, (s + 1) B), and of the sampled
    SA the entries [s Bs, (s + 1) Bs) with Bs = ceil(N / sa_intv) rounded
    up to D * 256, over D), ``cnt`` and ``pri`` on the lead device, and the
    row count N. Pad rows are never selected by queries."""

    bwt_words: list
    occ1: list
    occ2: list
    sa_samp: list
    b_words: list
    b_occ: list
    lf_tab: list
    b_tab: list
    cnt: torch.Tensor
    pri: torch.Tensor
    N: int


# the row tables of a build, each row-sharded over the mesh
_ROW_TABLES = ShardedTables._fields[:8]


class BlockCounts(NamedTuple):
    """What the tables of one block of rows are made from
    (:func:`block_counts`)."""

    words: torch.Tensor  # int32 bits [B / 16]: the BWT, 16 dibits a word
    c16: torch.Tensor  # int64 [B / 16, 4]: each 16-row block's symbols
    marks: torch.Tensor | None  # bool [B]: sampled rows (None: sa_intv 1)
    pri: torch.Tensor  # int64 scalar: the sentinel's row if here, else 0


def block_counts(row0: int, N: int, bwt: torch.Tensor, sa: torch.Tensor,
                 sa_intv: int) -> BlockCounts:
    """The counts of the rows [row0, row0 + B) of an index of N rows from
    their BWT symbols and SA entries (int8 and int64 [B], on one device;
    row0 and B multiples of 256, so every occ2 block, mark word and b_occ
    block lies in one block of rows). Rows from N on are pads: BWT symbol
    0, SA 1 (never the sentinel, never marked)."""
    dev = bwt.device
    gidx = row0 + torch.arange(bwt.shape[0], dtype=torch.int64, device=dev)
    words = pack.pack_dibits_u32(bwt)
    starts = (torch.arange(words.shape[0], dtype=torch.int64, device=dev)
              * fm.OCC2_INTV + row0)
    cut = torch.clamp(N - torch.clamp(starts, max=N), 0, fm.OCC2_INTV)
    c16 = torch.stack(
        [pack.count_symbol_prefix(words, c, cut) for c in range(4)], dim=1)
    # the sentinel row packs as symbol 0 but counts as none
    is_pri = (gidx < N) & (sa == 0)
    c16[:, 0] -= is_pri.reshape(-1, fm.OCC2_INTV).sum(dim=1)
    marks = None if sa_intv == 1 else (gidx < N) & (sa % sa_intv == 0)
    return BlockCounts(words, c16, marks, torch.where(is_pri, gidx, 0).sum())


def block_tables(counts: BlockCounts, occ_off, mark_off) -> dict:
    """The table rows of one block of rows (occ1, occ2, lf_tab and, unless
    the index samples every row, b_words, b_occ and b_tab; the fields of
    :class:`ShardedTables`) from its :func:`block_counts`, given what the
    rows before it carry: each symbol's count (``occ_off``, int64 [4]) and
    the marks (``mark_off``)."""
    per_sup = fm.OCC1_INTV // fm.OCC2_INTV
    g = counts.c16.reshape(-1, per_sup, 4)
    sup_tot = g.sum(dim=1)
    # occ2: exclusive cumsum within each 256-row superblock; occ1: of the
    # superblock totals, offset by the rows before
    occ2 = (torch.cumsum(g, dim=1) - g).reshape(-1, 4)
    occ1 = torch.cumsum(sup_tot, dim=0) - sup_tot + occ_off
    lf = torch.cat([torch.repeat_interleave(occ1, per_sup, dim=0) + occ2,
                    pack.as_u32(counts.words)[:, None]], dim=1)
    out = {"occ1": occ1, "occ2": occ2.to(torch.int32),
           "lf_tab": pack.to_u32_bits(lf)}
    if counts.marks is not None:
        b = counts.marks
        shifts = torch.arange(32, dtype=torch.int64, device=b.device)
        b_words = (b.reshape(-1, 32).to(torch.int64) << shifts).sum(dim=1)
        c64 = b.reshape(-1, fm.B_OCC_INTV).sum(dim=1)
        b_occ = torch.cumsum(c64, dim=0) - c64 + mark_off
        out.update(b_words=pack.to_u32_bits(b_words), b_occ=b_occ,
                   b_tab=pack.to_u32_bits(torch.stack(
                       [b_occ, b_words[0::2], b_words[1::2]], dim=1)))
    return out


def _occ_body(mesh, N: int, sa_intv: int, bwt_blocks, sa_blocks):
    """Blocks of the BWT symbols and the SA (one each a local shard) ->
    each shard's tables (a dict of lists over the local shards: words,
    occ1, occ2, lf_tab, b_words, b_occ, b_tab, samp_key) and the global
    ``cnt`` and ``pri`` on the lead device. The shards' totals are
    exchanged for the offsets each block's tables carry."""
    blk = bwt_blocks[0].shape[0]
    counts = [block_counts(s * blk, N, bwt, sa, sa_intv)
              for s, bwt, sa in zip(mesh.local, bwt_blocks, sa_blocks)]
    pri = mesh.psum([c.pri for c in counts])
    dev_tots = [c.c16.sum(dim=0) for c in counts]
    offsets = mesh.exclusive_scan(dev_tots)
    totals = mesh.psum(dev_tots)
    cnt = torch.cumsum(totals, dim=0) - totals + 1
    if sa_intv == 1:
        mark_offsets = [0] * len(counts)
    else:
        mark_offsets = mesh.exclusive_scan([c.marks.sum() for c in counts])
    n_samp = -(-N // sa_intv)
    out = {name: [] for name in ("words", "occ1", "occ2", "lf_tab",
                                 "b_words", "b_occ", "b_tab", "samp_key")}
    for s, c, off, moff in zip(mesh.local, counts, offsets, mark_offsets):
        tabs = block_tables(c, off, moff)
        out["words"].append(c.words)
        for name in ("occ1", "occ2", "lf_tab"):
            out[name].append(tabs[name])
        dev = c.words.device
        gidx = s * blk + torch.arange(blk, dtype=torch.int64, device=dev)
        if sa_intv == 1:
            out["b_words"].append(torch.zeros(blk // 32, dtype=torch.int32,
                                              device=dev))
            out["b_occ"].append(torch.zeros(blk // fm.B_OCC_INTV,
                                            dtype=torch.int64, device=dev))
            out["b_tab"].append(torch.zeros((blk // fm.B_OCC_INTV, 3),
                                            dtype=torch.int32, device=dev))
            out["samp_key"].append(gidx)
            continue
        for name in ("b_words", "b_occ", "b_tab"):
            out[name].append(tabs[name])
        # each row's global mark rank is its target slot in the sampled
        # SA; unmarked and pad rows get unique keys past every slot, so
        # the sort stays a total order
        bi = c.marks.to(torch.int64)
        out["samp_key"].append(torch.where(
            c.marks, torch.cumsum(bi, 0) - bi + moff, n_samp + gidx))
    return out, cnt, pri


def build_index_blocks(mesh, text, sa_blocks: list,
                       sa_intv: int = 4) -> ShardedTables:
    """text (int8 numpy or tensor, n characters) and the SA's blocks
    (int64 [B] a local shard, the pipeline's layout: rows past n are pads)
    -> the tables, each kept in its shards. Every sort is a mesh sort;
    each shard uploads only its own text block. Equal to
    :func:`kiss_tpu_torch.models.fm_index.build_index_device` on the
    canonical rows (:func:`tables_to_host`)."""
    n = text.shape[0]
    N = n + 1
    B = sa_blocks[0].shape[0]
    rows = [s * B + torch.arange(B, dtype=torch.int64, device=x.device)
            for s, x in zip(mesh.local, sa_blocks)]

    # ---- BWT by sort-gather: prev over the non-sentinel rows is a
    # permutation of [0, n) and the sentinel gets the unique key n, so slot
    # j of the prev-sorted order needs text[j] (0 for the sentinel's slot,
    # the text block's zero past n)
    by_prev = sort_blocks(mesh, [
        pack.to_u32_bits(torch.where(sa == 0, n, sa - 1))[None]
        for sa in sa_blocks], N)
    texts = mesh.scatter_host(text, B)
    by_row = sort_blocks(mesh, [
        torch.stack([p[1], t.view(torch.uint8).to(torch.int32)])
        for p, t in zip(by_prev, texts)], N)
    del by_prev, texts
    # pad rows: BWT symbol 0, SA 1 (never the sentinel, never marked)
    bwt = [torch.where(r < N, o[1], 0).to(torch.int8)
           for r, o in zip(rows, by_row)]
    del by_row
    sa_pad = [torch.where(r < N, sa, 1) for r, sa in zip(rows, sa_blocks)]
    tabs, cnt, pri = _occ_body(mesh, N, sa_intv, bwt, sa_pad)
    del bwt

    # ---- sampled SA: one mesh sort by target slot (the dataflow form of
    # build_sa's serial compaction, fm_index.hpp:331-371), then its first
    # ceil(N / sa_intv) slots re-blocked into Bs-row blocks
    if sa_intv == 1:
        sa_samp = sa_pad
    else:
        samp = sort_blocks(mesh, [
            pack.to_u32_bits(torch.stack([k, sa]))
            for k, sa in zip(tabs["samp_key"], sa_pad)], N)
        ns = -(-N // sa_intv)
        Bs = -(-ns // (mesh.size * _ROW_ALIGN)) * _ROW_ALIGN
        sa_samp = mesh.take([pack.as_u32(o[1]) for o in samp],
                            [s * Bs for s in range(mesh.size)], Bs)
        del samp
    return ShardedTables(
        tabs["words"], tabs["occ1"], tabs["occ2"], sa_samp, tabs["b_words"],
        tabs["b_occ"], tabs["lf_tab"], tabs["b_tab"], cnt, pri, N,
    )


def sharded_lookup(mesh, tables: ShardedTables,
                   lookup_len: int) -> torch.Tensor:
    """The lookup table of an index built on the mesh (``FMIndex.
    _build_lookup``): one backward search of every length-``lookup_len``
    seed, without early stop, over the row-sharded tables. On the lead
    device."""
    N = tables.N
    dev = tables.cnt.device
    if lookup_len == 0:
        return torch.tensor([0, N], dtype=torch.int64, device=dev)
    arrays = ShardedArrays(
        lf_tab=tables.lf_tab, b_tab=tables.b_tab, sa_samp=tables.sa_samp,
        cnt=tables.cnt, pri=tables.pri,
        lookup=torch.tensor([0, N], dtype=torch.int64, device=dev),
    )
    beg, _, _ = sharded_get_ranges(
        mesh, arrays, fm.lookup_seed_words(lookup_len, dev), lookup_len,
        early_stop=False,
    )
    return torch.cat([beg, torch.tensor([N], device=dev)])


def tables_to_host(mesh, tables: ShardedTables, lookup: torch.Tensor,
                   sa_intv: int) -> fm.FMArrays:
    """The canonical (serialization-layout) FMArrays of an index built on
    the mesh, as CPU tensors: each table's blocks downloaded one by one
    and cut by :func:`trim_canonical` -- what ``FMIndex.save`` writes."""
    host = {name: torch.from_numpy(mesh.to_host(getattr(tables, name),
                                                dim=0))
            for name in _ROW_TABLES}
    return trim_canonical(fm.FMArrays(
        cnt=tables.cnt.cpu(), pri=tables.pri.cpu(), lookup=lookup.cpu(),
        **host), tables.N, sa_intv)


def build_index_sharded(mesh, text, sa, sa_intv: int = 4) -> fm.FMArrays:
    """text int8 [n] and the whole sa int64 [N = n + 1] (any device) ->
    FMArrays on the lead device: :func:`build_index_blocks` of the SA's
    blocks, each table joined there, padded to the mesh's blocks (pad
    rows are never selected by queries); the canonical (serialization)
    shapes are its leading rows, see :func:`trim_canonical`."""
    if not isinstance(text, torch.Tensor):
        text = torch.from_numpy(np.ascontiguousarray(text, dtype=np.int8))
    N = text.shape[0] + 1
    B = block_rows(N, mesh.size)
    tables = build_index_blocks(
        mesh, text, mesh.scatter_host(sa.to(torch.int64), B), sa_intv)
    lookup = torch.tensor([0, N], dtype=torch.int64, device=mesh.lead)
    return fm.FMArrays(
        cnt=tables.cnt, pri=tables.pri, lookup=lookup,
        **{name: mesh.join(getattr(tables, name), dim=0)
           for name in _ROW_TABLES})


def trim_canonical(arrays: fm.FMArrays, N: int, sa_intv: int) -> fm.FMArrays:
    """Slice a sharded-built FMArrays down to the canonical
    (serialization-layout) row counts of the single-device build: occ1
    N//256+1, occ2 and lf_tab N//16+1, bwt words ceil(N/16), mark words
    2*ceil(N/64), b_occ and b_tab ceil(N/64) (reference layout:
    fm_index.hpp:106-148)."""
    nb1 = N // fm.OCC1_INTV + 1
    nb2 = N // fm.OCC2_INTV + 1
    nw = -(-N // 16)
    if sa_intv == 1:
        # the single-device build keeps 1-row placeholders for the mark
        # structures when the SA is unsampled
        nbw, nbo = 1, 1
        ns = N
    else:
        nbw = 2 * (-(-N // 64))
        nbo = -(-N // fm.B_OCC_INTV)
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
