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

The tables are joined onto the lead device at the end (the glue of the
port runs there); :func:`trim_canonical` cuts them to the single-device
build's row counts.
"""

from __future__ import annotations

import torch

from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.parallel import dsort

# rows a shard holds are padded to a multiple of this: one occ1 superblock
# (256 rows) is a multiple of every block of the tables (occ2 16, mark
# words 32, b_occ 64)
_ROW_ALIGN = fm.OCC1_INTV


def _padded_rows(N: int, d: int) -> int:
    # N + 1 so the canonical tables' final (partial) block row exists even
    # when N divides the alignment exactly: occ2 has N//16 + 1 rows, and
    # queries read lf_tab[N // 16]
    blk = -(-(N + 1) // d)
    blk = -(-blk // _ROW_ALIGN) * _ROW_ALIGN
    return blk * d


def _exclusive_over_devices(mesh, local_totals: list) -> list:
    """Exclusive prefix of the shards' totals (any shape, one a local
    shard), each on its shard's device: the cross-shard half of the
    count / prefix-sum idiom."""
    allt = mesh.all_gather(local_totals)  # [D, ...]
    return [allt[:s].sum(dim=0).to(x.device)
            for s, x in zip(mesh.local, local_totals)]


def _occ_body(mesh, N: int, sa_intv: int, bwt_blocks, sa_blocks):
    """Blocks of the BWT symbols and the SA (one each a local shard) ->
    each shard's tables (a dict of lists over the local shards: words,
    occ1, occ2, lf_tab, b_words, b_occ, b_tab, samp_key) and the global
    ``cnt`` and ``pri`` on the lead device."""
    blk = bwt_blocks[0].shape[0]
    t = {name: [] for name in ("words", "c16", "gidx", "valid", "is_pri")}
    for s, bwt, sa in zip(mesh.local, bwt_blocks, sa_blocks):
        dev = bwt.device
        gidx = s * blk + torch.arange(blk, dtype=torch.int64, device=dev)
        valid = gidx < N
        words = pack.pack_dibits_u32(bwt)
        starts = (torch.arange(words.shape[0], dtype=torch.int64, device=dev)
                  * fm.OCC2_INTV + s * blk)
        cut = torch.clamp(N - torch.clamp(starts, max=N), 0, fm.OCC2_INTV)
        c16 = torch.stack(
            [pack.count_symbol_prefix(words, c, cut) for c in range(4)],
            dim=1,
        )
        # the sentinel row packs as symbol 0 but counts as none
        is_pri = valid & (sa == 0)
        c16[:, 0] -= is_pri.reshape(-1, fm.OCC2_INTV).sum(dim=1)
        for name, x in (("words", words), ("c16", c16), ("gidx", gidx),
                        ("valid", valid), ("is_pri", is_pri)):
            t[name].append(x)
    pri = mesh.psum([torch.where(p, g, 0).sum()
                     for p, g in zip(t["is_pri"], t["gidx"])])

    # occ2: exclusive cumsum within each 256-row superblock; occ1: of the
    # superblock totals, offset by the shards before
    per_sup = fm.OCC1_INTV // fm.OCC2_INTV
    grps = [c.reshape(-1, per_sup, 4) for c in t["c16"]]
    sup_tots = [g.sum(dim=1) for g in grps]
    dev_tots = [st.sum(dim=0) for st in sup_tots]
    offsets = _exclusive_over_devices(mesh, dev_tots)
    totals = mesh.psum(dev_tots)
    cnt = torch.cumsum(totals, dim=0) - totals + 1
    out = {name: [] for name in ("words", "occ1", "occ2", "lf_tab",
                                 "b_words", "b_occ", "b_tab", "samp_key")}
    for g, st, off, words in zip(grps, sup_tots, offsets, t["words"]):
        occ2 = (torch.cumsum(g, dim=1) - g).reshape(-1, 4)
        occ1 = torch.cumsum(st, dim=0) - st + off[None, :]
        lf = torch.cat([torch.repeat_interleave(occ1, per_sup, dim=0) + occ2,
                        pack.as_u32(words)[:, None]], dim=1)
        out["words"].append(words)
        out["occ1"].append(occ1)
        out["occ2"].append(occ2.to(torch.int32))
        out["lf_tab"].append(pack.to_u32_bits(lf))

    if sa_intv == 1:
        for gidx in t["gidx"]:
            dev = gidx.device
            out["b_words"].append(torch.zeros(blk // 32, dtype=torch.int32,
                                              device=dev))
            out["b_occ"].append(torch.zeros(blk // fm.B_OCC_INTV,
                                            dtype=torch.int64, device=dev))
            out["b_tab"].append(torch.zeros((blk // fm.B_OCC_INTV, 3),
                                            dtype=torch.int32, device=dev))
            out["samp_key"].append(gidx)
        return out, cnt, pri

    marks = [v & (sa % sa_intv == 0) for v, sa in zip(t["valid"], sa_blocks)]
    c64s = [b.reshape(-1, fm.B_OCC_INTV).sum(dim=1) for b in marks]
    b_offsets = _exclusive_over_devices(mesh, [c.sum() for c in c64s])
    n_samp = -(-N // sa_intv)
    for b, c64, off, gidx in zip(marks, c64s, b_offsets, t["gidx"]):
        shifts = torch.arange(32, dtype=torch.int64, device=b.device)
        b_words = (b.reshape(-1, 32).to(torch.int64) << shifts).sum(dim=1)
        b_occ = torch.cumsum(c64, dim=0) - c64 + off
        out["b_words"].append(pack.to_u32_bits(b_words))
        out["b_occ"].append(b_occ)
        out["b_tab"].append(pack.to_u32_bits(
            torch.stack([b_occ, b_words[0::2], b_words[1::2]], dim=1)))
        # each row's global mark rank is its target slot in the sampled
        # SA; unmarked and pad rows get unique keys past every slot, so
        # the sort stays a total order
        bi = b.to(torch.int64)
        out["samp_key"].append(torch.where(b, torch.cumsum(bi, 0) - bi + off,
                                           n_samp + gidx))
    return out, cnt, pri


def build_index_sharded(mesh, text, sa, sa_intv: int = 4) -> fm.FMArrays:
    """text int8 [n] and sa int64 [N = n + 1] (lead device) -> FMArrays on
    the lead device, every row table padded to the mesh-aligned block
    size (pad rows are never selected by queries); the canonical
    (serialization) shapes are its leading rows, see
    :func:`trim_canonical`. Every sort is a mesh sort; the tables are
    made in their shards. Equal to
    :func:`kiss_tpu_torch.models.fm_index.build_index_device` on the
    canonical rows."""
    text = dsort.text_on(mesh, text)
    n = text.shape[0]
    N = n + 1
    d = mesh.size
    npad = _padded_rows(N, d)
    sort_impl = dsort.make_sharded_sort_impl(mesh)
    sa = sa.to(device=mesh.lead, dtype=torch.int64)

    # ---- BWT by sort-gather: prev over the non-sentinel rows is a
    # permutation of [0, n) and the sentinel gets the unique key n, so slot
    # j of the prev-sorted order needs text[j] (0 for the sentinel's slot)
    row = torch.arange(N, dtype=torch.int64, device=mesh.lead)
    prev = torch.where(sa == 0, n, sa - 1)
    by_prev, _ = sort_impl(pack.to_u32_bits(torch.stack([prev, row])))
    text_n = torch.zeros(N, dtype=torch.int32, device=mesh.lead)
    text_n[:n] = text.view(torch.uint8).to(torch.int32)
    by_row, _ = sort_impl(torch.stack([by_prev[1], text_n]))
    del by_prev, text_n

    # ---- pad to the mesh-aligned block size; pad SA rows carry 1 (never
    # the sentinel, never marked)
    bwt_pad = torch.zeros(npad, dtype=torch.int8, device=mesh.lead)
    bwt_pad[:N] = by_row[1].to(torch.int8)
    sa_pad = torch.ones(npad, dtype=torch.int64, device=mesh.lead)
    sa_pad[:N] = sa
    del by_row
    tabs, cnt, pri = _occ_body(mesh, N, sa_intv, mesh.split(bwt_pad),
                               mesh.split(sa_pad))

    # ---- sampled SA: one mesh sort by target slot (the dataflow form of
    # build_sa's serial compaction, fm_index.hpp:331-371)
    if sa_intv == 1:
        sa_samp = sa
    else:
        keys = torch.stack([mesh.join(tabs["samp_key"]), sa_pad])
        samp_sorted, _ = sort_impl(pack.to_u32_bits(keys))
        del keys
        # the sample count rounded up to a whole number of aligned blocks;
        # rows past ceil(N / sa_intv) sort behind every real mark rank and
        # are never gathered
        ns = -(-N // sa_intv)
        ns_pad = -(-ns // (d * _ROW_ALIGN)) * (d * _ROW_ALIGN)
        sa_samp = pack.as_u32(samp_sorted[1, :ns_pad])
    join = {name: mesh.join(tabs[name], dim=0)
            for name in ("words", "occ1", "occ2", "b_words", "b_occ",
                         "lf_tab", "b_tab")}
    lookup = torch.tensor([0, N], dtype=torch.int64, device=mesh.lead)
    return fm.FMArrays(
        join["words"], join["occ1"], join["occ2"], cnt, pri, sa_samp,
        join["b_words"], join["b_occ"], lookup, join["lf_tab"],
        join["b_tab"],
    )


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
        ns = arrays.sa_samp.shape[0]
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
