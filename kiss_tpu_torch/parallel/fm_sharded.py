"""Row-sharded FM-index queries, PyTorch port.

Port of ``kiss_tpu.parallel.fm_sharded``: the INDEX is split over the
mesh (where :func:`kiss_tpu_torch.parallel.mesh.sharded_batch_query`
splits the queries and replicates the index). Shard d holds row-block d
of the fused tables ``lf_tab`` and ``b_tab`` and of the sampled SA; the
queries are replicated, and each LF step resolves its row gathers with one
sum over the mesh: every shard gathers the rows of its own block (the
others contribute zero), and the partial rows are summed -- the
distributed form of the occ and BWT word lookups of compute_occ
(reference: fm_index.hpp:166-182). The serialization-layout tables
(occ1, occ2, b_words, b_occ) are never sharded: ``lf_tab`` and ``b_tab``
hold everything a query reads.

The steps are plain PyTorch ops, as they are jitted XLA in ``kiss_tpu``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.utils import timing


class ShardedFMQuery:
    """Mesh-wide query facade with the FMIndex query surface the CLI uses
    (``get_range`` / ``get_ranges`` / ``get_offsets`` /
    ``batch_query_stats``): the reference's ``-t`` knob (reference:
    src/main.cpp:22-26) as the device mesh over the row-sharded index.
    Results equal the single-device :class:`FMIndex` paths.

    Locate routing mirrors the single-device rules: the row-sharded LF
    walk for full-sort indexes, the range BFS (kernel K4 on a card) on the
    lead device's tables otherwise (exact for k-ordered archives)."""

    def __init__(self, mesh, fmi: fm.FMIndex):
        self.mesh = mesh
        self.fmi = fmi
        self.arrays = shard_fm_arrays(mesh, fmi.arrays)

    # -- ranges -------------------------------------------------------------

    def get_ranges(self, queries: np.ndarray):
        queries = np.ascontiguousarray(queries, dtype=np.int8)
        qwords = fm._packed_queries(queries, self.mesh.lead)
        out = sharded_get_ranges(self.mesh, self.arrays, qwords,
                                 queries.shape[1], self.fmi.lookup_len)
        return tuple(x.cpu().numpy() for x in out)

    def get_range(self, query: np.ndarray):
        beg, end, offs = self.get_ranges(
            np.asarray(query, dtype=np.int8)[None, :]
        )
        return int(beg[0]), int(end[0]), int(offs[0])

    # -- locate -------------------------------------------------------------

    def _locate(self, rows: np.ndarray) -> np.ndarray:
        if rows.size == 0:
            return np.empty(0, dtype=np.uint32)
        rows = torch.from_numpy(np.asarray(rows, dtype=np.int64))
        out = sharded_locate_rows(self.mesh, self.arrays,
                                  rows.to(self.mesh.lead), self.fmi.sa_intv)
        return out.cpu().numpy().astype(np.uint32)

    def get_offsets(self, beg: int, end: int) -> np.ndarray:
        if self.fmi.sa_intv == 1 or self.fmi.full_sa:
            return self._locate(np.arange(beg, end, dtype=np.int64))
        timing.log_debug(
            "sharded query: range-BFS locate runs on the replicated "
            "single-device tables (order-robust path)"
        )
        return self.fmi._bfs_positions(beg, end)

    # -- batch --------------------------------------------------------------

    def batch_query_stats(self, queries: np.ndarray) -> tuple[int, int]:
        """(total occurrences, location checksum): the two accumulators of
        the reference batch loop (reference: include/command/
        fmindex_query.hpp:87-94), the backward search and (for full-sort
        indexes) the locate walk running over the mesh."""
        queries = np.ascontiguousarray(queries, dtype=np.int8)
        if queries.size == 0:
            return 0, 0
        beg, end, _ = self.get_ranges(queries)
        lens = end.astype(np.int64) - beg.astype(np.int64)
        total = int(lens.sum())
        if total == 0:
            return 0, 0
        if self.fmi.sa_intv != 1 and not self.fmi.full_sa:
            # the range BFS's checksum on the lead device's tables (kernel
            # K4 on a card): integers come back, not every position; the
            # total is the ranges' rows, as on a single device
            dev = fm._device_of(self.fmi.arrays)
            _, checksum = fm.batch_bfs_stats_device(
                self.fmi.arrays, torch.from_numpy(beg).to(dev),
                torch.from_numpy(end).to(dev), self.fmi.sa_intv,
                blocks=self.fmi.blocks,
            )
            return total, checksum
        rows, _starts = fm._ragged_rows(beg, lens)
        return total, int(self._locate(rows).astype(np.int64).sum())


class ShardedArrays(NamedTuple):
    """The row-sharded index: this process's blocks of the row tables
    (lists over the local shards, each on its shard's device, the tables
    zero-padded to a multiple of D rows) and the small tables on the lead
    device."""

    lf_tab: list
    b_tab: list
    sa_samp: list
    cnt: torch.Tensor
    pri: torch.Tensor
    lookup: torch.Tensor


def _pad_rows(x: torch.Tensor, d: int) -> torch.Tensor:
    r = -x.shape[0] % d
    if r:
        x = torch.cat([x, x.new_zeros((r,) + tuple(x.shape[1:]))])
    return x


def shard_fm_arrays(mesh, arrays: fm.FMArrays) -> ShardedArrays:
    """Lay the row tables out over the mesh (padded with zero rows, which
    are never selected) and the small tables on the lead device: what
    :func:`sharded_get_ranges` and :func:`sharded_locate_rows` read."""

    def rows(x):
        return mesh.split(_pad_rows(x.to(mesh.lead), mesh.size), dim=0)

    return ShardedArrays(
        lf_tab=rows(arrays.lf_tab), b_tab=rows(arrays.b_tab),
        sa_samp=rows(arrays.sa_samp), cnt=arrays.cnt.to(mesh.lead),
        pri=arrays.pri.to(mesh.lead), lookup=arrays.lookup.to(mesh.lead),
    )


def _block_gather(table: torch.Tensor, idx: torch.Tensor, shard: int):
    """Masked local gather of ``table`` rows (shard ``shard``'s block of a
    row-sharded table) at GLOBAL indices ``idx``; rows other shards own
    give 0. Summing over the mesh completes the distributed gather."""
    rows = table.shape[0]
    local = idx.to(table.device) - shard * rows
    mine = (local >= 0) & (local < rows)
    vals = table[torch.clamp(local, 0, rows - 1)]
    if vals.dim() > mine.dim():
        mine = mine[..., None]
    return torch.where(mine, vals, 0)


def _gather_rows(mesh, blocks: list, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a row-sharded table, on the lead device: one masked
    gather a shard and one sum over the mesh. Only one shard contributes
    each row, so the sum of 32-bit words is exact."""
    return mesh.psum([_block_gather(t, idx, s)
                      for s, t in zip(mesh.local, blocks)])


def _occ_sharded(mesh, arrays: ShardedArrays, c, i):
    """compute_occ against the row-sharded ``lf_tab``: ONE gathered row
    block resolves the per-symbol counts and the packed BWT word
    together (reference: fm_index.hpp:166-182)."""
    row = pack.as_u32(_gather_rows(mesh, arrays.lf_tab, i // fm.OCC2_INTV))
    t = i % fm.OCC2_INTV
    partial_cnt = pack.count_symbol_prefix(row[..., 4], c, t)
    pass_pri = (c == 0) & (i - t <= arrays.pri) & (arrays.pri < i)
    return fm._sel4(row[..., :4], c) + partial_cnt - pass_pri.to(torch.int64)


def sharded_get_ranges(mesh, arrays: ShardedArrays, qwords: torch.Tensor,
                       qlen: int, lookup_len: int = 0,
                       early_stop: bool = True):
    """Backward search of 2-bit packed patterns (``qwords`` int32 bits on
    the lead device) against the row-sharded index. Same results as
    :func:`kiss_tpu_torch.models.fm_index.get_range_packed_device`, also
    without ``early_stop`` (the lookup table's build)."""
    q = qwords.shape[0]
    dev = qwords.device
    qw = pack.as_u32(qwords)

    def char(j: int) -> torch.Tensor:
        return (qw[:, j // 16] >> (2 * (j % 16))) & 3

    beg = torch.zeros(q, dtype=torch.int64, device=dev)
    end = arrays.lookup[-1].expand(q).clone()
    steps = qlen
    if lookup_len and qlen >= lookup_len:
        key = torch.zeros(q, dtype=torch.int64, device=dev)
        for j in range(qlen - lookup_len, qlen):
            key = (key << 2) | char(j)
        beg = arrays.lookup[key]
        end = arrays.lookup[key + 1]
        steps = qlen - lookup_len
    offs = torch.full((q,), steps, dtype=torch.int64, device=dev)
    for j in range(steps - 1, -1, -1):
        c = char(j)
        # both bounds resolved by ONE gather over the mesh: the two row
        # gathers ride the same sum as a stacked [2Q, 5] block
        occ = _occ_sharded(mesh, arrays, torch.cat([c, c]),
                           torch.cat([beg, end]))
        nbeg = arrays.cnt[c] + occ[:q]
        nend = arrays.cnt[c] + occ[q:]
        if early_stop:
            alive = end > beg
            beg = torch.where(alive, nbeg, beg)
            end = torch.where(alive, nend, end)
            offs = torch.where(alive, j, offs)
        else:
            beg, end = nbeg, nend
            offs = torch.full_like(offs, j)
    return beg, end, offs


def sharded_locate_rows(mesh, arrays: ShardedArrays, rows: torch.Tensor,
                        sa_intv: int) -> torch.Tensor:
    """Row-sharded form of ``locate_rows_device`` (vectorized compute_sa,
    reference: fm_index.hpp:210-222): each LF-walk step needs one fused LF
    row and one mark row -- two gathers over the mesh. Text positions,
    int64, on the lead device."""
    i = rows.to(torch.int64)
    if sa_intv == 1:
        return _gather_rows(mesh, arrays.sa_samp, i)

    def b_row(i):
        return pack.as_u32(_gather_rows(mesh, arrays.b_tab,
                                        i // fm.B_OCC_INTV))

    def b_at(i):
        row = b_row(i)
        w = torch.where((i // 32) % 2 == 1, row[..., 2], row[..., 1])
        return ((w >> (i % 32)) & 1) == 1

    def b_rank(i):
        row = b_row(i)
        off = i % fm.B_OCC_INTV
        one = torch.ones_like(off)
        m0 = (one << torch.clamp(off, max=32)) - 1
        m1 = (one << torch.clamp(off - 32, min=0)) - 1
        return (row[..., 0] + pack.popcount_u32(row[..., 1] & m0)
                + pack.popcount_u32(row[..., 2] & m1))

    steps = torch.zeros_like(i)
    done = b_at(i)
    for _ in range(sa_intv - 1):
        row = pack.as_u32(_gather_rows(mesh, arrays.lf_tab,
                                       i // fm.OCC2_INTV))
        t = i % fm.OCC2_INTV
        c = (row[..., 4] >> (2 * t)) & 3
        pass_pri = (c == 0) & (i - t <= arrays.pri) & (arrays.pri < i)
        nxt = (arrays.cnt[c] + fm._sel4(row[..., :4], c)
               + pack.count_symbol_prefix(row[..., 4], c, t)
               - pass_pri.to(torch.int64))
        i = torch.where(done, i, nxt)
        steps = steps + (~done).to(torch.int64)
        done = b_at(i)
    return _gather_rows(mesh, arrays.sa_samp, b_rank(i)) + steps
