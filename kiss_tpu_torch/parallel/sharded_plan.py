"""The k-ordered suffix sort in per-shard blocks, PyTorch port.

The block form of ``kiss_tpu_torch.ops.suffix_sort._run_plan``: what
GSPMD makes of ``kiss_tpu``'s jitted ``_run_plan`` on the mesh
(``kiss_tpu/parallel/dsort.py:311-317``), where every length-N
intermediate -- key words, ranks, the SA -- is sharded over the devices.
Here each is this process's list of blocks in the layout of
:func:`kiss_tpu_torch.parallel.mesh.block_rows`: shard s holds the global
rows [s B, (s + 1) B) of N = n + 1 real rows and D B - N pads. No device
holds a length-N array; every sort is :func:`kiss_tpu_torch.parallel.
dsort.sort_blocks`, whose local sorts are kernel K1 on the block's device.

  1. **Seed.** Each shard packs its rows' key words from its text block
     and the next seed_chars - 1 characters (:meth:`Mesh.window`), at its
     global positions: the block form of ``pack.seed_key_words_plain``,
     read back by ``pack.decode_seed_keys``.
  2. **Rounds.** A rank key at offset c is the rank blocks shifted by c
     (:meth:`Mesh.shift`: two ppermutes, any c); raw tail words come from
     the text shifted by the tail offset and widened by the tail's halo.
  3. **Ranks.** The adjacent compare takes each shard's first row against
     the previous shard's last (:meth:`Mesh.prev_last`); group heads are
     a local cumsum and gather, carried across shards by an exclusive
     max-scan of each shard's last group start; ``done`` is a psum of
     per-shard counts over the real rows. The scatter rank[sa] = head + 1
     is an inverse permutation by one mesh sort of (sa, head + 1) by sa:
     sa is a permutation of [0, N), so block s of the sorted result is
     rank's position-major block s (the trick of :mod:`.fm_build`'s BWT).
     An all-to-all by owner shard would need room for B rows from every
     source, D B = N rows a shard.

There is no tail refinement: ``kiss_tpu`` compacts only for ``lax.sort``
outside ``jit`` (``kiss_tpu/ops/suffix_sort.py:609-616``), so its mesh
runs every round over the whole array, with an early exit once every
suffix is a singleton group, and so does this one. Pad rows are known by
their appended row id (>= N), never by a decoded field: at n = 2**b - 1
a pad's all-ones position field decodes to n, the sentinel. A pad's sa is
its row id (the inversion parks it in its own slot), its rank 0 (so a
shifted rank reads 0 past N), and it never counts in ``done``.
"""

from __future__ import annotations

import numpy as np
import torch

from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops import suffix_sort as ss
from kiss_tpu_torch.parallel.dsort import sort_blocks
from kiss_tpu_torch.parallel.mesh import block_rows


class _Pipeline:
    """The mesh, the text's blocks and the sizes every step shares."""

    def __init__(self, mesh, text, algorithm: str):
        self.mesh = mesh
        self.n = text.shape[0]
        self.N = self.n + 1
        self.B = block_rows(self.N, mesh.size)
        self.algorithm = algorithm
        self.text = [t.to(torch.int8)
                     for t in mesh.scatter_host(text, self.B)]

    def rows(self, s: int, device) -> torch.Tensor:
        """Global row ids of shard s's block."""
        return s * self.B + torch.arange(self.B, dtype=torch.int64,
                                         device=device)

    def positions(self) -> list:
        return [self.rows(s, t.device)
                for s, t in zip(self.mesh.local, self.text)]

    def sort(self, keys: list):
        """Mesh sort of key blocks: (sorted keys [W, B], row id) a
        shard."""
        out = sort_blocks(self.mesh, keys, self.N, self.algorithm)
        return [(o[:-1], pack.as_u32(o[-1])) for o in out]

    def sa_of(self, pos, rid):
        """The SA block from the sorted position field: pads (row id >= N)
        take their row id."""
        return torch.where(rid < self.N, pos, rid)

    # -- group ranks -----------------------------------------------------

    def ranks(self, groups: list, sas: list, rids: list):
        """(position-major rank blocks, all-singleton flag) from the sorted
        rows' group-identity keys (a list of tensors a shard), SA and row
        ids: the block form of ``_ranks_of_sorted``. ``groups`` is emptied
        once compared, so that the sorted keys are gone before the
        inversion sort."""
        mesh, B, N = self.mesh, self.B, self.N
        prevs = [mesh.prev_last([g[j] for g in groups])
                 for j in range(len(groups[0]))]
        neqs, lasts = [], []
        for i, (s, g, rid) in enumerate(zip(mesh.local, groups, rids)):
            neq = ss._neq_adjacent(g)
            if s > 0:
                neq[0] = torch.stack(
                    [x[0] != p[i][0] for x, p in zip(g, prevs)]).any()
            neq |= rid >= N  # each pad a group of its own
            neqs.append(neq)
            lasts.append(torch.where(neq, self.rows(s, neq.device), -1).max())
        del prevs, g
        groups.clear()
        carry = mesh.exclusive_scan(lasts, "max")
        nexts = mesh.take([x.to(torch.uint8) for x in neqs],
                          [(s + 1) * B for s in range(mesh.size)], 1)
        keys, counts = [], []
        for s, neq, c, nx, sa, rid in zip(mesh.local, neqs, carry, nexts,
                                           sas, rids):
            starts = torch.cat([c.view(1),
                                torch.nonzero(neq).flatten() + s * B])
            head = starts[torch.cumsum(neq, dim=0)]
            nxt = torch.cat([neq[1:], nx.bool()])
            real = rid < N
            counts.append((~(neq & nxt) & real).sum())
            keys.append(torch.stack([pack.to_u32_bits(sa), pack.to_u32_bits(
                torch.where(real, head + 1, 0))]))
            del starts, head, nxt
        done = int(mesh.psum(counts)) == 0
        del neqs, nexts
        # rank[sa] = head + 1: sorted by sa, slot p holds the rank of p
        out = sort_blocks(mesh, keys, N, self.algorithm)
        del keys
        ranks = [torch.where(self.rows(s, o.device) < N, pack.as_u32(o[1]), 0)
                 for s, o in zip(mesh.local, out)]
        return ranks, done

    # -- rounds ------------------------------------------------------------

    def seed(self, seed_chars: int, with_rank: bool):
        """Block form of ``_seed_sort`` (DNA): raw 2-bit words and the
        fused end/position word of each shard's rows, one total-order
        sort. Returns (sa blocks, rank blocks, done)."""
        n, B = self.n, self.B
        wins = self.mesh.window(self.text, seed_chars - 1)
        keys = [pack.seed_key_words_plain(w, seed_chars, start=s * B, n=n,
                                          rows=B)
                for s, w in zip(self.mesh.local, wins)]
        del wins
        sorted_ = self.sort(keys)
        del keys
        sas, groups, rids = [], [], []
        for ops, rid in sorted_:
            pos, lenc = pack.decode_seed_keys(ops, n, seed_chars)
            sas.append(self.sa_of(pos, rid))
            # group identity: raw key words + the clamped length (the
            # position part of the fused word must not split groups)
            groups.append(list(ops[:-1]) + [lenc])
            rids.append(rid)
        del sorted_
        if not with_rank:
            return sas, None, True
        return (sas, *self.ranks(groups, sas, rids))

    def round(self, fields: list, with_rank: bool):
        """One wide sort by packed ``fields`` (lists of blocks, or
        callables making them) and the position: the block form of
        ``_full_round`` and ``_rank_block_sort``."""
        posbits = max(int(self.n).bit_length(), 1)
        keys, places = ss._pack_blocks(fields + [(self.positions, posbits,
                                                  True)])
        sorted_ = self.sort(keys)
        del keys
        sas, groups, rids = [], [], []
        for ops, rid in sorted_:
            sas.append(self.sa_of(ss._extract_field(ops, places[-1]), rid))
            groups.append(ss._mask_field(ops, places[-1]))
            rids.append(rid)
        del sorted_
        if not with_rank:
            return sas, None, True
        return (sas, *self.ranks(groups, sas, rids))

    def rank_fields(self, ranks: dict, spec) -> list:
        """Packed-field specs of the shifted rank keys ``spec`` ((level,
        offset), ...), each made when packed."""
        bits = max(int(self.N).bit_length(), 1)
        return [(lambda lv=lv, off=off: self.mesh.shift(ranks[lv], off,
                                                         self.N), bits, False)
                for lv, off in spec]

    def tail_fields(self, tail_chars: int, tail_offset: int) -> list:
        """Packed-field specs of the raw tail words (4-bit DNA characters
        at ``tail_offset``), from the text shifted by the offset and
        widened by the tail's halo."""
        mesh, n, B = self.mesh, self.n, self.B
        wins = mesh.window(mesh.shift(self.text, tail_offset, n),
                           tail_chars - 1)
        words = [pack.suffix_key_words(w, tail_chars, 0, pack.DNA,
                                       start=s * B + tail_offset, n=n, rows=B)
                 for s, w in zip(mesh.local, wins)]
        del wins
        # fields are packed in order, each word handed over (and dropped
        # here) as it is packed
        return [(lambda: [ws.pop(0) for ws in words], 32, False)
                for _ in range(len(words[0]))]


def sharded_sa_blocks(mesh, text, k, algorithm: str = "auto",
                      strategy: str = "wide") -> list:
    """k-ordered SA of ``text`` (int8 numpy or tensor, DNA) as this
    process's blocks (int64 [B] a local shard, the layout of
    :func:`~kiss_tpu_torch.parallel.mesh.block_rows`; rows n + 1 .. D B -
    1 are pads and hold their row ids). Each shard uploads only its own
    text block; every sort is a mesh sort (``algorithm`` as in
    :func:`~kiss_tpu_torch.parallel.dsort.make_sharded_sort_impl`).
    Concatenated and cut to n + 1, bit-identical to the single-device
    sorter. With ``algorithm="sample"`` an overflow raises
    :class:`~kiss_tpu_torch.parallel.dsort.SampleSortOverflow`."""
    if not isinstance(text, torch.Tensor):
        text = np.ascontiguousarray(text, dtype=np.int8)
    p = _Pipeline(mesh, text, algorithm)
    seed_chars, max_keys = ss._plan_shape(strategy, pack.DNA)
    plan = ss._make_plan(p.n, ss._normalize_k(k), pack.DNA, seed_chars,
                         max_keys)
    nrounds = len(plan.rounds)
    sa, rank, done = p.seed(plan.seed_chars, nrounds > 0)
    # keep only the rank levels a later (non-full) round references, as
    # _run_plan does
    save_levels = set()
    for rnd in plan.rounds:
        if not ss._is_full(rnd, min(lv for lv, _ in rnd.rank_keys)):
            save_levels.update(lv for lv, _ in rnd.rank_keys)
    ranks = {plan.seed_chars: rank}
    del rank
    cover = plan.seed_chars
    for i, rnd in enumerate(plan.rounds):
        need_rank = i < nrounds - 1 or plan.unbounded
        if done:
            break
        # a full round's keys are the current level at offsets 0, cover,
        # ...: the rank-block form covers both (_full_round,
        # _rank_block_sort)
        fields = p.rank_fields(ranks, rnd.rank_keys)
        if rnd.tail_chars:
            fields += p.tail_fields(rnd.tail_chars, rnd.tail_offset)
        del sa  # the round makes the next: none of it is needed there
        sa, rank, done = p.round(fields, need_rank)
        del fields
        if need_rank:
            if cover not in save_levels:
                ranks.pop(cover, None)
            ranks[rnd.new_cover] = rank
        del rank
        cover = rnd.new_cover
    return sa
