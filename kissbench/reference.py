"""The plain reference: what the program's answers must be, worked out
again from the text alone in plain PyTorch (any device), with nothing of
the program imported and nothing the program made read.

- :func:`suffix_array`: the k-ordered suffix array by prefix doubling
  over dense ranks (``torch.sort``), the order that ``kISS suffix_sort
  -k`` defines: suffixes by their first k characters, a suffix that ends
  within k characters before any longer suffix sharing its prefix, ties by
  ascending text position, row 0 the empty suffix (position n).
- :func:`fm_tables`: the tables an ``.fmi`` archive holds (the BWT words,
  the two occurrence tables, the counts, the sentinel row, the sampled SA,
  its mark words and their ranks, the lookup table), from their
  definitions.
- :class:`KmerOracle`: every suffix's first ``qlen`` characters as one
  base-5 integer, sorted. A pattern's suffix-array range, the backward
  search's early stop, its occurrence total and location checksum, and
  the work the query kernels need (LF steps, walk steps, the range BFS's
  nodes) all follow from binary searches in it and prefix sums beside it.

Characters are 0..3; digits are character + 1, and 0 past the end of the
text, so an integer comparison of keys is the suffix order.
"""

from __future__ import annotations

import torch

from kissbench.bounds import BfsWork

I64 = torch.int64
U32 = 0xFFFFFFFF


# ---------------------------------------------------------------- suffix array


def _dense_rank(hi: torch.Tensor, lo: torch.Tensor, n_rows: int):
    """Dense rank of the pairs (hi[i], lo[i]) (values below ``n_rows + 5``),
    and whether all ranks are distinct."""
    key = hi * (n_rows + 5) + lo
    vals, order = torch.sort(key)
    del key
    step = torch.zeros(n_rows, dtype=I64, device=hi.device)
    step[1:] = vals[1:] != vals[:-1]
    del vals
    rank = torch.empty(n_rows, dtype=I64, device=hi.device)
    rank[order] = torch.cumsum(step, dim=0)
    distinct = bool(step[1:].all()) if n_rows > 1 else True
    return rank, distinct


def _shifted(rank: torch.Tensor, h: int) -> torch.Tensor:
    """rank[i + h], 0 (the empty suffix) past the end."""
    out = torch.zeros_like(rank)
    if h < rank.shape[0]:
        out[: rank.shape[0] - h] = rank[h:]
    return out


def suffix_array(text: torch.Tensor, k: int | None) -> torch.Tensor:
    """int64 suffix array (n + 1 rows) of int8 ``text``, ordered by the
    first ``k`` characters (``None``: all of them), ties by position."""
    if k is not None and k < 1:
        raise ValueError(f"k = {k}: the order needs a character at least")
    n = text.shape[0]
    N = n + 1
    rank = torch.zeros(N, dtype=I64, device=text.device)
    rank[:n] = text.to(I64) + 1  # rank over one character
    distinct = n == 0
    if k is None:
        h = 1
        while not distinct:
            rank, distinct = _dense_rank(rank, _shifted(rank, h), N)
            h *= 2
    elif k > 1:
        # ranks over 2^j characters for every set bit of k below its top
        # one, then the top power composed with them from the left
        keep = {}
        h = 1
        while 2 * h <= k and not distinct:
            if k & h:
                keep[h] = rank
            rank, distinct = _dense_rank(rank, _shifted(rank, h), N)
            h *= 2
        covered = h
        for part in sorted(keep, reverse=True):
            if distinct:
                break
            rank, distinct = _dense_rank(rank, _shifted(keep.pop(part),
                                                         covered), N)
            covered += part
    return torch.sort(rank, stable=True).indices


# ---------------------------------------------------------------- the tables


def _pack_bits(values: torch.Tensor, per_word: int, width: int,
               words: int) -> torch.Tensor:
    """``values`` (int64, each below 2^width) packed ``per_word`` to a
    32-bit word, LSB-first, into ``words`` words (uint32 values in
    int64)."""
    buf = torch.zeros(words * per_word, dtype=I64, device=values.device)
    buf[: values.shape[0]] = values
    shifts = width * torch.arange(per_word, dtype=I64, device=values.device)
    return (buf.reshape(words, per_word) << shifts).sum(dim=1)


TABLES = ("bwt_words", "occ1", "occ2", "cnt", "pri", "sa_samp", "b_words",
          "b_occ", "lookup")


def fm_tables(text: torch.Tensor, sa: torch.Tensor, sa_intv: int) -> dict:
    """The ``.fmi`` tables of ``text`` over its suffix array ``sa``,
    sampled every ``sa_intv`` positions, lookup length 0, as int64 tensors
    (32-bit words as their unsigned values):

    - ``bwt_words``: BWT[r] = text[sa[r] - 1] (0 at the row whose suffix
      starts the text), 16 two-bit symbols a word, LSB-first;
    - ``occ1[j, c]``: c in BWT rows [0, 256 j); ``occ2[j, c]``: c in rows
      [256 (j // 16), 16 j), both without the sentinel row;
    - ``cnt[c]``: 1 + the symbols below c; ``pri``: the sentinel row;
    - marks at rows whose position is a multiple of ``sa_intv``:
      ``sa_samp`` their positions in row order, ``b_words`` the mark bits
      (32 a word, an even count of words), ``b_occ[j]`` the marks in rows
      [0, 64 j) for every started 64 rows;
    - ``lookup``: [0, N].
    """
    n = text.shape[0]
    N = n + 1
    dev = text.device
    sa = sa.to(I64)
    bwt = torch.where(sa == 0, 0, text.to(I64)[torch.clamp(sa - 1, min=0)])
    pri = torch.nonzero(sa == 0).reshape(-1)[0]
    out = {"bwt_words": _pack_bits(bwt, 16, 2, -(-N // 16)), "pri": pri}
    rows2 = torch.arange(N // 16 + 1, dtype=I64, device=dev)
    occ1, occ2, totals = [], [], []
    for c in range(4):
        seen = bwt == c
        seen[pri] = False
        before = torch.zeros(N + 1, dtype=I64, device=dev)
        torch.cumsum(seen, dim=0, out=before[1:])
        occ1.append(before[0 : 256 * (N // 256) + 1 : 256])
        occ2.append(before[16 * rows2] - before[256 * (rows2 // 16)])
        totals.append(before[N])
    out["occ1"] = torch.stack(occ1, dim=1)
    out["occ2"] = torch.stack(occ2, dim=1)
    totals = torch.stack(totals)
    out["cnt"] = torch.cumsum(totals, dim=0) - totals + 1
    if sa_intv == 1:
        out["sa_samp"] = sa
        out["b_words"] = torch.zeros(1, dtype=I64, device=dev)
        out["b_occ"] = torch.zeros(1, dtype=I64, device=dev)
    else:
        marked = sa % sa_intv == 0
        out["sa_samp"] = sa[marked]
        out["b_words"] = _pack_bits(marked.to(I64), 32, 1, 2 * -(-N // 64))
        before = torch.zeros(N + 1, dtype=I64, device=dev)
        torch.cumsum(marked, dim=0, out=before[1:])
        out["b_occ"] = before[0 : 64 * (-(-N // 64)) : 64]
    out["lookup"] = torch.tensor([0, N], dtype=I64, device=dev)
    return out


def tables_differ(got: dict, want: dict) -> int:
    """Entries of the tables ``want`` names that ``got`` does not hold
    alike (a table of another shape counts all its entries)."""
    wrong = 0
    for name, w in want.items():
        g = got[name].to(device=w.device, dtype=I64)
        if g.shape != w.shape:
            wrong += max(g.numel(), w.numel())
        else:
            wrong += int((g != w).sum())
    return wrong


def unsigned_words(x: torch.Tensor) -> torch.Tensor:
    """A table of 32-bit words (any integer type holding the bits) as
    int64 unsigned values."""
    return x.to(I64) & U32


# ---------------------------------------------------------------- the oracle


def _digits(x: torch.Tensor) -> torch.Tensor:
    return x.to(I64) + 1


class KmerOracle:
    """Every suffix of ``text`` keyed by its first ``qlen`` characters
    (base-5 digits, 0 past the end; 5^27 < 2^63, so ``qlen`` <= 27), the
    keys sorted with their positions, and prefix sums of the positions
    and of the positions modulo ``sa_intv`` in that order. Index r of the
    sorted keys is row r of any suffix array ordered by at least ``qlen``
    characters."""

    def __init__(self, text: torch.Tensor, qlen: int, sa_intv: int):
        if not 1 <= qlen <= 27:
            raise ValueError(f"qlen {qlen} outside 1 .. 27")
        n = text.shape[0]
        N = n + 1
        dev = text.device
        self.text, self.qlen, self.sa_intv = text, qlen, sa_intv
        padded = torch.zeros(N + qlen, dtype=I64, device=dev)
        padded[:n] = _digits(text)
        key = torch.zeros(N, dtype=I64, device=dev)
        for j in range(qlen):
            key.mul_(5).add_(padded[j : j + N])
        del padded
        self.keys, self.pos = torch.sort(key)
        del key
        self.pos_sum = torch.zeros(N + 1, dtype=I64, device=dev)
        torch.cumsum(self.pos, dim=0, out=self.pos_sum[1:])
        self.mod_sum = torch.zeros(N + 1, dtype=I64, device=dev)
        torch.cumsum(self.pos % sa_intv, dim=0, out=self.mod_sum[1:])

    def _below(self, key: torch.Tensor) -> torch.Tensor:
        """Suffixes whose key is below ``key``."""
        return torch.searchsorted(self.keys, key)

    def search(self, patterns: torch.Tensor):
        """The backward search of int8 [Q, m] patterns (m <= qlen) with
        its early stop: (beg, end, offs, LF steps), int64 [Q] each. A
        pattern that occurs gets its rows [beg, end) and offs 0; one that
        does not stops at the first suffix p[j:] that does not occur, with
        beg = end = the rows of suffixes below p[j:] and offs = j. The
        steps are those the search takes: the suffixes tried."""
        q, m = patterns.shape
        dev = patterns.device
        d = _digits(patterns)
        beg = torch.zeros(q, dtype=I64, device=dev)
        end = torch.full((q,), self.keys.shape[0], dtype=I64, device=dev)
        offs = torch.zeros(q, dtype=I64, device=dev)
        steps = torch.zeros(q, dtype=I64, device=dev)
        alive = torch.ones(q, dtype=torch.bool, device=dev)
        s = torch.zeros(q, dtype=I64, device=dev)
        scale = 5 ** (self.qlen - 1)
        for j in range(m - 1, -1, -1):
            # s: the digits of p[j:], the first at weight 5^(qlen - 1)
            s = s // 5 + d[:, j] * scale
            width = 5 ** (self.qlen - (m - j))
            lo, hi = self._below(s), self._below(s + width)
            steps += alive.to(I64)
            beg = torch.where(alive, lo, beg)
            end = torch.where(alive, hi, end)
            offs = torch.where(alive, j, offs)
            alive = alive & (hi > lo)
        return beg, end, offs, steps

    def stats(self, beg: torch.Tensor, end: torch.Tensor):
        """(occurrences, location checksum, walk steps) of the rows
        [beg, end): the rows, the sum of their positions, and the sum of
        their positions modulo ``sa_intv`` (the LF steps the per-row walk
        takes to a sampled row)."""
        rows = int((end - beg).sum())
        checksum = int((self.pos_sum[end] - self.pos_sum[beg]).sum())
        walk = int((self.mod_sum[end] - self.mod_sum[beg]).sum())
        return rows, checksum, walk

    def bfs_work(self, beg: torch.Tensor, end: torch.Tensor) -> BfsWork:
        """What the range BFS of [beg, end) visits, from the occurrences:
        the node of a query at depth d with left context w holds the
        occurrences p of the query with p >= d and text[p - d : p] = w,
        each a suffix at p - d, marked where (p - d) % sa_intv == 0."""
        lens = end - beg
        total = int(lens.sum())
        dev = beg.device
        query = torch.repeat_interleave(
            torch.arange(beg.shape[0], dtype=I64, device=dev), lens,
            output_size=total)
        starts = torch.cumsum(lens, dim=0) - lens
        rows = (beg[query] - starts[query]
                + torch.arange(total, dtype=I64, device=dev))
        pos = self.pos[rows]
        text = self.text.to(I64)
        nodes = entries = lfs = segments = positions = 0
        context = torch.zeros_like(pos)
        for d in range(self.sa_intv):
            if d:
                ok = pos >= d
                query, pos, context = query[ok], pos[ok], context[ok]
                context = context * 4 + text[pos - d]
            group = query * 4**d + context
            keys, inverse, size = torch.unique(
                group, return_inverse=True, return_counts=True)
            marked = torch.zeros(keys.shape[0], dtype=I64, device=dev)
            marked.index_add_(0, inverse, ((pos - d) % self.sa_intv == 0)
                              .to(I64))
            one = size == 1
            nodes += keys.shape[0]
            entries += 2 * keys.shape[0] - int(one.sum())
            if d + 1 < self.sa_intv:
                # a one-row node steps once, unless its suffix starts
                # the text (the sentinel row)
                lfs += (8 * int((~one).sum())
                        + int((one[inverse] & (pos != d)).sum()))
            segments += int((marked > 0).sum())
            positions += int(marked.sum())
        return BfsWork(nodes, entries, lfs, segments, positions)


def backward_search(tables: dict, patterns: torch.Tensor):
    """The backward search of int8 [Q, m] patterns over the tables of
    :func:`fm_tables` by their definitions (LF(c, i) = cnt[c] + the c in
    BWT rows [0, i) without the sentinel row), with the early stop of
    :meth:`KmerOracle.search`: (beg, end, offs) int64 [Q] each."""
    words, occ1, occ2 = tables["bwt_words"], tables["occ1"], tables["occ2"]
    cnt, pri = tables["cnt"], tables["pri"]
    q, m = patterns.shape
    dev = patterns.device
    n_rows = int(tables["lookup"][-1])
    lanes = torch.arange(16, dtype=I64, device=dev)

    def lf(c, i):
        base = (i >> 4) << 4
        rows = base[:, None] + lanes[None, :]
        sym = (words[torch.clamp(rows >> 4, max=words.shape[0] - 1)]
               >> (2 * (rows & 15))) & 3
        hit = (rows < i[:, None]) & (sym == c[:, None]) & (rows != pri)
        return (cnt[c] + occ1[i >> 8, c] + occ2[i >> 4, c]
                + hit.sum(dim=1))

    beg = torch.zeros(q, dtype=I64, device=dev)
    end = torch.full((q,), n_rows, dtype=I64, device=dev)
    offs = torch.zeros(q, dtype=I64, device=dev)
    alive = torch.ones(q, dtype=torch.bool, device=dev)
    for j in range(m - 1, -1, -1):
        c = patterns[:, j].to(I64)
        nb, ne = lf(c, beg), lf(c, end)
        beg = torch.where(alive, nb, beg)
        end = torch.where(alive, ne, end)
        offs = torch.where(alive, j, offs)
        alive = alive & (end > beg)
    return beg, end, offs


def ranges_differ(got, want) -> int:
    """Patterns whose (beg, end, offs) in ``got`` differ from ``want``."""
    bad = torch.zeros(want[0].shape[0], dtype=torch.bool,
                      device=want[0].device)
    for g, w in zip(got, want):
        bad |= g.to(device=w.device, dtype=I64) != w
    return int(bad.sum())
