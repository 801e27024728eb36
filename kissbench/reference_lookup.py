"""The plain reference of the seed table (an index's ``lookup_len`` L > 0)
and of the backward search seeded from it, in plain PyTorch (any device),
with nothing of the program imported and nothing the program made read.

The reference FMIndex (jhhung/kISS ``fm_index.hpp``) builds the table in
``build_lookup`` (``:237-269``) and seeds ``get_range`` from it
(``:553-584``). Here both follow from their definitions over a
:class:`kissbench.reference.KmerOracle` whose ``qlen`` is at least L
(every suffix's first ``qlen`` characters as base-5 digits, character + 1,
0 past the end of the text):

- :func:`seed_table`: ``lookup[s]`` is the number of suffix-array rows
  whose suffix is below seed ``s`` (its L characters the base-4 digits of
  ``s``, the first the most significant), for all 4^L seeds, and
  ``lookup[4^L] = N``. A suffix shorter than L that is a prefix of the
  seed, and the empty suffix, rank below it.
- :func:`seeded_search`: a pattern of length ``qlen >= L`` starts from
  ``beg = lookup[key]``, ``end = lookup[key + 1]`` on its last L
  characters and ``offs = qlen - L``; while ``end > beg`` it steps left
  over the characters before them, ``offs = j`` at each step. A pattern
  shorter than L takes the unseeded search.

The seeded range of a seed is the rows from its own suffixes up to those
of the next seed. That also holds any suffix shorter than L that is a
prefix of the next seed and ranks between the two (the reference kISS
reads the same two entries), so it can hold a row the unseeded search does
not: the seeded search is this definition, not the unseeded one. No other
departure from the reference kISS.
"""

from __future__ import annotations

import torch

from kissbench.reference import KmerOracle

I64 = torch.int64


def _seed_keys(seeds: torch.Tensor, L: int) -> torch.Tensor:
    """The oracle's keys of L characters of int64 seed numbers: seed s's
    character j (the j-th most significant base-4 digit of s) as base-5
    digit j, + 1."""
    key = torch.zeros_like(seeds)
    for j in range(L):
        key = key * 5 + ((seeds >> (2 * (L - 1 - j))) & 3) + 1
    return key


def _check_depth(oracle: KmerOracle, L: int) -> None:
    if not 1 <= L <= oracle.qlen:
        raise ValueError(f"lookup_len {L} outside 1 .. {oracle.qlen} (the "
                         "oracle's qlen)")


def _table(oracle: KmerOracle, keys: torch.Tensor, chars: int):
    """The rows below each key of ``chars`` characters, then N."""
    below = torch.searchsorted(oracle.keys,
                               keys * 5 ** (oracle.qlen - chars))
    return torch.cat([below, below.new_tensor([oracle.keys.shape[0]])])


def seed_table(oracle: KmerOracle, L: int) -> torch.Tensor:
    """int64 [4^L + 1]: the rows below each seed of L characters, and N."""
    _check_depth(oracle, L)
    seeds = torch.arange(4**L, dtype=I64, device=oracle.keys.device)
    return _table(oracle, _seed_keys(seeds, L), L)


def short_seed_table(oracle: KmerOracle, L: int) -> torch.Tensor:
    """The table one LF step short: each seed's entry from its last L - 1
    characters (the control of a table's check)."""
    _check_depth(oracle, L)
    seeds = torch.arange(4**L, dtype=I64, device=oracle.keys.device)
    return _table(oracle, _seed_keys(seeds % 4 ** (L - 1), L - 1), L - 1)


def seeded_search(oracle: KmerOracle, table: torch.Tensor, L: int,
                  patterns: torch.Tensor):
    """The backward search of int8 [Q, m] patterns (m <= the oracle's
    qlen) seeded from ``table`` (4^L + 1 entries): (beg, end, offs, LF
    steps taken), int64 [Q] each. Patterns shorter than L take
    :meth:`KmerOracle.search`."""
    _check_depth(oracle, L)
    if table.shape[0] != 4**L + 1:
        raise ValueError(f"a table of {table.shape[0]} entries is not "
                         f"4^{L} + 1")
    q, m = patterns.shape
    if m < L:
        return oracle.search(patterns)
    dev = patterns.device
    key = torch.zeros(q, dtype=I64, device=dev)
    for j in range(m - L, m):
        key = key * 4 + patterns[:, j].to(I64)
    beg = table[key]
    end = table[key + 1]
    offs = torch.full((q,), m - L, dtype=I64, device=dev)
    steps = torch.zeros(q, dtype=I64, device=dev)
    # lo, hi: the seeded range as keys of the oracle, the last L
    # characters' and the next seed's (5^L past the last seed), scaled to
    # the oracle's qlen; each step puts a character in front
    scale = 5 ** (oracle.qlen - L)
    lo = _seed_keys(key, L) * scale
    hi = torch.where(key + 1 < 4**L, _seed_keys(key + 1, L), 5**L) * scale
    top = 5 ** (oracle.qlen - 1)
    alive = end > beg
    for j in range(m - L - 1, -1, -1):
        digit = patterns[:, j].to(I64) + 1
        lo = lo // 5 + digit * top
        hi = hi // 5 + digit * top
        steps += alive.to(I64)
        beg = torch.where(alive, torch.searchsorted(oracle.keys, lo), beg)
        end = torch.where(alive, torch.searchsorted(oracle.keys, hi), end)
        offs = torch.where(alive, j, offs)
        alive = alive & (end > beg)
    return beg, end, offs, steps
