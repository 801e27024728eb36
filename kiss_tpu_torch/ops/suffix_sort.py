"""k-ordered suffix array construction, PyTorch port.

Port of ``kiss_tpu.ops.suffix_sort``: the same problem (sort every suffix
by its first k characters, ties broken by text position, sentinel/empty
suffix first -- reference semantics: kiss1_core.hpp:94-135 comparator,
ties at >= k chars resolved by ``i < j``) with the same round plan:

  1. Seed: the first 64 characters of every suffix as raw 2-bit words
     (16 chars per 32-bit word) plus one word fusing the clamped suffix
     length with the position, sorted in one total-order sort.
  2. Rank: group heads by compare-adjacent + a running head (the JAX
     package's ``cummax``); the position-major rank comes back by the
     scatter ``rank[sa] = head+1`` (the TPU's inversion sort stood in for
     this scatter).
  3. Rank-block sort: lexicographic order of (rank_L[p], rank_L[p+L],
     ...) is the order of the concatenated blocks, so one sort of up to 8
     shifted rank keys, bit-packed with the position into the fewest
     32-bit words (``_pack_fields``), extends the coverage 8-fold.
  4. Exact-k remainders smaller than a block are closed with saved rank
     levels and raw packed words.

Unbounded k (-1) runs one full-array round, then refines only the
suffixes still in tie groups (``_tail_refine``) until none is left.

Every multi-word sort goes through ``sort_impl``, by default the
hand-written CUDA radix sort (:func:`radix_sort_words`, kernel K1; more
than 9 words as stable sorts of word groups, :func:`radix_sort_wide`) on
a CUDA device and its plain PyTorch version on the CPU. Positions and ranks
are int64; the SA that leaves the device is uint32 as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops.radix_sort import radix_sort_wide
from kiss_tpu_torch.utils import timing
from kiss_tpu_torch.utils.device import resolve_device

SEED_WORDS = 4  # 64 chars for DNA (2-bit packed), 12 for general
MAX_RANK_KEYS = 8  # widest rank-block sort; coverage multiplies by this


def _seed_max(alphabet: pack.Alphabet) -> int:
    """Widest seed the seed sort covers in SEED_WORDS raw words. DNA uses
    the 2-bit fast path (16 chars/word; end-of-text + position fused into
    ONE extra word by :func:`pack.fused_end_pos`), so 64 chars cost 5
    sort words."""
    if alphabet is pack.DNA:
        return SEED_WORDS * 16
    return SEED_WORDS * alphabet.chars_per_word


# ---------------------------------------------------------------------------
# static planning (verbatim from kiss_tpu.ops.suffix_sort)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Round:
    # each round sorts by [rank_lv at offset] keys then raw tail words
    rank_keys: tuple[tuple[int, int], ...]  # (level_chars, char_offset)
    tail_chars: int  # raw-word chars at tail_offset (< seed)
    tail_offset: int
    new_cover: int  # characters covered after this round


@dataclass(frozen=True)
class _SortPlan:
    seed_chars: int
    rounds: tuple[_Round, ...]
    unbounded: bool

    @property
    def save_levels(self) -> frozenset[int]:
        lvls = set()
        for r in self.rounds:
            lvls.update(lv for lv, _ in r.rank_keys)
        return frozenset(lvls)


def _decompose(target: int, levels: list[int], seed: int):
    """Greedy cover of ``target`` chars: full blocks of the largest
    levels first, then a raw-word tail smaller than the seed."""
    keys = []
    off = 0
    rem = target
    for lv in sorted(levels, reverse=True):
        while lv <= rem and len(keys) < 3 * MAX_RANK_KEYS:
            keys.append((lv, off))
            off += lv
            rem -= lv
    assert rem < seed, (target, levels, rem)
    return keys, rem, off


def _make_plan(
    n: int, k: int | None, alphabet: pack.Alphabet,
    seed_chars: int | None = None, max_keys: int = MAX_RANK_KEYS,
) -> _SortPlan:
    """Round plan. The default (wide) shape is the PARALLEL_SORTING
    strategy: a seed as wide as SEED_WORDS raw words, then rounds of up
    to MAX_RANK_KEYS rank keys (coverage x8/round). ``seed_chars`` /
    ``max_keys`` reshape it -- PREFIX_DOUBLING passes (16, 2): a
    16-char super-char seed (exactly kISS-2's l = 16 bases per uint32
    encoding, reference: kiss2_core.hpp:862-863) and 2-key doubling
    rounds (rank[p], rank[p + cover] -- the reference's sort_sa_blocks
    key pair, kiss2_core.hpp:102-111,251), coverage x2/round."""
    seed_max = seed_chars or _seed_max(alphabet)
    seed_max = min(seed_max, _seed_max(alphabet))
    unbounded = k is None or k < 0 or k > n
    if unbounded:
        # comparing n characters fully distinguishes all suffixes
        # (reference: k = -1 wraps to SIZE_MAX, README.md:56); rounds of
        # max_keys full blocks until the early exit fires
        rounds = []
        cover = seed_max
        while cover < n:
            rounds.append(
                _Round(
                    tuple((cover, j * cover) for j in range(max_keys)),
                    0,
                    0,
                    cover * max_keys,
                )
            )
            cover *= max_keys
        return _SortPlan(seed_max, tuple(rounds), True)

    if k <= seed_max:
        return _SortPlan(max(k, 1), (), False)

    rounds = []
    levels = [seed_max]
    cover = seed_max
    while cover < k:
        # how far can one round reach with full blocks of known levels?
        reach = cover * max_keys
        if reach >= k:
            keys, tail, off = _decompose(k, levels, seed_max)
            rounds.append(_Round(tuple(keys), tail, off, k))
            cover = k
        else:
            rounds.append(
                _Round(
                    tuple((cover, j * cover) for j in range(max_keys)),
                    0,
                    0,
                    reach,
                )
            )
            levels.append(reach)
            cover = reach
    return _SortPlan(seed_max, tuple(rounds), False)


def _field_layout(specs):
    """Static layout for :func:`_pack_fields`. ``specs`` is a list of
    (bits, align) pairs; returns (placements, n_words) where each
    placement is (start_bit, bits) with start measured from the MSB of
    word 0. ``align`` forces the field to not straddle a word boundary
    (required for fields extracted back out after sorting)."""
    placements = []
    pos = 0
    for bits, align in specs:
        assert 1 <= bits <= 32
        if align and pos // 32 != (pos + bits - 1) // 32:
            pos = (pos // 32 + 1) * 32
        placements.append((pos, bits))
        pos += bits
    return placements, -(-pos // 32)


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------


def _pack_fields(fields):
    """Pack (tensor, bits, align) fields, most-significant first, into
    32-bit words whose lexicographic (unsigned) order equals the order of
    the field tuples -- e.g. eight 26-bit rank keys plus a position in 8
    words instead of 9. Returns (words int32 [W, N] holding the uint32
    bits -- the input layout of :func:`radix_sort_words` --, placements).

    A field's tensor may be given as a zero-argument callable: it is then
    made only when packed, and every finished word is stored as 32 bits
    at once, so a wide round never holds all its int64 keys at a time.
    """
    def one(arr):
        return lambda: [arr() if callable(arr) else arr]

    words, placements = _pack_blocks([(one(a), b, al) for a, b, al in fields])
    return words[0], placements


def _pack_blocks(fields):
    """:func:`_pack_fields` over a list of blocks: each field's value is
    a list of tensors, one a block, or a zero-argument callable that
    returns one (made only when packed). Returns (a list of words, one
    int32 [W, N_b] a block, placements)."""
    placements, n_words = _field_layout([(b, a) for _, b, a in fields])
    words = None
    acc: list = []
    flushed = 0  # words [0, flushed) are complete and stored

    def put(i, w, piece):
        acc[i][w] = (piece if acc[i][w] is None
                     else acc[i][w].bitwise_or_(piece))

    def flush(upto):
        nonlocal flushed
        while flushed < upto:
            for i, a in enumerate(acc):
                if a[flushed] is not None:
                    words[i][flushed] = pack.to_u32_bits(a[flushed])
                    a[flushed] = None
            flushed += 1

    for (arrs, bits, _), (start, _) in zip(fields, placements):
        arrs = arrs() if callable(arrs) else list(arrs)
        if words is None:
            words = [torch.zeros((n_words, a.shape[0]), dtype=torch.int32,
                                 device=a.device) for a in arrs]
            acc = [[None] * n_words for _ in arrs]
        flush(start // 32)  # fields come MSB first: earlier words are done
        end = start + bits
        w0, w1 = start // 32, (end - 1) // 32
        for i in range(len(arrs)):
            arr = arrs[i].to(torch.int64) & ((1 << bits) - 1)
            arrs[i] = None
            if w0 == w1:
                put(i, w0, arr << (32 * (w0 + 1) - end))
            else:
                spill = end - 32 * (w0 + 1)
                put(i, w0, arr >> spill)
                put(i, w1, (arr << (32 - spill)) & pack.U32_MASK)
            del arr
        del arrs
    flush(n_words)
    return words, placements


def _extract_field(words: torch.Tensor, placement) -> torch.Tensor:
    start, bits = placement
    w, shift = start // 32, 32 * (start // 32 + 1) - (start + bits)
    assert start // 32 == (start + bits - 1) // 32, "field straddles"
    return (pack.as_u32(words[w]) >> shift) & ((1 << bits) - 1)


def _mask_field(words: torch.Tensor, placement):
    """The rows of ``words`` with one (non-straddling) field zeroed, for
    group-identity comparisons that must ignore the position bits."""
    start, bits = placement
    w = start // 32
    shift = 32 * (w + 1) - (start + bits)
    keep = pack.U32_MASK & ~(((1 << bits) - 1) << shift)
    return [
        pack.as_u32(x) & keep if i == w else x for i, x in enumerate(words)
    ]


def _neq_adjacent(sorted_keys) -> torch.Tensor:
    """neq[i] = row i differs from row i-1 in any key (neq[0] = True)."""
    first = sorted_keys[0]
    neq = torch.ones(first.shape[0], dtype=torch.bool, device=first.device)
    if first.shape[0] > 1:
        diff = first[1:] != first[:-1]
        for ks in sorted_keys[1:]:
            diff |= ks[1:] != ks[:-1]
        neq[1:] = diff
    return neq


def _positions(N: int, device):
    """Field maker for the row positions 0..N-1 (see _pack_fields)."""
    return lambda: torch.arange(N, dtype=torch.int64, device=device)


def _rank_shift(rank: torch.Tensor, offset: int) -> torch.Tensor:
    """Position-major lookup rank[p+offset] with 0 past the end.
    (Past-end compares smallest: the reference's ``get_key`` returns 0
    there, kiss2_core.hpp:102-111.)"""
    if offset == 0:
        return rank
    N = rank.shape[0]
    off = min(offset, N)
    return torch.cat([rank[off:], rank.new_zeros(off)])


def _group_heads(neq: torch.Tensor) -> torch.Tensor:
    """For every row, the row of the last group start (``neq``) at or
    before it: JAX's ``cummax(where(neq, row, 0))``, as one cumsum and one
    gather (``torch.cummax`` is a slow scan on CUDA at genome scale)."""
    starts = torch.nonzero(neq).flatten()
    return starts[torch.cumsum(neq, dim=0) - 1]


def _ranks_of_sorted(sorted_keys, sa: torch.Tensor):
    """(position-major rank, all-singleton flag) from a sorted key set:
    group heads by an adjacent compare and a running head, then the
    scatter rank[sa] = head + 1."""
    N = sa.shape[0]
    neq = _neq_adjacent(sorted_keys)
    head = _group_heads(neq)
    rank = torch.empty(N, dtype=torch.int64, device=sa.device)
    rank[sa] = head + 1
    nxt = torch.ones_like(neq)
    nxt[:-1] = neq[1:]
    done = torch.all(neq & nxt)
    return rank, done


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------


def _seed_sort(text, seed_chars: int, alphabet, with_rank: bool,
               sort_impl=radix_sort_wide):
    """Sort of all n+1 suffixes by the first ``seed_chars`` characters
    (shorter-first at end of text, then ascending position -- the full
    reference comparator contract, kiss1_core.hpp:94-135). Returns
    (sa, rank, done); rank/done are dummies when ``with_rank`` is False
    (i.e. the seed alone covers k).

    Raw 2-bit packed words (16 chars per word) plus ONE word fusing the
    end-of-text rule with the position (:func:`pack.fused_end_pos`), run
    as one total-order sort: 5 words for the standard 64-char seed.
    """
    n = text.shape[0]
    if alphabet is not pack.DNA:
        # 10-bit characters, 3 to a word, past-end 0 (the end-of-text rule
        # is in the words), and the position as the last key: a total
        # order, so the stable sort of the JAX package gives the same SA
        words = pack.suffix_key_words(text, seed_chars, 0, alphabet)
        words.append(_positions(n + 1, text.device)())
        keys = torch.stack([pack.to_u32_bits(w) for w in words])
        del words
        ops, _ = sort_impl(keys)
        del keys
        sa = pack.as_u32(ops[-1])
        if not with_rank:
            return sa, sa, True
        rank, done = _ranks_of_sorted(list(ops[:-1]), sa)
        return sa, rank, done
    words2 = pack.suffix_key_words_2bit(text, seed_chars, 0)
    fused = pack.fused_end_pos(n, seed_chars, text.device)
    fbits = max(int(n).bit_length(), 1)
    packed, places = _pack_fields(
        [(w, 32, False) for w in words2] + [(fused, fbits, True)]
    )
    del words2, fused
    ops, _ = sort_impl(packed)
    del packed
    fused_s = _extract_field(ops, places[-1])
    sa = torch.where(
        fused_s < seed_chars, n - fused_s, fused_s - seed_chars
    )
    if not with_rank:
        return sa, sa, True
    # group identity = raw key words + clamped length (decoded from the
    # fused word; its position part must NOT split groups)
    lenc = torch.clamp(fused_s, max=seed_chars)
    rank, done = _ranks_of_sorted(list(ops[:-1]) + [lenc], sa)
    return sa, rank, done


def _full_round(text, rank, cover: int, n_keys: int, with_rank: bool,
                sort_impl=radix_sort_wide):
    """One wide sort by ``n_keys`` shifted copies of the current rank
    level at offsets 0, cover, 2*cover, ... -- covering n_keys*cover
    characters."""
    n = text.shape[0]
    N = n + 1
    rank_bits = max(int(N).bit_length(), 1)
    posbits = max(int(n).bit_length(), 1)
    packed, places = _pack_fields(
        [(lambda j=j: _rank_shift(rank, cover * j), rank_bits, False)
         for j in range(n_keys)]
        + [(_positions(N, text.device), posbits, True)]
    )
    ops, _ = sort_impl(packed)
    del packed
    sa = _extract_field(ops, places[-1])
    if not with_rank:
        return sa, sa, True
    rank2, done = _ranks_of_sorted(_mask_field(ops, places[-1]), sa)
    return sa, rank2, done


def _active_rows_of(sa, rank):
    """Row-space flags + count of suffixes in unresolved tie groups."""
    key_sorted = rank[sa]
    neq = _neq_adjacent((key_sorted,))
    nxt = torch.ones_like(neq)
    nxt[:-1] = neq[1:]
    active = ~(neq & nxt)
    return active, int(active.sum())


# flags one nonzero call of _compact_rows reads: each call's input stays
# below 2**31 elements, which not every PyTorch's CUDA nonzero takes (the
# counterpart of kiss_tpu's two-level branch at N >= 2**31 - 2**16)
_COMPACT_CHUNK = 1 << 30


def _compact_rows(active, capacity: int):
    """Ascending active row ids zero-filled to ``capacity`` (the dataflow
    form of kISS-2's compact, reference: kiss2_core.hpp:464-536). Fill
    entries alias row 0 -- the sentinel row, whose rank 1 is the global
    minimum, so the refinement sort parks them at the front and their
    writes re-store the unchanged sentinel. The flags are read in chunks
    of ``_COMPACT_CHUNK``, each chunk's ids offset by its start, until
    ``capacity`` ids are found."""
    rows = torch.zeros(capacity, dtype=torch.int64, device=active.device)
    found = 0
    for lo in range(0, active.shape[0], _COMPACT_CHUNK):
        if found == capacity:
            break
        ids = torch.nonzero(active[lo : lo + _COMPACT_CHUNK]).flatten()
        ids = ids[: capacity - found] + lo
        rows[found : found + ids.shape[0]] = ids
        found += ids.shape[0]
    return rows


def _tail_refine(sa, rank, rows, m: int, cover: int,
                 sort_impl=radix_sort_wide):
    """One compacted refinement round for the deep tail of an unbounded
    sort: re-sorts only the m suffixes still in tie groups (``rows``:
    their ascending row ids, zero-filled) by MAX_RANK_KEYS shifted rank
    lookups, writes the new order back into their own rows, updates
    ranks in place, and re-compacts. Returns (sa, rank, rows_next,
    m_next)."""
    n = sa.shape[0] - 1
    p = sa[rows]
    # rank[p + j * cover], 0 past the end; each key goes straight into
    # its 32-bit row (ranks are below 2**32)
    keys = torch.empty((MAX_RANK_KEYS, p.shape[0]), dtype=torch.int32,
                       device=p.device)
    for j in range(MAX_RANK_KEYS):
        q = p + cover * j
        keys[j] = pack.to_u32_bits(
            torch.where(q <= n, rank[torch.clamp(q, max=n)], 0)
        )
    sorted_keys, perm = sort_impl(keys)
    del keys
    ps = p[perm]
    # rows holds m ascending ids followed by the zero fills, so its
    # ascending order is the fills first
    trows = torch.cat([rows[m:], rows[:m]])
    # fill slots all write the sentinel (row 0 <- n): duplicate indices
    # carrying equal values
    sa[trows] = ps

    neq = _neq_adjacent(list(sorted_keys))
    head = trows[_group_heads(neq)]  # trows is ascending
    is_fill = ps == n
    rank[ps] = torch.where(is_fill, 1, head + 1)

    nxt = torch.ones_like(neq)
    nxt[:-1] = neq[1:]
    still = ~(neq & nxt) & ~is_fill
    keep = torch.nonzero(still).flatten()
    rows_next = torch.zeros_like(rows)
    rows_next[: keep.shape[0]] = trows[keep]
    return sa, rank, rows_next, int(keep.shape[0])


def _rank_block_sort(text, ranks: dict, rank_key_spec, tail_chars: int,
                     tail_offset: int, alphabet, with_rank: bool,
                     sort_impl=radix_sort_wide):
    """One wide sort by shifted rank-level keys (+ optional raw tail
    words). ``ranks`` maps level -> position-major rank;
    ``rank_key_spec`` is ((level, offset), ...)."""
    n = text.shape[0]
    rank_bits = max(int(n + 1).bit_length(), 1)
    posbits = max(int(n).bit_length(), 1)
    fields = [
        (lambda lv=lv, off=off: _rank_shift(ranks[lv], off), rank_bits,
         False)
        for lv, off in rank_key_spec
    ]
    if tail_chars:
        fields.extend(
            (w, 32, False)
            for w in pack.suffix_key_words(
                text, tail_chars, tail_offset, alphabet
            )
        )
    packed, places = _pack_fields(
        fields + [(_positions(n + 1, text.device), posbits, True)]
    )
    del fields
    ops, _ = sort_impl(packed)
    del packed
    sa = _extract_field(ops, places[-1])
    if not with_rank:
        return sa, sa, True
    rank, done = _ranks_of_sorted(_mask_field(ops, places[-1]), sa)
    return sa, rank, done


def _next_capacity(m: int, cap: int) -> int:
    c = 1024
    while c < m:
        c *= 2
    return min(c, cap)


# unbounded sorts switch from full-array wide sorts to compacted tail
# refinement after this many rounds (one round reaches 512 chars of
# coverage; beyond that the active set is a small fraction on real data)
_FULL_ROUNDS_BEFORE_TAIL = 1


def _is_full(rnd: _Round, cover: int) -> bool:
    """A round whose keys are q shifted copies of the current level and
    no tail."""
    return rnd.tail_chars == 0 and all(
        lv == cover and off == j * cover
        for j, (lv, off) in enumerate(rnd.rank_keys)
    )


def _run_plan(text, plan: _SortPlan, alphabet, *, refine_tail: bool = True,
              sort_impl=radix_sort_wide):
    """Run a sort plan from the host: seed, then rounds until the plan ends
    or every suffix is a singleton group. With ``refine_tail`` an
    unbounded plan switches to compacted tail refinement after
    ``_FULL_ROUNDS_BEFORE_TAIL`` full rounds (the host path of
    ``kiss_tpu``'s ``_run_plan``); without it every round runs over the
    whole array (the
    single-program path, ``k_ordered_suffix_array_device``). Both give
    the identical SA. ``sort_impl`` is the multi-word sort seam."""
    nrounds = len(plan.rounds)
    # per-phase stopwatch logs under --verbose (reference model:
    # kiss1_core.hpp:244-267 / README.md:94-101 stage table)
    dbg = timing.debug_enabled()
    sa, rank, done = timing.staged(
        f"seed_sort(chars={plan.seed_chars})" if dbg else None,
        lambda: _seed_sort(
            text, plan.seed_chars, alphabet, nrounds > 0, sort_impl
        ),
    )
    if nrounds == 0:
        return sa

    # keep only the rank levels the (static) final round will reference
    save_levels = set()
    for rnd in plan.rounds:
        if not _is_full(rnd, min(lv for lv, _ in rnd.rank_keys)):
            save_levels.update(lv for lv, _ in rnd.rank_keys)
    ranks = {plan.seed_chars: rank}
    del rank
    cover = plan.seed_chars
    for i, rnd in enumerate(plan.rounds):
        is_last = i == nrounds - 1
        need_rank = (not is_last) or plan.unbounded
        if bool(done):
            break
        if plan.unbounded and refine_tail and i >= _FULL_ROUNDS_BEFORE_TAIL:
            # deep-tail refinement on the compacted active set
            N = text.shape[0] + 1
            rank = ranks.pop(cover)
            ranks.clear()
            active, m = _active_rows_of(sa, rank)
            if m == 0:
                break
            rows = _compact_rows(active, _next_capacity(m, N))
            del active
            t = 0
            while m > 0:
                ncap = _next_capacity(m, N)
                if ncap < rows.shape[0]:
                    rows = rows[:ncap]
                # cover past n behaves like cover == n + 1 (all shifted
                # keys out of range)
                c = min(cover, N)
                sa, rank, rows, m = timing.staged(
                    f"tail_refine[{t}](m={m}, cover={cover})" if dbg
                    else None,
                    lambda rows=rows, m=m, c=c: _tail_refine(
                        sa, rank, rows, m, c, sort_impl
                    ),
                )
                cover *= MAX_RANK_KEYS
                t += 1
            break
        if _is_full(rnd, cover):
            args = (
                text, ranks[cover], cover, len(rnd.rank_keys), need_rank,
                sort_impl,
            )
            run = lambda args=args: _full_round(*args)  # noqa: E731
        else:
            level_ids = sorted(
                lv for lv in ranks if lv in save_levels or lv == cover
            )
            args = (
                text, {lv: ranks[lv] for lv in level_ids}, rnd.rank_keys,
                rnd.tail_chars, rnd.tail_offset, alphabet, need_rank,
                sort_impl,
            )
            run = lambda args=args: _rank_block_sort(*args)  # noqa: E731
        sa, rank, done = timing.staged(
            f"wide_round[{i}](cover {cover}->{rnd.new_cover})" if dbg
            else None,
            run,
        )
        del run, args
        if need_rank:
            if cover not in save_levels:
                ranks.pop(cover, None)
            ranks[rnd.new_cover] = rank
        del rank
        cover = rnd.new_cover
    return sa


def _plan_shape(strategy: str, alphabet: pack.Alphabet):
    """(seed_chars, max_keys) for a strategy name. "wide" is the
    PARALLEL_SORTING shape (widest seed, 8-key rounds); "doubling" is
    the PREFIX_DOUBLING shape (one super-char seed -- 16 DNA bases per
    uint32, reference: kiss2_core.hpp:862-863 -- and 2-key doubling
    rounds, reference: kiss2_core.hpp:251,764-785). Both produce the
    identical exact-k + position-tiebreak order; they differ in round
    structure and cost."""
    if strategy == "doubling":
        return (16 if alphabet is pack.DNA else alphabet.chars_per_word, 2)
    assert strategy == "wide", strategy
    return (None, MAX_RANK_KEYS)


def k_ordered_suffix_array(
    ref, k=256, alphabet: pack.Alphabet = pack.DNA, as_numpy: bool = True,
    strategy: str = "wide", device="cuda",
):
    """Host entry point: int8 text -> SA (length n+1) on ``device``.

    Ordering contract (reference: kiss1_core.hpp:94-135): suffixes sorted
    by first k characters; a suffix that ends within k characters sorts
    before any longer suffix sharing its prefix; full-k ties broken by
    ascending text position; SA[0] = n (sentinel, reference:
    kiss_common.hpp:479).

    ``ref`` is a numpy array or a tensor; it is moved to ``device``,
    which must exist (``device="cuda"`` without CUDA raises). Returns a
    uint32 numpy array, or with ``as_numpy=False`` the int64 SA left on
    the device.
    """
    dev = resolve_device(device)
    if isinstance(ref, torch.Tensor):
        text = ref.to(device=dev, dtype=torch.int8)
    else:
        text = torch.from_numpy(np.ascontiguousarray(ref, dtype=np.int8))
    n = text.shape[0]
    if n == 0:
        sa0 = torch.zeros(1, dtype=torch.int64, device=dev)
        return sa0.cpu().numpy().astype(np.uint32) if as_numpy else sa0
    seed_chars, max_keys = _plan_shape(strategy, alphabet)
    plan = _make_plan(n, _normalize_k(k), alphabet, seed_chars, max_keys)

    with timing.stage("k_ordered_suffix_array") as out:
        text = text.to(dev)
        sa = _run_plan(text, plan, alphabet)
        out["block_on"] = sa
    if as_numpy:
        return pack.to_u32_bits(sa).cpu().numpy().view(np.uint32)
    return sa


def k_ordered_suffix_array_device(
    text: torch.Tensor, k: int | None = 256,
    alphabet: pack.Alphabet = pack.DNA, strategy: str = "wide",
) -> torch.Tensor:
    """Device core: int8 text tensor of length n -> int64 SA of length
    n+1 on the text's device, every round over the whole array (no tail
    compaction). Same ordering contract as the host path."""
    n = text.shape[0]
    seed_chars, max_keys = _plan_shape(strategy, alphabet)
    plan = _make_plan(n, _normalize_k(k), alphabet, seed_chars, max_keys)
    return _run_plan(text, plan, alphabet, refine_tail=False)


def _normalize_k(k) -> int | None:
    if k is None:
        return None
    k = int(k)
    if k < 0 or k >= 2**63:  # reference: -1 parsed as size_t wraps to max
        return None
    return k


def _mesh_size_for(num_threads, device="cuda") -> int:
    """Map the reference's thread knob onto the number of devices: the
    effective count is min(num_threads, visible CUDA devices) -- 1 on the
    CPU -- so reference habits like ``-t 24`` on one card run the
    single-device path."""
    if not num_threads or num_threads <= 1:
        return 1
    dev = torch.device(device)
    avail = torch.cuda.device_count() if dev.type == "cuda" else 1
    d = min(int(num_threads), max(avail, 1))
    if d < num_threads:
        timing.log_debug(
            "-t %d clamped to %d visible device(s)", num_threads, d
        )
    return d


class _SorterBase:
    """API facade matching the reference sorter contract
    (reference: include/biovoltron/algo/sort/sorter.hpp:7-10,
    kiss1_sorter.hpp:8-50): static ``get_suffix_array_dna`` /
    ``get_suffix_array`` / ``prepare_aligned_ref``.

    ``num_threads`` maps onto the device mesh (reference: src/main.cpp:
    23-26 caps TBB threads): values above 1 run the DNA sort on a mesh of
    min(num_threads, visible CUDA devices) cards
    (:mod:`kiss_tpu_torch.parallel`); 0/1/None, and the general alphabet,
    run the single-device pipeline.
    """

    SA_dtype = np.uint32
    strategy = "wide"

    @staticmethod
    def prepare_aligned_ref(seq) -> np.ndarray:
        return np.ascontiguousarray(seq, dtype=np.int8)

    @classmethod
    def get_suffix_array_dna(cls, ref, k=256, num_threads=None,
                             device="cuda") -> np.ndarray:
        d = _mesh_size_for(num_threads, device)
        if d > 1:
            from kiss_tpu_torch.parallel import make_mesh
            from kiss_tpu_torch.parallel.sharded_plan import (
                sharded_sa_blocks,
            )

            mesh = make_mesh(d, device=device)
            blocks = sharded_sa_blocks(mesh, ref, k, strategy=cls.strategy)
            return mesh.to_host(blocks)[: len(ref) + 1].astype(np.uint32)
        return k_ordered_suffix_array(
            ref, k, pack.DNA, strategy=cls.strategy, device=device
        )

    @classmethod
    def get_suffix_array(cls, ref, k=256, num_threads=None, device="cuda"):
        return k_ordered_suffix_array(
            ref, k, pack.GENERAL, strategy=cls.strategy, device=device
        )


class Kiss1Sorter(_SorterBase):
    """PARALLEL_SORTING strategy facade (reference: kiss1_sorter.hpp):
    widest raw-word seed (64 DNA chars in 4 words + the fused end/pos
    word), then up-to-8-key rank-block rounds."""

    strategy = "wide"


class Kiss2Sorter(_SorterBase):
    """PREFIX_DOUBLING strategy facade (reference: kiss2_sorter.hpp):
    a single 16-char super-char seed followed by 2-key doubling rounds
    sorting (rank[p], rank[p + cover], pos) with coverage x2 per round.
    Output is bit-identical to :class:`Kiss1Sorter`; the strategies
    differ in round structure and cost."""

    strategy = "doubling"
