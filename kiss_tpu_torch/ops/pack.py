"""Packed-key construction for suffix sorting and rank structures.

PyTorch port of ``kiss_tpu.ops.pack``. Instead of per-suffix vector loads
feeding a comparison sort (the reference's ``PackedDNAString`` AVX2
loads, reference: include/biovoltron/algo/sort/structs.hpp:83-185), fixed
width integer sort keys for *all* suffixes are built at once from shifted
whole-array slices, so ordering becomes integer comparison.

Key encoding: character c at text position p contributes the value c+1 in
a ``char_bits``-wide lane; positions past the end of text contribute 0,
which makes a suffix that runs out of text sort before any extension of
it -- the same end-of-text rule as the reference comparator
(reference: include/biovoltron/algo/sort/kiss1_core.hpp:131-134). Words
are big-endian within 32 bits so unsigned order equals lexicographic
character order.

Torch has no arithmetic on ``uint32`` tensors and its ``int32`` right
shift is arithmetic, so every "uint32" here is held in an ``int64``
tensor with a value in [0, 2**32), and masked after any operation that
can leave that range. Tables that are stored rather than computed with
(the packed BWT words) are ``int32`` tensors holding the uint32 bits;
:func:`as_u32` widens them back.

Two alphabets, mirroring the reference's DNA/general split
(reference: kiss1_core.hpp:229-268 vs 270-311):
  - DNA (sigma=4): 4 bits/char, 8 chars per 32-bit word.
  - general (sigma<=255): 10 bits/char, 3 chars per 32-bit word.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF


@dataclass(frozen=True)
class Alphabet:
    char_bits: int
    chars_per_word: int


DNA = Alphabet(char_bits=4, chars_per_word=8)
GENERAL = Alphabet(char_bits=10, chars_per_word=3)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 view of uint32 bits: an int32 tensor's bits, or an int64
    tensor already holding values below 2**32, widened and masked (the
    widened copy is masked in place: one int64 tensor at the peak)."""
    if x.dtype == torch.int64:
        return x & U32_MASK
    return x.to(torch.int64).bitwise_and_(U32_MASK)


def to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding the low 32 bits of int64 ``x`` (the storage
    form of a uint32 table; the cast wraps modulo 2**32)."""
    return (x & U32_MASK).to(torch.int32)


def _text_values(text: torch.Tensor) -> torch.Tensor:
    # uint8 view first so int8 inputs with values >= 128 stay positive
    vals = text.view(torch.uint8) if text.dtype == torch.int8 else text
    return vals.to(torch.int64)


def _window_values(text: torch.Tensor, start: int, n: int, length: int,
                   plus: int) -> torch.Tensor:
    """int64 [length]: the characters of ``text`` -- a window holding
    characters [start, start + len(text)) of a text of ``n`` -- plus
    ``plus``, zero from position n on and past the window."""
    out = torch.zeros(length, dtype=torch.int64, device=text.device)
    m = max(min(n - start, text.shape[0], length), 0)
    out[:m] = _text_values(text[:m]) + plus
    return out


def shifted_text(text: torch.Tensor, max_chars: int) -> torch.Tensor:
    """Return text+1 as int64, zero-padded so any window of
    ``max_chars`` characters starting at p <= n is in bounds."""
    n = text.shape[0]
    return _window_values(text, 0, n, n + max_chars, 1)


def key_word(
    padded: torch.Tensor,
    n_positions: int,
    char_offset: int,
    n_chars: int,
    alphabet: Alphabet = DNA,
) -> torch.Tensor:
    """word[p] packs characters [p+char_offset, p+char_offset+n_chars) of
    the suffix starting at p, big-endian, for p in [0, n_positions).

    ``padded`` comes from :func:`shifted_text`. ``n_chars`` less than a
    full word leaves the low lanes zero (used to cut keys at exactly k
    characters).
    """
    assert 1 <= n_chars <= alphabet.chars_per_word
    acc = torch.zeros(n_positions, dtype=torch.int64, device=padded.device)
    for j in range(n_chars):
        off = char_offset + j
        shift = alphabet.char_bits * (alphabet.chars_per_word - 1 - j)
        acc |= padded[off : off + n_positions] << shift
    return acc & U32_MASK


def suffix_key_words(
    text: torch.Tensor,
    n_chars: int,
    char_offset: int = 0,
    alphabet: Alphabet = DNA,
    *,
    start: int = 0,
    n: int | None = None,
    rows: int | None = None,
):
    """Packed key words covering ``n_chars`` characters starting at
    ``char_offset`` of every suffix 0..n (inclusive of the empty suffix at
    position n, whose words are all zero -- the sentinel sorts first, as
    in the reference where SA[0] = n).

    Returns a list of int64 tensors of length n+1, most-significant first.

    Block form: with ``n`` given, ``text`` is a window holding characters
    [start, start + len(text)) of a text of n characters, and the words
    are those of the ``rows`` suffixes from ``start`` on: rows [start,
    start + rows) of the whole text's result (zero past row n). The window
    must reach char_offset + n_chars - 1 characters past its last suffix,
    or the end of the text.
    """
    if n is None:
        n = text.shape[0]
    if rows is None:
        rows = n + 1 - start
    cpw = alphabet.chars_per_word
    n_words = -(-n_chars // cpw)
    padded = _window_values(text, start, n,
                            rows + char_offset + n_words * cpw, 1)
    words = []
    remaining = n_chars
    for w in range(n_words):
        chars = min(remaining, cpw)
        words.append(
            key_word(padded, rows, char_offset + w * cpw, chars, alphabet)
        )
        remaining -= chars
    return words


def suffix_key_words_2bit(
    text: torch.Tensor, n_chars: int, char_offset: int = 0, *,
    start: int = 0, n: int | None = None, rows: int | None = None,
):
    """Raw 2-bit packed DNA key words: 16 chars per 32-bit word,
    big-endian, past-end positions contribute 0. ``start``, ``n`` and
    ``rows`` give the block form of :func:`suffix_key_words`.

    Raw 2-bit packing cannot distinguish an 'A' run from running out of
    text; callers MUST pair these words with a shorter-first key
    (:func:`fused_end_pos` or :func:`clamped_suffix_len`) to reproduce
    the reference's end-of-text rule (reference:
    include/biovoltron/algo/sort/kiss1_core.hpp:131-134).
    """
    if n is None:
        n = text.shape[0]
    if rows is None:
        rows = n + 1 - start
    cpw = 16
    n_words = -(-n_chars // cpw)
    padded = _window_values(text, start, n,
                            rows + char_offset + n_words * cpw, 0)
    words = []
    remaining = n_chars
    for w in range(n_words):
        chars = min(remaining, cpw)
        acc = torch.zeros(rows, dtype=torch.int64, device=text.device)
        for j in range(chars):
            off = char_offset + w * cpw + j
            shift = 2 * (cpw - 1 - j)
            acc |= padded[off : off + rows] << shift
        words.append(acc & U32_MASK)
        remaining -= chars
    return words


def clamped_suffix_len(n: int, cover: int, device) -> torch.Tensor:
    """min(n - p, cover) for every suffix p in [0, n]: the shorter-first
    tiebreak companion to :func:`suffix_key_words_2bit`."""
    p = torch.arange(n + 1, dtype=torch.int64, device=device)
    return torch.clamp(n - p, max=cover)


def fused_end_pos(n: int, cover: int, device, *, start: int = 0,
                  rows: int | None = None) -> torch.Tensor:
    """One word encoding BOTH the shorter-first end-of-text rule and the
    ascending-position tiebreak for a ``cover``-character key window:

        fused[p] = n - p        if n - p < cover   (a "short" suffix)
                   p + cover    otherwise.

    Within a group of suffixes whose raw 2-bit key words tie, unsigned
    order of ``fused`` is exactly (clamped length asc, position asc) --
    the reference comparator contract (kiss1_core.hpp:94-135).

    Decode: p = n - fused if fused < cover else fused - cover; the
    clamped length (the group-identity component) is min(fused, cover).
    Block form: the ``rows`` positions from ``start`` on (past n the
    value is meaningless: those rows are pads).
    """
    if rows is None:
        rows = n + 1 - start
    p = start + torch.arange(rows, dtype=torch.int64, device=device)
    ln = n - p
    return torch.where(ln < cover, ln, p + cover)


# ---------------------------------------------------------------------------
# 2-bit symbol packing (BWT storage / occ rank words)
# ---------------------------------------------------------------------------

SYMS_PER_U32 = 16
_LANES = 0x55555555


def pack_dibits_u32(values: torch.Tensor) -> torch.Tensor:
    """Pack 2-bit symbols into 32-bit words, 16 per word, LSB-first;
    returns int32 holding the uint32 bits.

    LSB-first matches the reference DibitVector byte layout (reference:
    include/biovoltron/container/xbit_vector.hpp:11-66) viewed through
    little-endian uint32, so the device words and the ``.fmi``
    serialized bytes are the same bits.
    """
    n = values.shape[0]
    npad = -(-n // SYMS_PER_U32) * SYMS_PER_U32
    v = torch.zeros(npad, dtype=torch.int64, device=values.device)
    v[:n] = _text_values(values)
    v = v.reshape(-1, SYMS_PER_U32)
    acc = v[:, 0].clone()
    for j in range(1, SYMS_PER_U32):
        acc |= v[:, j] << (2 * j)
    return to_u32_bits(acc)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Branch-free population count over 32-bit lanes (int32 bits or
    int64 values below 2**32) -> int64."""
    x = as_u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32_MASK) >> 24


def count_symbol_prefix(word: torch.Tensor, sym, t: torch.Tensor):
    """Occurrences of 2-bit symbol ``sym`` among the first ``t`` symbols
    of each LSB-first packed ``word`` (t in [0, 16]) -> int64.

    The vectorized form of the reference's per-byte cnt_table scan
    (reference: include/biovoltron/algo/align/exact_match/fm_index.hpp:
    158-182): XOR against the replicated symbol, detect zero 2-bit lanes,
    mask to the first t lanes, popcount.
    """
    sym = torch.as_tensor(sym, device=word.device).to(torch.int64)
    x = as_u32(word) ^ (sym * _LANES)
    nx = ~x & U32_MASK  # logical complement: no sign bits for >> below
    zeros = nx & (nx >> 1) & _LANES
    t = t.to(torch.int64)
    lane_mask = torch.where(
        t >= SYMS_PER_U32,
        U32_MASK,
        (1 << (2 * torch.clamp(t, max=SYMS_PER_U32 - 1))) - 1,
    ) & _LANES
    return popcount_u32(zeros & lane_mask)


def np_pack_dibits_u32(values: np.ndarray) -> np.ndarray:
    """Host-side (numpy) variant of :func:`pack_dibits_u32`."""
    values = np.asarray(values, dtype=np.uint32)
    n = values.shape[0]
    npad = -(-n // SYMS_PER_U32) * SYMS_PER_U32
    v = np.zeros(npad, dtype=np.uint32)
    v[:n] = values
    v = v.reshape(-1, SYMS_PER_U32)
    shifts = (np.arange(SYMS_PER_U32, dtype=np.uint32) * 2)[None, :]
    return np.bitwise_or.reduce(v << shifts, axis=1).astype(np.uint32)


def np_pack_queries_2bit(queries: np.ndarray) -> np.ndarray:
    """Pack a batch of 2-bit symbol patterns row-wise, LSB-first, 16
    symbols per uint32: int8/uint8[Q, m] -> uint32[Q, ceil(m/16)].

    Symbol j of query q is ``(out[q, j // 16] >> (2 * (j % 16))) & 3``
    -- the same lane layout as :func:`pack_dibits_u32`/the BWT words.
    Packing cuts the host->device pattern transfer 4x versus int8.
    """
    q = np.asarray(queries)
    if q.dtype != np.uint8:
        q = q.astype(np.uint8)
    Q, m = q.shape
    W = -(-m // SYMS_PER_U32)
    buf = np.zeros((Q, W * SYMS_PER_U32), np.uint32)
    buf[:, :m] = q
    buf = buf.reshape(Q, W, SYMS_PER_U32)
    shifts = (np.arange(SYMS_PER_U32, dtype=np.uint32) * 2)[None, None, :]
    return np.bitwise_or.reduce(buf << shifts, axis=2).astype(np.uint32)
