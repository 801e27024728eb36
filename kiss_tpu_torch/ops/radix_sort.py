"""K1: stable multi-word key sort (``radix_sort_words``).

Replaces ``lax.sort(words, num_keys=W)`` at the suffix sort's call sites
(``kiss_tpu/ops/suffix_sort.py:334``, ``:389``, ``:469``, ``:521``).
Input: W <= 9 key words of 32 unsigned bits as an int32 tensor [W, N],
word 0 most significant (the layout ``suffix_sort._pack_fields``
builds), N < 2**32 keys (``kiss_tpu``'s uint32 positions reach that far).
Output: the words in sorted order and the permutation (int64):
``sorted[:, j] == keys[:, perm[j]]``. The sort is stable: equal keys keep
their input order, which the tail refinement relies on for its payload.

On a CUDA tensor the wrapper launches the hand-written LSD radix sort in
``kiss_tpu_torch/csrc/radix_sort.cu``; on a CPU tensor it runs
:func:`radix_sort_words_plain`. There is no fallback between the two.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from kiss_tpu_torch import kernels
from kiss_tpu_torch.ops.pack import as_u32

MAX_WORDS = 9
MAX_KEYS = 2**32 - 1  # the kernel's index and counts are unsigned 32-bit
_STATUS_SPARE = 64  # 64-bit slots after the tile status: a ticket a pass


class DigitPass(NamedTuple):
    """One 8-bit pass of the LSD sort: byte ``byte`` (0 = least
    significant) of key word ``word``. ``next_word`` is the word whose
    values this pass writes in place of its sorted keys, gathered into the
    new order: set on the last pass of a word when another word follows."""

    word: int
    byte: int
    next_word: Optional[int]


def pass_plan(counts, n: int) -> list:
    """The digit passes a sort of ``n`` keys needs, in order, from the
    digit counts ``counts[w][b][d]`` (the number of keys whose byte ``b``
    of word ``w`` is ``d``). A byte whose keys all share one digit needs
    no pass; a word with no pass left is never touched. Words go least
    significant (last) first, bytes low to high. An empty plan means the
    keys are all equal and the sort is the identity. The counts are
    unsigned (a count of 2**31 or more read from int32 storage is given as
    uint32)."""
    counts = np.asarray(counts)
    W = counts.shape[0]
    if n == 0:
        return []
    words = []
    for w in reversed(range(W)):
        live = [b for b in range(4) if int(counts[w, b].max()) != n]
        if live:
            words.append((w, live))
    plan = []
    for i, (w, live) in enumerate(words):
        following = words[i + 1][0] if i + 1 < len(words) else None
        for b in live:
            plan.append(DigitPass(w, b, following if b == live[-1] else None))
    return plan


def radix_sort_words_plain(keys: torch.Tensor):
    """Plain version: stable ``torch.sort`` of each word's unsigned value
    (widened to int64), least to most significant word, carrying the
    permutation."""
    W, N = keys.shape
    perm = torch.arange(N, dtype=torch.int64, device=keys.device)
    for w in reversed(range(W)):
        order = torch.sort(as_u32(keys[w])[perm], stable=True).indices
        perm = perm[order]
    return keys[:, perm], perm


def radix_sort_words(keys: torch.Tensor):
    """Stable sort of [W, N] int32 key words (uint32 bits, word 0 most
    significant) -> (sorted words [W, N] int32, permutation int64[N])."""
    kernels.require(keys, "keys", torch.int32, 2)
    W, N = keys.shape
    if not 1 <= W <= MAX_WORDS:
        raise ValueError(f"radix_sort_words takes 1..{MAX_WORDS} words, got {W}")
    if N > MAX_KEYS:
        raise ValueError(f"radix_sort_words takes N < 2**32 keys, got {N}")
    if keys.device.type == "cpu":
        return radix_sort_words_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"radix_sort_words: unsupported device {keys.device}")
    with torch.cuda.device(keys.device):
        return _radix_sort_words_cuda(keys)


def radix_sort_wide(keys: torch.Tensor):
    """:func:`radix_sort_words` for any number of words: more than
    MAX_WORDS are sorted as groups of at most MAX_WORDS words, the least
    significant group first, each group's stable sort taking the keys in
    the order the one before left them (LSD over word groups). Same
    output contract: (sorted words, permutation)."""
    W = keys.shape[0]
    if W <= MAX_WORDS:
        return radix_sort_words(keys)
    perm = None
    for hi in range(W, 0, -MAX_WORDS):
        group = keys[max(hi - MAX_WORDS, 0) : hi]
        if perm is not None:
            group = group[:, perm]
        _, p = radix_sort_words(group.contiguous())
        perm = p if perm is None else perm[p]
    return keys[:, perm], perm


def digit_counts_cuda(keys: torch.Tensor) -> torch.Tensor:
    """``counts[w, b, d]`` of a CUDA key set (int32 [W, 4, 256], on the
    card): one kernel over all W words. Input of :func:`pass_plan` and the
    digit totals of every pass."""
    W, N = keys.shape
    counts = torch.empty((W, 4, 256), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        kernels.check(
            kernels.library().kt_radix_digit_counts(
                keys.data_ptr(), W, N, counts.data_ptr(),
                kernels.stream_of(keys.device),
            ),
            "kt_radix_digit_counts",
        )
    return counts


def _radix_sort_words_cuda(keys: torch.Tensor):
    """Host side of radix_sort.cu: the digit counts decide the plan (one
    download a sort); then one kernel a pass, the (key, index) pair
    alternating between two buffers; the last pass of a word brings in the
    next word; one gather at the end orders all W words."""
    W, N = keys.shape
    dev = keys.device
    if N == 0:
        return keys.clone(), torch.empty(0, dtype=torch.int64, device=dev)
    lib = kernels.library()
    stream = kernels.stream_of(dev)
    counts = digit_counts_cuda(keys)
    kernels.count_launch("radix_sort_words")
    plan = pass_plan(counts.cpu().numpy().view(np.uint32), N)
    if not plan:
        return keys.clone(), torch.arange(N, dtype=torch.int64, device=dev)
    tile = lib.kt_radix_tile_keys()
    tiles = -(-N // tile)
    # per (tile, digit) status words, then a ticket counter for each pass;
    # the index buffers hold uint32 bits (N may reach 2**32 - 1)
    status = torch.zeros(tiles * 256 + _STATUS_SPARE, dtype=torch.int64,
                         device=dev)
    key_bufs = [torch.empty(N, dtype=torch.int32, device=dev)
                for _ in range(2)]
    idx_bufs = [torch.empty(N, dtype=torch.int32, device=dev)
                for _ in range(2)]
    src_k, src_i = keys[plan[0].word], None  # identity order: the word itself
    for j, p in enumerate(plan):
        dst_k, dst_i = key_bufs[j % 2], idx_bufs[j % 2]
        kernels.check(
            lib.kt_radix_onesweep_pass(
                src_k.data_ptr(),
                None if src_i is None else src_i.data_ptr(),
                dst_k.data_ptr(), dst_i.data_ptr(), N, 8 * p.byte,
                counts[p.word, p.byte].data_ptr(), status.data_ptr(),
                status.data_ptr() + 8 * (tiles * 256 + j), j + 1,
                None if p.next_word is None
                else keys[p.next_word].data_ptr(),
                stream,
            ),
            "kt_radix_onesweep_pass",
        )
        src_k, src_i = dst_k, dst_i
    # the last sorted word is in order in src_k; words that had no pass are
    # constant; the others are gathered through the final index, four at a
    # time by way of 16-byte entries (a single left-over word directly)
    top = plan[-1].word
    gathered = sorted({p.word for p in plan} - {top})
    groups = [gathered[i : i + 4] for i in range(0, len(gathered), 4)]
    direct = groups.pop() if groups and len(groups[-1]) == 1 else []
    del key_bufs, idx_bufs, dst_k, dst_i  # the spare pair makes room
    out = torch.empty_like(keys)
    kernels.check(
        lib.kt_gather_words(
            keys.data_ptr(), W, N, src_i.data_ptr(),
            sum(1 << w for w in direct),
            sum(1 << w for group in groups for w in group),
            src_k.data_ptr(), top, out.data_ptr(), stream,
        ),
        "kt_gather_words",
    )
    if groups:
        rows4 = torch.empty((N, 4), dtype=torch.int32, device=dev)
        for group in groups:
            rows = group + [-1] * (4 - len(group))
            kernels.check(
                lib.kt_gather_rows4(keys.data_ptr(), N, src_i.data_ptr(),
                                    *rows, rows4.data_ptr(), out.data_ptr(),
                                    stream),
                "kt_gather_rows4",
            )
        del rows4  # before the 64-bit permutation is made
    del src_k
    return out, as_u32(src_i)
