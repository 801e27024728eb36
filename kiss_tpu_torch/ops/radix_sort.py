"""K1: stable multi-word key sort (``radix_sort_words``).

Replaces ``lax.sort(words, num_keys=W)`` at the suffix sort's call sites
(``kiss_tpu/ops/suffix_sort.py:334``, ``:389``, ``:469``, ``:521``).
Input: W <= 9 key words of 32 unsigned bits as an int32 tensor [W, N],
word 0 most significant (the layout ``suffix_sort._pack_fields``
builds). Output: the words in sorted order and the permutation (int64):
``sorted[:, j] == keys[:, perm[j]]``. The sort is stable: equal keys keep
their input order, which the tail refinement relies on for its payload.

On a CUDA tensor the wrapper launches the hand-written LSD radix sort in
``kiss_tpu_torch/csrc/radix_sort.cu``; on a CPU tensor it runs
:func:`radix_sort_words_plain`. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from kiss_tpu_torch import kernels
from kiss_tpu_torch.ops.pack import as_u32

MAX_WORDS = 9
_TILE = 4096  # keys per tile in radix_sort.cu (256 threads x 16 items)


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
    if N >= 2**31:
        raise ValueError(f"radix_sort_words takes N < 2**31 keys, got {N}")
    if keys.device.type == "cpu":
        return radix_sort_words_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"radix_sort_words: unsupported device {keys.device}")
    return _radix_sort_words_cuda(keys)


def _radix_sort_words_cuda(keys: torch.Tensor):
    """Host side of radix_sort.cu: least significant word first, each
    word gathered into the current order and sorted by its non-constant
    bytes while carrying a 32-bit index; all words gathered at the end."""
    W, N = keys.shape
    dev = keys.device
    if N == 0:
        return keys.clone(), torch.empty(0, dtype=torch.int64, device=dev)
    lib = kernels.library()
    stream = kernels.stream_of(dev)
    # one pass over the keys counts every (word, byte) digit; a byte whose
    # digits all fall in one bucket needs no scatter pass
    counts = torch.empty((W, 4, 256), dtype=torch.int32, device=dev)
    kernels.check(
        lib.kt_radix_digit_counts(
            keys.data_ptr(), W, N, counts.data_ptr(), stream
        ),
        "kt_radix_digit_counts",
    )
    kernels.count_launch("radix_sort_words")
    full = (counts.amax(dim=2) == N).cpu()
    plan = [
        (w, [b for b in range(4) if not bool(full[w, b])])
        for w in reversed(range(W))
    ]
    plan = [(w, bs) for w, bs in plan if bs]
    if not plan:
        return keys.clone(), torch.arange(N, dtype=torch.int64, device=dev)
    tiles = -(-N // _TILE)
    tile_hist = torch.empty(256 * tiles, dtype=torch.int32, device=dev)
    key_bufs = [torch.empty(N, dtype=torch.int32, device=dev)
                for _ in range(2)]
    idx_bufs = [torch.empty(N, dtype=torch.int32, device=dev)
                for _ in range(2)]
    gathered = torch.empty(N, dtype=torch.int32, device=dev)
    idx, j = None, 0
    for w, byte_ids in plan:
        if idx is None:  # identity order: the word as it is
            src_k = keys[w]
        else:
            kernels.check(
                lib.kt_gather_words(keys[w].data_ptr(), 1, N, idx.data_ptr(),
                                    gathered.data_ptr(), stream),
                "kt_gather_words",
            )
            src_k = gathered
        src_i = idx
        for b in byte_ids:
            dst_k, dst_i = key_bufs[j % 2], idx_bufs[j % 2]
            j += 1
            kernels.check(
                lib.kt_radix_sort_pass(
                    src_k.data_ptr(),
                    None if src_i is None else src_i.data_ptr(),
                    dst_k.data_ptr(), dst_i.data_ptr(), N, 8 * b,
                    tile_hist.data_ptr(), counts[w, b].data_ptr(), stream,
                ),
                "kt_radix_sort_pass",
            )
            src_k, src_i = dst_k, dst_i
        idx = src_i
    out = torch.empty_like(keys)
    kernels.check(
        lib.kt_gather_words(keys.data_ptr(), W, N, idx.data_ptr(),
                            out.data_ptr(), stream),
        "kt_gather_words",
    )
    return out, idx.to(torch.int64)
