"""Distributed multi-word key sort over a device mesh, PyTorch port.

Port of ``kiss_tpu.parallel.dsort``: the same two deterministic
algorithms behind one facade, each a function over this process's list of
blocks (see :class:`kiss_tpu_torch.parallel.mesh.Mesh`):

  - **columnsort** (Leighton 1985; the default for D >= 3): each block is
    one column of a B x D matrix. Sort the columns; transpose-deal
    (element i of each sorted block goes to shard i mod D, one uniform
    all-to-all); sort; undeal (the inverse all-to-all); sort; a half-block
    neighbour merge. Four local sorts of B keys, two all-to-alls and one
    half-block exchange for any D; valid for B >= 2 (D - 1)**2 and
    B % 2D == 0, so the facade pads small inputs up to that.
  - **block-bitonic** (D = 2, and a cross-check for powers of two): a
    bitonic network over the D blocks whose compare-exchange is a
    merge-split -- partners swap whole blocks, each sorts the 2B keys and
    keeps one half.

A block is one int32 tensor [W, B] of key words holding uint32 bits, word
0 most significant: the input of kernel K1 (:func:`radix_sort_wide`),
which is every local sort, on the block's own device. All-ones keys are
the largest, as K1 sorts unsigned.

:func:`sort_blocks` is the seam on blocks: the keys of a global array
already laid out over the shards (:func:`kiss_tpu_torch.parallel.mesh.
block_rows`) get the global row id appended as the last key word (pads get
all-ones keys and the ids N, N + 1, ...), which makes the order total and
equal to the stable sort's, and come back sorted in the same layout. The
pipeline of :mod:`.sharded_plan` and the build of :mod:`.fm_build` call it.
``kiss_tpu``'s mesh sort instead takes every operand as a key, with a
unique position put last by the caller.

The facade :func:`make_sharded_sort_impl` keeps the port's sort seam,
``sort_impl(keys int32 [W, N]) -> (sorted, perm)``, stable, for keys on
the lead device: split, :func:`sort_blocks`, join.
"""

from __future__ import annotations

import numpy as np
import torch

from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops.radix_sort import radix_sort_wide


def _lsort(block: torch.Tensor) -> torch.Tensor:
    """Local sort of a [W, B] block: kernel K1 on its device."""
    return radix_sort_wide(block.contiguous())[0]


def _merge_split(mesh, blocks, j: int, k: int):
    """One bitonic compare-exchange round between partners s and s ^ j."""
    theirs = mesh.ppermute(blocks, [(s, s ^ j) for s in range(mesh.size)])
    out = []
    for s, mine, other in zip(mesh.local, blocks, theirs):
        merged = _lsort(torch.cat([mine, other], dim=1))
        b = mine.shape[1]
        ascending = (s & k) == 0
        keep_lo = (s < (s ^ j)) == ascending
        out.append((merged[:, :b] if keep_lo else merged[:, b:]).contiguous())
    return out


def _block_bitonic(mesh, blocks):
    """Bitonic network over the mesh's locally sorted blocks."""
    blocks = [_lsort(b) for b in blocks]
    k = 2
    while k <= mesh.size:
        j = k // 2
        while j >= 1:
            blocks = _merge_split(mesh, blocks, j, k)
            j //= 2
        k *= 2
    return blocks


def _deal(mesh, blocks):
    """Columnsort step 2, the transpose-deal: element t * D + c of each
    sorted block goes to shard c, landing contiguously in source-block
    order -- one uniform all-to-all."""
    D = mesh.size
    # [D, W, B / D]: row c holds the elements congruent to c mod D
    sent = [x.reshape(x.shape[0], -1, D).permute(2, 0, 1) for x in blocks]
    return [z.permute(1, 0, 2).reshape(z.shape[1], -1)
            for z in mesh.all_to_all(sent)]


def _undeal(mesh, blocks):
    """Columnsort step 4, the inverse deal: chunk j of each block returns
    to shard j; the received chunks re-interleave by source."""
    D = mesh.size
    sent = [x.reshape(x.shape[0], D, -1).permute(1, 0, 2) for x in blocks]
    # element (source c, row t) goes to slot t * D + c
    return [z.permute(1, 2, 0).reshape(z.shape[1], -1)
            for z in mesh.all_to_all(sent)]


def _boundary_merge(mesh, blocks):
    """Columnsort steps 6-8 (shift by B / 2, sort, unshift) as one
    neighbour merge-split of half-blocks: shard j merges its
    predecessor's bottom half with its own top half, and the merged low
    half returns to the predecessor. Leighton's sentinel columns reduce
    to leaving shard 0's top and shard D - 1's bottom as they are."""
    D = mesh.size
    half = blocks[0].shape[1] // 2
    tops = [x[:, :half] for x in blocks]
    bots = [x[:, half:] for x in blocks]
    prev_bots = mesh.ppermute(bots, [(s, s + 1) for s in range(D - 1)])
    # shard 0 merges nothing; its top stands in for the low half it never
    # sends, so that every shard hands ppermute a block
    merged = [
        _lsort(torch.cat([p, t], dim=1)) if s > 0 else None
        for s, p, t in zip(mesh.local, prev_bots, tops)
    ]
    lows = [t if m is None else m[:, :half] for m, t in zip(merged, tops)]
    next_lows = mesh.ppermute(lows, [(s, s - 1) for s in range(1, D)])
    out = []
    for s, t, b, m, nl in zip(mesh.local, tops, bots, merged, next_lows):
        top = t if s == 0 else m[:, half:]
        bot = b if s == D - 1 else nl
        out.append(torch.cat([top, bot], dim=1))
    return out


def _block_columnsort(mesh, blocks):
    """Leighton's columnsort over the mesh's blocks (columns). The caller
    guarantees B % 2D == 0 and B >= 2 (D - 1)**2."""
    blocks = [_lsort(b) for b in blocks]  # 1
    if mesh.size == 1:
        return blocks
    blocks = [_lsort(b) for b in _deal(mesh, blocks)]  # 2, 3
    blocks = [_lsort(b) for b in _undeal(mesh, blocks)]  # 4, 5
    return _boundary_merge(mesh, blocks)  # 6-8


class SampleSortOverflow(RuntimeError):
    """A sample sort overflowed its bucket capacity or drift bound (see
    kiss_tpu_torch/parallel/ssort.py overflow contract); no result is
    returned. Re-run with ``algorithm="columnsort"`` (deterministic, no
    sampling assumptions)."""


def auto_algorithm(d: int) -> str:
    """What ``algorithm="auto"`` runs on d shards: bitonic for d <= 2,
    columnsort otherwise (``kiss_tpu``'s rule)."""
    return "bitonic" if d <= 2 else "columnsort"


def _algorithm(mesh, algorithm: str, B: int) -> str:
    """The algorithm ``algorithm`` names ("auto": :func:`auto_algorithm`)
    for blocks of B rows, checked: bitonic needs a power-of-two mesh,
    columnsort B % 2D == 0 and B >= 2 (D - 1)**2, the sample sort B % 2D
    == 0 and (``kiss_tpu``'s int32 row accounting) D B < 2**31."""
    D = mesh.size
    algo = auto_algorithm(D) if algorithm == "auto" else algorithm
    if algo not in ("bitonic", "columnsort", "sample"):
        raise ValueError(f"unknown sort algorithm {algorithm!r}")
    if algo == "bitonic" and D & (D - 1):
        raise ValueError("block-bitonic needs a power-of-2 mesh; use "
                         "columnsort")
    if algo == "sample" and B * D >= 2**31:
        raise ValueError(
            f"sample sort row accounting is int32: global N = {B * D} "
            '(padded) must be < 2**31; use algorithm="columnsort" at this '
            "scale"
        )
    if algo != "bitonic" and (B % (2 * D) or B < 2 * (D - 1) ** 2):
        raise ValueError(f"blocks of {B} rows do not suit {algo} on "
                         f"{D} shards")
    return algo


def sort_blocks(mesh, blocks: list, n: int, algorithm: str = "auto") -> list:
    """Sort the global key array whose blocks (int32 [W, B] a local
    shard, uint32 bits, word 0 most significant) these are; its rows n ..
    D B - 1 are pads. Returns the sorted blocks [W + 1, B] in the same
    layout, the global row id s B + i each row came from appended as the
    last word: a total order equal to the stable sort's, pads (all-ones
    keys, ids from n) last. "sample" raises :class:`SampleSortOverflow`
    when a bucket overflows. The list ``blocks`` is emptied: each key
    block is released once its copy with the row ids is made."""
    B = blocks[0].shape[1]
    algo = _algorithm(mesh, algorithm, B)
    full = []
    for s in mesh.local:
        x = blocks.pop(0)
        rid = s * B + torch.arange(B, dtype=torch.int64, device=x.device)
        full.append(torch.cat([torch.where(rid < n, x, -1),
                               pack.to_u32_bits(rid)[None]]))
        del x, rid
    if algo == "sample":
        from kiss_tpu_torch.parallel import ssort

        return ssort.block_sample_sort(mesh, full)
    if algo == "columnsort":
        return _block_columnsort(mesh, full)
    return _block_bitonic(mesh, full)


def make_sharded_sort_impl(mesh, algorithm: str = "auto"):
    """A sort with the port's seam, ``sort_impl(keys int32 [W, N]) ->
    (sorted [W, N], perm int64 [N])``, stable, that sorts on ``mesh``:
    ``keys`` (on the lead device) are split into the pipeline's blocks,
    sorted by :func:`sort_blocks` and joined back onto the lead device.

    ``algorithm``: "columnsort", "bitonic", "sample" or "auto" (bitonic
    for D <= 2, columnsort otherwise). "sample" is the splitter sample
    sort of :mod:`kiss_tpu_torch.parallel.ssort`, which raises
    :class:`SampleSortOverflow` when a bucket overflows. Its row
    accounting is that of ``kiss_tpu``: it rejects a padded N of 2**31 or
    more."""
    from kiss_tpu_torch.parallel.mesh import block_rows

    _algorithm(mesh, algorithm, block_rows(0, mesh.size))

    def sharded_sort(keys: torch.Tensor):
        W, n = keys.shape
        B = block_rows(n, mesh.size)
        _algorithm(mesh, algorithm, B)
        full = keys.new_zeros((W, B * mesh.size))
        full[:, :n] = keys
        blocks = mesh.split(full)
        del full
        out = mesh.join(sort_blocks(mesh, blocks, n, algorithm))
        del blocks
        return out[:W, :n], pack.as_u32(out[W, :n])

    return sharded_sort


def text_on(mesh, text) -> torch.Tensor:
    """``text`` (numpy or tensor) as int8 on the mesh's lead device."""
    if not isinstance(text, torch.Tensor):
        text = torch.from_numpy(np.ascontiguousarray(text, dtype=np.int8))
    return text.to(device=mesh.lead, dtype=torch.int8)


def sharded_k_ordered_suffix_array(mesh, text, k, algorithm: str = "auto",
                                   strategy: str = "wide"):
    """k-ordered SA (int64 [n + 1] on the lead device): the SA blocks of
    :func:`kiss_tpu_torch.parallel.sharded_plan.sharded_sa_blocks` (every
    length-N array of the pipeline sharded, every sort a mesh sort, by
    default columnsort) joined onto the lead device. Bit-identical to the
    single-device sorter. With ``algorithm="sample"`` an overflow of any
    sort raises :class:`SampleSortOverflow`."""
    from kiss_tpu_torch.parallel.sharded_plan import sharded_sa_blocks

    blocks = sharded_sa_blocks(mesh, text, k, algorithm, strategy)
    return mesh.join(blocks)[: len(text) + 1]
