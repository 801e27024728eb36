"""Out-of-core k-ordered suffix sort for texts larger than device memory.

Port of ``kiss_tpu.ops.external_sort``. The in-core pipeline
(:mod:`kiss_tpu_torch.ops.suffix_sort`) holds every sort operand for all
n+1 suffixes on the device at once, about 85 bytes a character at k = 256
on the H100 (``cli.IN_CORE_BYTES_PER_CHAR`` keeps 160 with margin); at
chm13 scale (n = 3,117,292,070 -- the reference's headline corpus,
reference: README.md:94-101) that is far beyond one card. This module
runs the SAME ordering contract (k-ordered, shorter-first at end of text,
position tiebreak -- reference: kiss1_core.hpp:94-135) as a host-staged
external algorithm:

  1. **MSD bucket pass** (host, streaming): partition all n+1 suffixes
     by their first ``BUCKET_CHARS`` characters with a chunked counting
     sort -- the external form of the reference kISS-1 split-sort, which
     buckets by a 10-base / 2^20-bucket prefix before per-bucket sorts
     (reference: kiss1_core.hpp:41-83). Bucket ids are the top bits of
     the first packed key word, so bucket-major order composes with the
     in-bucket sorts into the global order.
  2. **Batch seed sorts** (device): contiguous bucket ranges are grouped
     into batches of at most ``batch_rows`` suffixes; each batch is one
     sort by the hand-written radix sort K1 (:func:`radix_sort_words`)
     over the same 5 words as the in-core seed sort (4 raw 2-bit words +
     the fused end/pos word, pack.fused_end_pos). Bucket boundaries
     never split across batches, so concatenating the sorted batches IS
     the global seed order.
  3. **Rank rounds** (host-staged): position-major rank arrays are
     rebuilt with chunked scans + one scatter, and each wide round
     re-sorts only the suffixes still in unresolved tie groups --
     compacted ACTIVE rows, contiguous per group, again in
     bucket-aligned segments, each one K1 sort of its rank keys, raw
     tail words and position. The round structure comes from the
     in-core planner (:func:`kiss_tpu_torch.ops.suffix_sort._make_plan`);
     exact-k plans whose remainder is smaller than the seed are closed
     with raw 4-bit tail key words gathered per active row
     (:func:`_np_tail_words`), so EVERY bounded k, unbounded (-1), and
     the exact-k decomposition behave identically to the in-core
     pipeline -- bit-identical in tests/test_torch_external_sort.py.

Only the per-batch sorts touch the device; everything resident is numpy
on host RAM, in uint32 (torch has no unsigned 32-bit arithmetic, and
int64 columns would double the host footprint). Peak host memory is ~25
bytes/char (text + packed key columns + SA + rank). Every batch is a
total order -- the seed's fused end/pos word and the rounds' position are
unique -- so K1's stable order is the JAX package's unstable sort's, and
no padding is needed: K1 takes any number of keys. DNA alphabet only
(sigma = 4; chm13's).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from kiss_tpu_torch.ops import pack, suffix_sort
from kiss_tpu_torch.ops.radix_sort import MAX_WORDS, radix_sort_wide
from kiss_tpu_torch.utils import timing
from kiss_tpu_torch.utils.device import resolve_device

# 10 characters / 2^20 buckets, matching the reference split-sort
# (reference: include/biovoltron/algo/sort/constant.hpp:12-37 --
# "kISS-1 split-sort: 10-char DNA prefix -> 2^20 buckets")
BUCKET_CHARS = 10
BUCKET_BITS = 2 * BUCKET_CHARS

SEED_CHARS = 64  # = suffix_sort._seed_max(pack.DNA)
_CHUNK = 1 << 26  # host streaming chunk (64M rows)


# ---------------------------------------------------------------------------
# host streaming primitives
# ---------------------------------------------------------------------------


def _np_seed_word(text: np.ndarray, word: int, n_chars: int = 16,
                  char_offset: int = 0) -> np.ndarray:
    """Host mirror of pack.suffix_key_words_2bit for one word: uint32[N]
    where entry p packs characters [p + char_offset + 16*word, +n_chars)
    big-endian, past-end positions contributing 0."""
    n = text.shape[0]
    N = n + 1
    base = char_offset + 16 * word
    acc = np.zeros(N, dtype=np.uint32)
    vals = text.view(np.uint8) if text.dtype == np.int8 else text
    for j in range(n_chars):
        off = base + j
        shift = np.uint32(2 * (15 - j))
        if off >= n:
            break
        # text positions [off, n) land at suffix rows [0, n - off)
        acc[: n - off] |= vals[off:].astype(np.uint32) << shift
    return acc


def _np_word0_padded(text: np.ndarray, extra: int) -> np.ndarray:
    """uint32[N + extra] where entry p packs characters [p, p+16) of the
    zero-padded text big-endian -- seed word w of suffix p is then just
    ``W0p[p + 16 * w]``, so ONE array serves every seed word via shifted
    gathers.

    Built in two strided passes instead of 16 full-array shift-accums:
    block words B[q] = chars [16q, 16q+16), then
    W0p[16q + r] = (B[q] << 2r) | (B[q+1] >> (32 - 2r)).
    """
    n = text.shape[0]
    total = n + 1 + extra
    nb = -(-total // 16) + 1  # blocks covering every window + one spare
    vals = np.zeros(16 * (nb + 1), dtype=np.uint32)
    src = text.view(np.uint8) if text.dtype == np.int8 else text
    vals[:n] = src
    B = np.zeros(nb + 1, dtype=np.uint32)
    for j in range(16):
        B[:nb] |= vals[j : j + 16 * nb : 16] << np.uint32(2 * (15 - j))
    out = np.empty(16 * nb, dtype=np.uint32)
    out[0::16] = B[:nb]
    for r in range(1, 16):
        out[r::16] = (B[:nb] << np.uint32(2 * r)) | (
            B[1 : nb + 1] >> np.uint32(32 - 2 * r)
        )
    return out[:total]


def _np_fused_end_pos(n: int, cover: int) -> np.ndarray:
    """Host mirror of pack.fused_end_pos (same uint32 encoding)."""
    p = np.arange(n + 1, dtype=np.uint32)
    ln = np.uint32(n) - p
    return np.where(ln < np.uint32(cover), ln, p + np.uint32(cover))


def _bucket_ids(text: np.ndarray, chars: int) -> np.ndarray:
    """uint32[N] of the first ``chars`` characters of each suffix,
    big-endian-packed (the top bits of seed word 0, so bucket-major
    order is a prefix of the global seed order)."""
    assert 1 <= chars <= 16
    bid = _np_seed_word(text, 0, chars)
    return bid >> np.uint32(2 * (16 - chars))


def bucketize(text: np.ndarray, chars: int = BUCKET_CHARS,
              chunk: int = _CHUNK, bid: np.ndarray | None = None):
    """Chunked counting sort of all suffix positions by their first
    ``chars`` characters. Returns (positions uint32[N] grouped
    bucket-major, bucket_starts int64[n_buckets + 1]).

    The external form of the reference's histogram -> bucket prefix-sum
    -> scatter split (reference: kiss1_core.hpp:41-83); within-bucket
    order is arbitrary here (the batch sorts re-sort by full keys).
    ``bid`` lets callers reuse precomputed bucket ids.
    """
    n = text.shape[0]
    N = n + 1
    nb = 1 << (2 * chars)
    if bid is None:
        bid = _bucket_ids(text, chars)
    if chars <= 8 and bid.dtype != np.uint16:
        # numpy's stable argsort radix-sorts 16-bit ints -- much faster
        # per chunk than the 32-bit mergesort path
        bid = bid.astype(np.uint16)
    hist = np.bincount(bid, minlength=nb).astype(np.int64)
    starts = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(hist, out=starts[1:])
    out = np.empty(N, dtype=np.uint32)
    cur = starts[:-1].copy()
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        ids = bid[lo:hi]
        order = np.argsort(ids, kind="stable")
        sids = ids[order]
        # within-chunk rank of each element inside its bucket
        grp_start = np.flatnonzero(np.concatenate(
            [[True], sids[1:] != sids[:-1]]
        ))
        within = np.arange(hi - lo, dtype=np.int64) - np.repeat(
            grp_start, np.diff(np.concatenate([grp_start, [hi - lo]]))
        )
        dest = cur[sids] + within
        out[dest] = (lo + order).astype(np.uint32)
        cur += np.bincount(ids, minlength=nb).astype(np.int64)
    del bid
    gc.collect()
    return out, starts


def _batch_bounds(starts: np.ndarray, batch_rows: int) -> list[tuple[int, int]]:
    """Split [0, N) into bucket-aligned batches of <= batch_rows rows.
    Raises if a single bucket exceeds batch_rows."""
    sizes = np.diff(starts)
    big = int(sizes.max(initial=0))
    if big > batch_rows:
        raise ValueError(
            f"bucket of {big} rows exceeds batch_rows={batch_rows}; "
            f"raise batch_rows or BUCKET_CHARS"
        )
    bounds = []
    N = int(starts[-1])
    lo = 0
    nz = starts[np.concatenate([[True], np.diff(starts) > 0])]
    while lo < N:
        target = lo + batch_rows
        if target >= N:
            hi = N
        else:
            # last bucket boundary <= target
            j = int(np.searchsorted(nz, target, side="right")) - 1
            hi = int(nz[j])
            assert hi > lo
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _seg_bounds_from_keys(k0: np.ndarray, batch_rows: int):
    """Bucket-aligned batch splitting for refinement rounds: segment
    boundaries are where the leading rank key changes."""
    m = k0.shape[0]
    bounds = []
    lo = 0
    while lo < m:
        target = lo + batch_rows
        if target >= m:
            bounds.append((lo, m))
            break
        # scan back from target for the last segment boundary
        w = min(batch_rows, target - lo)
        seg = k0[target - w : target + 1]
        diffs = np.flatnonzero(seg[1:] != seg[:-1])
        if diffs.size == 0:
            raise ValueError(
                f"tie group longer than batch_rows={batch_rows}"
            )
        hi = target - w + int(diffs[-1]) + 1
        bounds.append((lo, hi))
        lo = hi
    return bounds


# ---------------------------------------------------------------------------
# device batch sort
# ---------------------------------------------------------------------------


def _lap(split: dict | None, key: str, t0: float, pending=None) -> float:
    """Add the seconds since ``t0`` to ``split[key]`` once the device work
    behind ``pending`` is done; returns the clock. Without a ``split`` (no
    timing asked for) it neither waits for the device nor reads the clock,
    and the downloads are the only waits."""
    if split is None:
        return t0
    timing.sync(pending)
    t = time.perf_counter()
    split[key] = split.get(key, 0.0) + t - t0
    return t


def _device_sort(cols, bits, device, split: dict | None, stage: str):
    """One batch on the device: the uint32 columns ``cols`` (most
    significant first; the last is unique to its row, so the order is
    total) uploaded as one int32 [W, m] tensor of their bits and sorted
    by K1. Above MAX_WORDS words the columns are first bit-packed into the
    fewest words (``bits`` is each column's width; the last column is kept
    within one word). Returns (the last column in sorted order, int64 on
    the device; the sorted rows of the other columns, whose adjacent
    compare gives the tie groups: the unique column must not split one).
    """
    t0 = time.perf_counter()
    keys = torch.empty((len(cols), cols[0].shape[0]), dtype=torch.int32,
                       device=device)
    for row, col in zip(keys, cols):
        row.copy_(torch.from_numpy(col.view(np.int32)))
    t0 = _lap(split, stage + " upload", t0, keys)
    if len(cols) > MAX_WORDS:
        keys, places = suffix_sort._pack_fields([
            (lambda r=r: pack.as_u32(r), b, i == len(cols) - 1)
            for i, (r, b) in enumerate(zip(keys, bits))
        ])
        place = places[-1]
    else:
        place = (32 * (len(cols) - 1), 32)
    words, _ = radix_sort_wide(keys)
    del keys
    last = suffix_sort._extract_field(words, place)
    if place[1] == 32:
        group = list(words[:-1])
    else:
        group = suffix_sort._mask_field(words, place)
    _lap(split, stage + " sort", t0, last)
    return last, group


def _download(split: dict | None, stage: str, sa: torch.Tensor,
              neq: torch.Tensor):
    """(positions as uint32 numpy, neq flags as a writable bool array);
    the time includes the wait for the flags' compare on the device."""
    t0 = time.perf_counter()
    out = (pack.to_u32_bits(sa).cpu().numpy().view(np.uint32),
           neq.cpu().numpy())
    _lap(split, stage + " download", t0)
    return out


# ---------------------------------------------------------------------------
# chunked rank machinery
# ---------------------------------------------------------------------------


def _rank_from_neq(sa: np.ndarray, neq_all: np.ndarray,
                   rank_out: np.ndarray, chunk: int = _CHUNK) -> None:
    """rank[sa[i]] = (row index of i's group head) + 1, streamed in
    chunks with a cross-chunk carry. Mirrors the in-core cummax +
    invert (suffix_sort._ranks_of_sorted)."""
    N = sa.shape[0]
    carry = np.uint32(0)
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        neq = neq_all[lo:hi]
        head = np.where(
            neq, np.arange(lo, hi, dtype=np.uint32), np.uint32(0)
        )
        if not neq[0]:
            head[0] = carry
        np.maximum.accumulate(head, out=head)
        carry = head[-1]
        rank_out[sa[lo:hi]] = head + np.uint32(1)


def _active_flags(neq: np.ndarray) -> np.ndarray:
    """Sorted-order flags of rows in tie groups of size >= 2."""
    nxt = np.empty_like(neq)
    nxt[:-1] = neq[1:]
    nxt[-1] = True
    return ~(neq & nxt)


def _compact_u32(flags: np.ndarray, chunk: int = _CHUNK) -> np.ndarray:
    """flatnonzero into uint32 without the int64 intermediate at full N."""
    total = int(np.count_nonzero(flags))
    out = np.empty(total, dtype=np.uint32)
    w = 0
    for lo in range(0, flags.shape[0], chunk):
        idx = np.flatnonzero(flags[lo : lo + chunk])
        out[w : w + idx.size] = (idx + lo).astype(np.uint32)
        w += idx.size
    return out


def _shifted_rank(rank: np.ndarray, p: np.ndarray, off, n: int) -> np.ndarray:
    """rank[p + off] with 0 past the end -- the gather form of the
    in-core _rank_shift (zero-padded shifted slice)."""
    if off == 0:
        return rank[p]
    q = p.astype(np.uint64) + np.uint64(off)
    valid = q <= np.uint64(n)
    qc = np.minimum(q, np.uint64(n)).astype(np.uint32)
    out = rank[qc]
    out[~valid] = 0
    return out


def _np_tail_words(text: np.ndarray, pA: np.ndarray, tail_chars: int,
                   tail_offset: int) -> list[np.ndarray]:
    """Host mirror of pack.suffix_key_words (DNA alphabet: 4 bits/char,
    value c+1, 8 chars per uint32, big-endian, past-end -> 0) gathered
    for the compacted active rows only.

    These close an exact-k plan's raw tail (< seed chars) exactly like
    the in-core _rank_block_sort's tail operands, so arbitrary bounded k
    (the reference supports every k -- its comparator cuts at exact k,
    reference: kiss1_core.hpp:94-135; its protocol sweeps k in 2..256,
    reference: experiment/experiment_a.sh:10-39) works out-of-core too.
    The active set is small by the tail round (post-seed tie groups), so
    per-row host gathers are affordable here where they are not at N.
    """
    n = text.shape[0]
    vals = text.view(np.uint8) if text.dtype == np.int8 else text
    cpw = pack.DNA.chars_per_word  # 8
    cbits = pack.DNA.char_bits  # 4
    n_words = -(-tail_chars // cpw)
    p64 = pA.astype(np.int64)
    words = []
    remaining = tail_chars
    for w in range(n_words):
        chars = min(remaining, cpw)
        acc = np.zeros(pA.shape[0], dtype=np.uint32)
        for j in range(chars):
            idx = p64 + (tail_offset + w * cpw + j)
            valid = idx < n
            v = np.where(
                valid,
                vals[np.minimum(idx, max(n - 1, 0))].astype(np.uint32) + 1,
                np.uint32(0),
            )
            acc |= v << np.uint32(cbits * (cpw - 1 - j))
        words.append(acc)
        remaining -= chars
    return words


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def external_k_ordered_suffix_array(
    text: np.ndarray,
    k: int | None = 256,
    batch_rows: int = 1 << 26,
    bucket_chars: int = BUCKET_CHARS,
    verbose: bool = False,
    device="cuda",
    split: dict | None = None,
) -> np.ndarray:
    """int8 text (values 0..3) -> uint32 SA of length n+1, k-ordered
    with the exact in-core/reference ordering contract (sentinel first,
    shorter-first at end of text, position tiebreak at >= k chars).

    Bit-identical to :func:`kiss_tpu_torch.ops.suffix_sort.
    k_ordered_suffix_array` and to ``kiss_tpu.ops.external_sort``
    (tests/test_torch_external_sort.py); built for texts that cannot fit
    the in-core pipeline's device buffers. The batch sorts run on
    ``device`` (K1 on a CUDA device, its plain version on the CPU).

    With a ``split`` dict, each stage's seconds (bucketize, columns, the
    batches' and segments' upload, K1 sort and download summed, rounds,
    total) and the counts of seed batches and round segments are added to
    it; the device stages then wait for the card to time it. With
    ``verbose`` the stages are logged, the split among them.
    """
    dev = resolve_device(device)
    text = np.ascontiguousarray(text, dtype=np.int8)
    n = text.shape[0]
    N = n + 1
    if n == 0:
        return np.zeros(1, dtype=np.uint32)
    plan = suffix_sort._make_plan(
        n, suffix_sort._normalize_k(k), pack.DNA
    )
    seed = plan.seed_chars
    bchars = min(bucket_chars, max(seed // 2, 1))
    if verbose and split is None:
        split = {}
    t_start = time.perf_counter()

    def log(msg):
        if verbose:
            timing.log_info("external_sort: %s", msg)

    n_words = -(-seed // 16)
    fast = seed % 16 == 0  # every seed word is a full 16-char window
    t0 = time.perf_counter()
    w0p = _np_word0_padded(text, 16 * (n_words - 1)) if fast else None
    bid = None
    if fast:
        bid = (w0p[:N] >> np.uint32(32 - 2 * bchars)).astype(
            np.uint16 if bchars <= 8 else np.uint32
        )
    with timing.span(None, log="external bucketize"):
        sa, bstarts = bucketize(text, bchars, bid=bid)
    del bid
    t0 = _lap(split, "bucketize", t0)
    log(f"bucketize done (2^{2 * bchars} buckets)")

    # ---- seed sort in bucket-aligned batches ------------------------------
    bounds = _batch_bounds(bstarts, batch_rows)
    del bstarts
    # per-word full gather columns (~4 x 4 bytes/char for the 64-char
    # seed); in the fast path every word is a shifted gather from the
    # single padded word-0 array
    cols = []
    for w in range(n_words):
        if fast:
            cols.append(w0p[sa + np.uint32(16 * w)])
        else:
            chars = min(seed - 16 * w, 16)
            full = _np_seed_word(text, w, chars)
            cols.append(full[sa])
            del full
        gc.collect()
    del w0p
    # fused end/pos word computed elementwise from the gathered
    # positions (pack.fused_end_pos semantics, no N-sized temp)
    nu = np.uint32(n)
    covf = np.uint32(seed)
    fcol = np.where(nu - sa < covf, nu - sa, sa + covf)
    gc.collect()
    t0 = _lap(split, "columns", t0)
    log(f"seed columns built; {len(bounds)} batches")

    need_rank = len(plan.rounds) > 0
    neq_all = np.empty(N, dtype=bool) if need_rank else None
    for bi, (lo, hi) in enumerate(bounds):
        # the raw words and the fused word, sorted as one key; the group
        # identity is the raw words plus the clamped length decoded from
        # the fused word (its position part must not split groups)
        fs, group = _device_sort([c[lo:hi] for c in cols] + [fcol[lo:hi]],
                                 [32] * (n_words + 1), dev, split, "seed")
        neq = suffix_sort._neq_adjacent(group + [torch.clamp(fs, max=seed)])
        # decode positions from the fused word (pack.fused_end_pos)
        ps = torch.where(fs < seed, n - fs, fs - seed)
        sa[lo:hi], neq = _download(split, "seed", ps, neq)
        if need_rank:
            neq_all[lo:hi] = neq
        if verbose and bi % 8 == 0:
            log(f"seed batch {bi + 1}/{len(bounds)}")
    del cols, fcol
    gc.collect()
    if split is not None:
        split["seed batches"] = len(bounds)
    t0 = time.perf_counter()
    if not need_rank:
        _log_split(log, split, t_start)
        return sa

    rank = np.empty(N, dtype=np.uint32)
    _rank_from_neq(sa, neq_all, rank)
    active = _active_flags(neq_all)
    del neq_all
    gc.collect()

    # ---- wide rounds over the compacted active set ------------------------
    # keep only rank levels a later non-full round will reference
    # (mirrors suffix_sort._run_plan); the live ``rank`` array is
    # mutated in place, so a level that must survive is snapshotted
    save_levels: set[int] = set()
    for rnd in plan.rounds:
        if not suffix_sort._is_full(rnd, min(lv for lv, _ in rnd.rank_keys)):
            save_levels.update(lv for lv, _ in rnd.rank_keys)
    ranks: dict[int, np.ndarray] = {seed: rank}
    rank_bits = max(int(N).bit_length(), 1)
    posbits = max(int(n).bit_length(), 1)
    cover = seed
    segments = 0
    for ri, rnd in enumerate(plan.rounds):
        rows = _compact_u32(active)
        m = rows.size
        log(f"round {ri}: cover={cover} active={m}")
        if m == 0:
            break
        pA = sa[rows]
        keys = [
            _shifted_rank(ranks[lv], pA, off, n)
            for lv, off in rnd.rank_keys
        ]
        bits = [rank_bits] * len(keys)
        if rnd.tail_chars:
            # exact-k remainder smaller than the seed: close it with raw
            # 4-bit key words gathered per active row (in-core
            # counterpart: _rank_block_sort's tail operands)
            tail = _np_tail_words(text, pA, rnd.tail_chars, rnd.tail_offset)
            keys.extend(tail)
            bits.extend([32] * len(tail))
        is_last = ri == len(plan.rounds) - 1
        need_next = (not is_last) or plan.unbounded
        if need_next and cover in save_levels:
            # a later non-full round still needs this level: snapshot it
            # before the in-place updates below
            rank = rank.copy()
        k0 = keys[0]
        sbounds = _seg_bounds_from_keys(k0, batch_rows)
        new_active_any = False
        for lo, hi in sbounds:
            ps, group = _device_sort(
                [kk[lo:hi] for kk in keys] + [pA[lo:hi]], bits + [posbits],
                dev, split, "round",
            )
            ps, neq = _download(split, "round", ps,
                                suffix_sort._neq_adjacent(group))
            del group
            rseg = rows[lo:hi]
            sa[rseg] = ps
            if need_next:
                # new ranks: head row (global) + 1, reset at each old
                # group start (neq includes the leading old-rank key)
                head = np.where(neq, rseg, np.uint32(0)).astype(np.uint32)
                np.maximum.accumulate(head, out=head)
                rank[ps] = head + np.uint32(1)
                still = _active_flags(neq)
                active[rseg] = still
                new_active_any |= bool(still.any())
        segments += len(sbounds)
        del keys, k0, pA, rows
        gc.collect()
        if need_next:
            if cover not in save_levels:
                ranks.pop(cover, None)
            ranks[rnd.new_cover] = rank
        cover = rnd.new_cover
        if need_next and not new_active_any:
            break
        if plan.unbounded and cover > n:
            break
    _lap(split, "rounds", t0)
    if split is not None:
        split["round segments"] = segments
    _log_split(log, split, t_start)
    return sa


def _log_split(log, split: dict | None, t_start: float) -> None:
    """Adds the total to ``split`` and logs it as one line: each stage's
    seconds (the device stages' upload, K1 sort, and tie flags + download,
    summed over batches or segments)."""
    if split is None:
        return
    split["total"] = time.perf_counter() - t_start
    log("split " + ", ".join(
        f"{k} {v}" if isinstance(v, int) else f"{k} {v:.6f}"
        for k, v in split.items()
    ))
