"""The sort's roofline on the card: the dispatch-and-sync floor, the
streaming rate, and kernel K1 ``radix_sort_words`` against the operand
count W at the bench size.

Port of ``experiments/micro_roofline.py``, which measured the TPU's
``lax.sort`` of W in {1, 2, 3, 5, 8} random 32-bit operands at N =
48,800,649; K1 is the port's counterpart of that sort. Measures:

  1. the dispatch-and-sync floor: ``x + 1`` on 8 elements, synchronised
     (host clock, the least of 5);
  2. the streaming rate: the sum of 8 arrays of 1 GiB by eager adds (7
     kernels, each reading two arrays and writing one), by CUDA events,
     and beside it probe P1 ``stream_copy`` (``x + 1``,
     ``experiments.micro_kernels``; the port of
     ``experiments/micro_pallas.py:52``) on the first of them;
  3. K1 at each W on random words: its output held against
     ``radix_sort_words_plain`` exactly, its time beside its bound
     (``utils.roofline.k1_bound``), the 8-bit LSD traffic model (a (key,
     index) pair read and written in each digit pass, at the streaming
     rate), the JAX table's merge-model and single-pass fractions, and the
     marginal cost of one more word; at W = 1 and 2, one
     ``torch.sort(stable=True)`` of the words packed into one int64
     (:func:`packed_sort`), whose sorted words and permutation must equal
     K1's: the PyTorch call that computes K1's function at those widths.

    python -m kiss_tpu_torch.experiments.micro_roofline [--device cuda]

Prints the card's name and power limit and a markdown table, and appends
both to ``--results`` (``results_roofline.md`` beside this file).
``--device cpu --n 20000 --stream-bytes 1048576 --results /tmp/r.md``
rehearses it on the CPU with K1's plain version (host-clock times).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import torch

from kiss_tpu_torch.experiments import micro_kernels as mk
from kiss_tpu_torch.experiments.sort_split import digit_passes
from kiss_tpu_torch.ops.pack import as_u32, to_u32_bits
from kiss_tpu_torch.ops.radix_sort import (
    radix_sort_words,
    radix_sort_words_plain,
)
from kiss_tpu_torch.utils.device import resolve_device
from kiss_tpu_torch.utils.roofline import k1_bound

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results_roofline.md")
N_SORT = 48_800_649
WIDTHS = (1, 2, 3, 5, 8)
STREAM_ARRAYS = 8
STREAM_BYTES = 1 << 30
_TOP = -(2**31)  # int32 with only the top bit set


def packed_sort(keys: torch.Tensor):
    """K1's function for W <= 2 words (int32 [W, N] of uint32 bits, word 0
    most significant) by one ``torch.sort(stable=True)``: the words packed
    into one int64 whose signed order is their unsigned order (word 0's top
    bit flipped, shifted above word 1). Returns (sorted words, permutation
    int64), equal to :func:`radix_sort_words`'."""
    W, N = keys.shape
    if not 1 <= W <= 2:
        raise ValueError(f"packed_sort takes 1 or 2 words, got {W}")
    packed = pack_words(keys)
    values, perm = torch.sort(packed, stable=True)
    return unpack_words(values, W), perm


def pack_words(keys: torch.Tensor) -> torch.Tensor:
    """int64 [N] whose signed order is the unsigned order of the W <= 2
    words."""
    high = (keys[0] ^ _TOP).to(torch.int64)
    if keys.shape[0] == 1:
        return high
    return (high << 32) | as_u32(keys[1])


def unpack_words(values: torch.Tensor, W: int) -> torch.Tensor:
    """The words of :func:`pack_words`' values, int32 [W, N]."""
    if W == 1:
        return (values.to(torch.int32) ^ _TOP)[None]
    return torch.stack([(values >> 32).to(torch.int32) ^ _TOP,
                        to_u32_bits(values)])


def dispatch_floor(dev) -> float:
    """Seconds of the least of 5 synchronised ``x + 1`` on 8 elements."""
    tiny = torch.zeros(8, dtype=torch.int32, device=dev)
    best = float("inf")
    for _ in range(6):  # the first warms up
        t0 = time.perf_counter()
        y = tiny + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    del y
    return best


def stream(dev, nbytes: int, seed: int):
    """(seconds of the 8-array sum, the bytes its adds move, seconds of P1
    on the first array, the bytes P1 moves). Each array holds random
    32-bit words."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = nbytes // 4 // (2048 * mk.LANES) * (2048 * mk.LANES)
    xs = [torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev,
                        generator=g) for _ in range(STREAM_ARRAYS)]

    def total(x0):
        y = x0 + xs[1]
        for x in xs[2:]:
            y += x
        return y

    t_sum = mk.best_seconds(total, xs[0])
    moved = 3 * 4 * n * (STREAM_ARRAYS - 1)
    tiles = xs[0].reshape(-1, mk.LANES)
    del xs[1:]
    t_p1 = mk.best_seconds(mk.stream_copy, tiles, 2048,
                           launches=mk.COPY_LAUNCHES)
    return t_sum, moved, t_p1, 2 * 4 * n


def k1_rows(N: int, widths, dev, stream_bps: float, seed: int = 0):
    """K1 at each width on random words, held against its plain version
    and, at W <= 2, against :func:`packed_sort`. Returns {W: dict of ms,
    plain_ms, bound (ms, by), passes, lsd_ms, merge and single-pass
    fractions, library_ms and packed_ms (W <= 2)}."""
    g = torch.Generator(device=dev).manual_seed(seed)
    words = torch.randint(-(2**31), 2**31, (max(widths), N),
                          dtype=torch.int32, device=dev, generator=g)
    rows = {}
    for w in widths:
        keys = words[:w].contiguous()
        got = radix_sort_words(keys)
        want = radix_sort_words_plain(keys)
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise RuntimeError(f"K1 at W={w} differs from its plain version")
        del want
        row = {"passes": digit_passes(keys), "bound": k1_bound(keys)}
        if w <= 2:
            lib = packed_sort(keys)
            if not (torch.equal(lib[0], got[0])
                    and torch.equal(lib[1], got[1])):
                raise RuntimeError(f"torch.sort at W={w} differs from K1")
            del lib
            packed = pack_words(keys)
            row["library_ms"] = 1e3 * mk.best_seconds(
                lambda p: torch.sort(p, stable=True), packed)
            del packed
            row["packed_ms"] = 1e3 * mk.best_seconds(packed_sort, keys)
        del got
        t = mk.best_seconds(radix_sort_words, keys)
        row["ms"] = 1e3 * t
        row["plain_ms"] = 1e3 * mk.best_seconds(radix_sort_words_plain, keys,
                                                n=1)
        row["lsd_ms"] = 1e3 * row["passes"] * 16 * N / stream_bps
        once = 2 * 4 * N * w  # every operand read and written once
        row["merge"] = once * math.log2(N) / t / stream_bps
        row["single_pass"] = once / t / stream_bps
        rows[w] = row
        del keys
    return rows


def table(N: int, floor: float, sums, rows) -> list:
    t_sum, moved, t_p1, p1_bytes = sums
    stream_bps = moved / t_sum
    out = [
        "| measurement | ms | rate or fraction |", "|---|---|---|",
        f"| dispatch + sync floor (`x + 1`, 8 elements, host clock) | "
        f"{floor * 1e3:.4f} | - |",
        f"| sum of {STREAM_ARRAYS} x {p1_bytes // 2 >> 20} MiB "
        f"({STREAM_ARRAYS - 1} eager adds, {moved / 1e9:.3f} GB moved) | "
        f"{t_sum * 1e3:.4f} | {stream_bps / 1e9:.1f} GB/s |",
        f"| P1 `stream_copy` (`x + 1`, rows 2048) on the first array | "
        f"{t_p1 * 1e3:.4f} | {p1_bytes / t_p1 / 1e9:.1f} GB/s |",
    ]
    for w, r in rows.items():
        lib = ""
        if "library_ms" in r:
            lib = (f"; `torch.sort(stable=True)` of the packed int64 "
                   f"{r['library_ms']:.4f} ms, with packing and unpacking "
                   f"{r['packed_ms']:.4f} ms")
        out.append(
            f"| K1 W={w} N={N} ({r['passes']} digit passes) | {r['ms']:.4f} "
            f"| bound {r['bound'][0]:.4f} ms ({r['bound'][1]}); 8-bit LSD "
            f"traffic at the sum's rate {r['lsd_ms']:.4f} ms; merge-model "
            f"{100 * r['merge']:.1f}%, single-pass "
            f"{100 * r['single_pass']:.2f}%; plain {r['plain_ms']:.4f} ms"
            f"{lib} |")
    if 2 in rows and 8 in rows:  # the JAX table's (t8 - t2) / 6
        per = (rows[8]["ms"] - rows[2]["ms"]) / 6
        out.append(f"\n- marginal cost of one more 32-bit word (W = 2 to "
                   f"8): {per:.4f} ms at N = {N}.")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; absent CUDA raises)")
    ap.add_argument("--n", type=int, default=N_SORT,
                    help=f"keys a sort (default {N_SORT})")
    ap.add_argument("--stream-bytes", type=int, default=STREAM_BYTES,
                    help="bytes of each streamed array (default 1 GiB)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = mk.device_line(dev)
    print(card, flush=True)
    floor = dispatch_floor(dev)
    sums = stream(dev, args.stream_bytes, args.seed)
    rows = k1_rows(args.n, WIDTHS, dev, sums[1] / sums[0], args.seed)
    lines = table(args.n, floor, sums, rows)
    print("\n".join(lines), flush=True)
    with open(args.results, "a") as f:
        f.write(f"\n## Run {time.strftime('%Y-%m-%d %H:%M')} on {card}\n\n"
                + "\n".join(lines) + "\n")
    print(f"appended to {args.results}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
