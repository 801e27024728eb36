"""Where a sort round should take the rows still tied alone: the crossover
behind ``ops.suffix_sort._TIED_SHARE_MAX``.

For each tied share f, a text of n characters whose last f n form a
tandem repeat (a random unit of ``--period`` characters, tiled) and whose
rest is random DNA, so that about f of the rows stay tied after the
64-character seed, and through every round while the cover is short of
the repeat's length. Each sort runs twice: with the compacted path
forced (the share limit at 1: every round that may take the tied rows
alone does) and with the whole-array rounds forced (the limit at 0).
Times: CUDA events around the call, the median of ``--repeats`` after a
warm call (the host clock on the CPU), and the peak CUDA bytes a
character over the timed calls (the text, and what the caller holds,
included). A last row runs the synthetic
genome itself at its own share. The rule's limit sits below the share
where the two times meet and below the one where the compacted path's
peak passes the whole-array rounds'.

    python -m kiss_tpu_torch.experiments.tied_crossover --k 256
    python -m kiss_tpu_torch.experiments.tied_crossover --k -1 --n 248387328

Prints the card's name and power limit and a markdown table, and appends
both to ``--results`` when given. ``--device cpu --n 200000 --repeats 1``
rehearses it on the CPU with K1's plain version (host-clock times).
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from kiss_tpu_torch.experiments import micro_kernels as mk
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops import suffix_sort as ss
from kiss_tpu_torch.utils.device import resolve_device
from kiss_tpu_torch.utils.synth import synth_genome

SHARES = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.95)


def tandem_text(n: int, share: float, period: int, seed: int) -> np.ndarray:
    """Random DNA, then a tandem repeat over the last ``share`` of it."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, n, dtype=np.int8)
    rep = int(n * share)
    unit = rng.integers(0, 4, period, dtype=np.int8)
    text[n - rep:] = np.tile(unit, -(-rep // period))[:rep]
    return text


def seed_tied_share(text_dev: torch.Tensor) -> float:
    """The share of rows tied after the wide plan's seed."""
    _, _, tied = ss._seed_sort(text_dev, ss._seed_max(pack.DNA), pack.DNA,
                               True)
    return int(ss._compact_rows(tied).shape[0]) / (text_dev.shape[0] + 1)


def timed_ms(fn, dev, repeats: int):
    """(median milliseconds of ``fn()`` after one warm call, the peak
    CUDA bytes of the calls, None on the CPU)."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    return statistics.median(times), peak


def both_paths(text_dev, k: int, dev, repeats: int):
    """((ms, peak bytes) with the compacted path forced, the same with
    whole-array rounds)."""
    def sort():
        return ss.k_ordered_suffix_array(text_dev, k, as_numpy=False,
                                         device=dev)

    kept = ss._TIED_SHARE_MAX
    out = []
    try:
        for limit in (1.0, 0.0):
            ss._TIED_SHARE_MAX = limit
            out.append(timed_ms(sort, dev, repeats))
    finally:
        ss._TIED_SHARE_MAX = kept
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=48_800_648)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--period", type=int, default=1000)
    ap.add_argument("--shares", default=",".join(map(str, SHARES)))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--results", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    lines = [mk.device_line(dev),
             f"n = {args.n}, k = {args.k}, tandem period {args.period}, "
             f"median of {args.repeats} after a warm call",
             "",
             "| text | tied share after the seed | tied rows ms | whole "
             "array ms | tied / whole | tied rows B/char | whole array "
             "B/char |",
             "|---|---|---|---|---|---|---|"]
    print("\n".join(lines), flush=True)
    texts = [(f"tandem {f}", lambda f=f: tandem_text(
        args.n, f, args.period, args.seed)) for f in
        map(float, args.shares.split(","))]
    texts.append(("synth_genome", lambda: synth_genome(args.n, args.seed)))
    for name, make in texts:
        text_dev = torch.from_numpy(make()).to(dev)
        share = seed_tied_share(text_dev)
        (tied_ms, tied_b), (whole_ms, whole_b) = both_paths(
            text_dev, args.k, dev, args.repeats)
        per_char = [f"{b / args.n:.2f}" if b else "not measured"
                    for b in (tied_b, whole_b)]
        row = (f"| {name} | {share:.4f} | {tied_ms:.2f} | {whole_ms:.2f} | "
               f"{tied_ms / whole_ms:.3f} | {' | '.join(per_char)} |")
        lines.append(row)
        print(row, flush=True)
        del text_dev
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.results:
        with open(args.results, "a") as f:
            f.write("\n".join(lines) + "\n\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
