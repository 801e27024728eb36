"""The out-of-core sorter at an arbitrary bounded k (default 100) on a
half-giga-character text: the raw-tail rounds (``external_sort``'s
``_np_tail_words``) at a size the CLI routes out of core.

Port of ``experiments/spot_external_anyk.py``: the same default n
(500,000,000) and k, the same refusal of a k whose plan has no raw-tail
round (for example 128, a whole number of seed blocks), and the same checks,
taken from ``chm13_full`` (``check_permutation``: the SA is a permutation
of 0..n; ``check_order``: the whole k-order contract on 2,000,000 sampled
adjacent pairs). The text is ``utils.synth.synth_genome(n, --seed)``; each
batch of the sort is a K1 sort on ``--device``.

    python -m kiss_tpu_torch.experiments.spot_external_anyk [--n N] [--k K]

Host memory: n is cut to what the host holds by ``chm13_full``'s reckoning
(``HOST_BYTES_PER_CHAR`` of ``MEM_FRACTION`` of MemAvailable), and the
cut is printed. Prints the card's name and power limit, the plan, the
stage table (seconds, peak host RSS, the stage's peak CUDA bytes), the
sorter's stage split and K1's launches, and appends the table to
``--results`` (``results_chm13_full.md`` beside this file); the last line is
one JSON object with the same numbers. ``--device cpu --n 200000 --pairs
20000 --results /tmp/r.md`` rehearses it on the CPU with K1's plain
version.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

from kiss_tpu_torch import kernels
from kiss_tpu_torch.experiments import chm13_full
from kiss_tpu_torch.experiments.external_scale import host_memory
from kiss_tpu_torch.ops import external_sort, pack, suffix_sort
from kiss_tpu_torch.utils.device import resolve_device
from kiss_tpu_torch.utils.synth import synth_genome


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=500_000_000)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; absent CUDA raises)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic genome")
    ap.add_argument("--pairs", type=int, default=chm13_full.PAIRS,
                    help="adjacent SA rows the ordering check samples")
    ap.add_argument("--results", default=chm13_full.RESULTS)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    dev = resolve_device(args.device)
    card = chm13_full.card_line(dev)

    def say(msg):
        print(msg, flush=True)

    say(card)
    mem = host_memory()
    fits = (int(chm13_full.MEM_FRACTION * mem["MemAvailable"])
            // chm13_full.HOST_BYTES_PER_CHAR)
    n, k, cut = args.n, args.k, None
    if n > fits:
        cut = (f"n cut from {n} to {fits}: the host has "
               f"{mem['MemAvailable']} bytes available, a run may plan "
               f"{chm13_full.MEM_FRACTION:.0%} of them, and it needs about "
               f"{chm13_full.HOST_BYTES_PER_CHAR} a character")
        n = fits
    plan = suffix_sort._make_plan(n, suffix_sort._normalize_k(k), pack.DNA)
    tails = [r.tail_chars for r in plan.rounds if r.tail_chars]
    if not tails:
        raise SystemExit(
            f"k={k}: the plan has no raw-tail round; pick a k that is not a "
            f"multiple of the {plan.seed_chars}-character seed")
    rounds = [(r.rank_keys, r.tail_chars) for r in plan.rounds]
    say(f"host memory: total {mem['MemTotal']}, available "
        f"{mem['MemAvailable']} bytes; n = {n}" + (f" ({cut})" if cut else "")
        + f"; k = {k}: plan seed {plan.seed_chars}, rounds (rank keys, tail "
        f"chars) {rounds}")

    stage = chm13_full.Stages(dev)
    with stage("synthesize genome"):
        text = synth_genome(n, seed=args.seed)
    split: dict = {}
    kernels.reset_launch_counts()
    with stage(f"external suffix_sort k={k} (raw-tail rounds, K1 batches)"):
        sa = external_sort.external_k_ordered_suffix_array(
            text, k, verbose=True, device=dev, split=split)
    launches = kernels.LAUNCHES["radix_sort_words"]
    if dev.type == "cuda" and launches == 0:
        raise RuntimeError("K1 was not launched")
    chm13_full.check_permutation(sa, n, stage)
    chm13_full.check_order(text, sa, k, stage, samples=args.pairs)
    del sa

    table = ["| stage | seconds | peak RSS (GB) | stage peak CUDA (GB) |",
             "|---|---|---|---|"]
    table += [f"| {name} | {dt:.1f} | {rss:.1f} | {cuda / 1e9:.2f} |"
              for name, dt, rss, cuda in stage.rows]
    notes = [
        f"- card: {card}; host memory total {mem['MemTotal']}, available "
        f"{mem['MemAvailable']} bytes",
        f"- n = {n}" + (f" ({cut})" if cut else " (not cut)"),
        f"- plan: seed {plan.seed_chars}, raw-tail rounds of {tails} "
        "characters; the SA a permutation of 0..n and in k-order with "
        f"position ties on {args.pairs} sampled adjacent pairs",
        "- stage split (s): " + json.dumps(split),
        f"- K1 launches {launches}; peak CUDA bytes {stage.peak_cuda()}",
    ]
    say("\n".join(table + [""] + notes))
    with open(args.results, "a") as f:
        f.write(f"\n## Spot run {time.strftime('%Y-%m-%d %H:%M')}: the "
                f"out-of-core sorter at k={k} (raw-tail rounds), n={n}, "
                f"{card}\n\n" + "\n".join(table) + "\n\n" + "\n".join(notes)
                + "\n")
    say("[spot] ALL CHECKS PASSED")
    say(json.dumps({
        "card": card, "n": n, "cut": cut, "k": k,
        "seed_chars": plan.seed_chars, "tail_chars": tails,
        "stages": [{"name": name, "s": dt, "peak_rss_gb": rss,
                    "peak_cuda_bytes": cuda}
                   for name, dt, rss, cuda in stage.rows],
        "split_s": split, "k1_launches": launches,
        "peak_cuda_bytes": stage.peak_cuda(),
        "host_mem_total": mem["MemTotal"],
        "host_mem_available": mem["MemAvailable"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
