"""The reference's experiment protocol on the port: a k sweep over one sort
strategy, or a mesh-size sweep at k = 256, as CSV rows
``algo,test,k,num-threads,time,space``.

Port of ``experiments/run_experiments.py``, the JAX side of the
reference's ``experiment_a.sh`` (3 repeats a k over k in {2, 4, ..., 256,
-1} at fixed threads) and ``experiment_b.sh`` (the thread count swept at
k = 256) (reference: experiment/experiment_a.sh:10-39,
experiment_b.sh:10-39). The text is ``utils.synth.synth_genome(n, seed)``
on ``--device``. Each timed call is
``ops.suffix_sort.k_ordered_suffix_array(text, k, as_numpy=False,
strategy=..., device=...)``, synchronised, after one warm call at that k.

    python -m kiss_tpu_torch.experiments.run_experiments \\
        [--strategy wide|doubling] [--ks 2,4,8,16,32,64,128,256,-1] \\
        [--repeats 3] [--devices 1,2,4,8] [--out CSV] [--device cuda]

Columns: ``algo`` is ``kiss-tpu-torch`` (the wide strategy, the CLI's
PARALLEL_SORTING) or ``kiss-tpu-torch-doubling`` (PREFIX_DOUBLING);
``num-threads`` is 1 for the k sweep and the mesh size for ``--devices``;
``time`` is seconds; ``space`` is ``torch.cuda.max_memory_allocated`` over
the call (the peak statistics reset just before it), or the process's peak
RSS on ``--device cpu``, as the JAX script falls back to it.

Before the rows, for each k: the sort plan (seed characters, each round's
rank keys and raw tail characters), the stages the warm call ran (the
sorter's own stage log), whether the tail refinement ran, K1's launches
in the first timed call (``kernels.LAUNCHES``, reset before the call and
read after it) and its peak bytes a character above what the device held
before it. Exactness is checked, never traded for time: each wide SA is a
permutation in k-order on 100,000 sampled adjacent pairs
(``utils.checks.check_k_sorted_sample``), and each doubling SA equals the
wide SA of the same k, bit for bit; a mismatch raises.

``--devices 1,2,...`` is the ``experiment_b`` analog: at k = 256, for each
D, a mesh of D shards (``parallel.make_mesh(devices=[device] * D)``: all
on the one card, so peer copies and NCCL are not measured) sorts with
``parallel.mesh.sharded_suffix_sort``, and each mesh SA must equal the
single-device SA. The k sweep is then skipped, as in the JAX script.

At the end a markdown table of the median seconds and the peak bytes a
character for each k (or D) is printed. ``--device cpu --n 3000 --ks
2,16,100,-1 --repeats 1`` rehearses it all on the CPU with K1's plain
version.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import resource
import statistics
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kiss_tpu_torch import kernels
from kiss_tpu_torch.experiments.micro_kernels import device_line
from kiss_tpu_torch.ops import pack, suffix_sort
from kiss_tpu_torch.parallel import make_mesh
from kiss_tpu_torch.parallel import mesh as pmesh
from kiss_tpu_torch.utils import timing
from kiss_tpu_torch.utils.checks import LogLines, check_k_sorted_sample
from kiss_tpu_torch.utils.device import resolve_device
from kiss_tpu_torch.utils.synth import synth_genome

HERE = os.path.dirname(os.path.abspath(__file__))
HEADER = ["algo", "test", "k", "num-threads", "time", "space"]
ALGO = {"wide": "kiss-tpu-torch", "doubling": "kiss-tpu-torch-doubling"}
KS = "2,4,8,16,32,64,128,256,-1"
MESH_K = 256
SAMPLE_PAIRS = 100_000  # adjacent SA rows the order check samples


@dataclass
class Run:
    """One k (or mesh size) of a sweep: the first timed call's SA (uint32
    on the host), each timed call's seconds, ``space`` and peak bytes above
    what the device held before it, K1's launches in the first timed call,
    and the stages the warm call logged."""

    sa: np.ndarray
    seconds: list = field(default_factory=list)
    space: list = field(default_factory=list)
    above: list = field(default_factory=list)
    launches: int = 0
    stages: list = field(default_factory=list)


def plan_text(n: int, k: int, strategy: str) -> str:
    """The sort plan at (n, k): seed characters, then each round's rank
    keys (level@offset) and raw tail characters, and where a round sorts
    only the rows still tied: an unbounded plan's rounds run over the
    whole array only while more than ``_TIED_SHARE_MAX`` of the rows are
    tied, then the tail refinement takes over."""
    seed_chars, max_keys = suffix_sort._plan_shape(strategy, pack.DNA)
    plan = suffix_sort._make_plan(n, suffix_sort._normalize_k(k), pack.DNA,
                                  seed_chars, max_keys)
    share = f"{suffix_sort._TIED_SHARE_MAX:.0%}"
    parts = [f"seed {plan.seed_chars} chars"]
    if plan.unbounded:
        parts.append(f"while more than {share} of the rows are tied, rounds"
                     f" of {max_keys} rank keys over the whole array (cover"
                     f" x{max_keys}); then the tail refinement"
                     f" ({suffix_sort.MAX_RANK_KEYS} rank keys a round, on"
                     " the rows still tied)")
        return "; ".join(parts)
    cover = plan.seed_chars
    for i, r in enumerate(plan.rounds):
        keys = " ".join(f"{lv}@{off}" for lv, off in r.rank_keys)
        tail = f" + {r.tail_chars} tail chars" if r.tail_chars else ""
        tied = (f", on the rows still tied where at most {share} are"
                if i == len(plan.rounds) - 1 and suffix_sort._is_full(r, cover)
                else "")
        parts.append(f"round {i + 1}: {len(r.rank_keys)} rank keys ({keys})"
                     f"{tail} -> {r.new_cover}{tied}")
        cover = r.new_cover
    return "; ".join(parts)


def _staged(fn):
    """(``fn()``, the stage names the sorter logged while it ran): its
    debug stage log switched on for the call, kept from every handler."""
    logger = logging.getLogger("kiss_tpu_torch")
    lines = LogLines()
    handlers, level, propagate = logger.handlers[:], logger.level, \
        logger.propagate
    logger.handlers[:] = [lines]
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    try:
        out = fn()
    finally:
        logger.handlers[:] = handlers
        logger.setLevel(level)
        logger.propagate = propagate
    return out, [m.split(" elapsed")[0] for m in lines.lines
                 if " elapsed " in m and m.startswith(("seed_sort",
                                                       "wide_round",
                                                       "tail_refine"))]


def _timed(fn, dev):
    """(result, seconds, space, bytes above the start) of ``fn()``, ending
    in a synchronize; ``space`` is the peak CUDA bytes of the call, or on
    the CPU the process's peak RSS (and the bytes above the start None)."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = fn()
    timing.sync(out)
    dt = time.perf_counter() - t0
    if cuda:
        space = torch.cuda.max_memory_allocated(dev)
        return out, dt, space, space - base
    # ru_maxrss is kilobytes on Linux
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return out, dt, rss, None


def per_char(above: list, n: int) -> str:
    """The most bytes a character above the start, or "not measured" (on
    the CPU)."""
    if None in above:
        return "not measured"
    return f"{max(above) / n:.2f}"


def _host(sa: torch.Tensor) -> np.ndarray:
    return pack.to_u32_bits(sa).cpu().numpy().view(np.uint32)


def _repeats(sort, repeats: int, dev, what: str, check, stages=()) -> Run:
    """``repeats`` timed calls of ``sort`` (after its warm call), the
    launch counters reset before each; the first call's SA is handed to
    ``check`` (int64 tensor, uint32 numpy), which raises on a mismatch."""
    run = None
    for _ in range(repeats):
        kernels.reset_launch_counts()
        sa, dt, space, above = _timed(sort, dev)
        if run is None:
            run = Run(_host(sa), stages=list(stages),
                      launches=kernels.LAUNCHES["radix_sort_words"])
            if dev.type == "cuda" and run.launches == 0:
                raise RuntimeError(f"{what}: K1 was not launched")
            check(sa, run.sa)
        del sa
        run.seconds.append(dt)
        run.space.append(space)
        run.above.append(above)
    return run


def _rows(algo: str, n: int, k: int, threads: int, run: Run) -> list:
    return [[algo, f"synth{n}", k, threads, f"{dt:.6f}", space]
            for dt, space in zip(run.seconds, run.space)]


def sweep(text, ks, strategy: str, repeats: int, dev, reference=None,
          say=print):
    """The k sweep of one strategy on ``text`` (int8 tensor on ``dev``).
    ``reference`` maps k to the wide SA (uint32 numpy) that a doubling SA
    must equal; a k it lacks gets one untimed wide call. Returns (CSV rows,
    {k: Run})."""
    n = text.shape[0]
    rows, runs = [], {}
    for k in ks:
        def sort(k=k):
            return suffix_sort.k_ordered_suffix_array(
                text, k, as_numpy=False, strategy=strategy, device=dev)

        def check(sa, sa_host, k=k):
            if strategy == "wide":
                check_k_sorted_sample(text, sa, k, SAMPLE_PAIRS)
                return
            want = (reference or {}).get(k)
            if want is None:
                want = _host(suffix_sort.k_ordered_suffix_array(
                    text, k, as_numpy=False, device=dev))
            if not np.array_equal(sa_host, want):
                raise RuntimeError(f"k={k}: the doubling SA differs from "
                                   "the wide SA")

        warm, stages = _staged(sort)
        del warm  # off the card before the timed calls measure their peak
        runs[k] = run = _repeats(sort, repeats, dev, f"k={k} {strategy}",
                                 check, stages)
        rows += _rows(ALGO[strategy], n, k, 1, run)
        tail = [s for s in stages if s.startswith("tail_refine")]
        say(f"k={k} {strategy}: plan: {plan_text(n, k, strategy)}; ran: "
            f"{', '.join(stages)}; tail refinement "
            + (f"ran ({len(tail)} rounds)" if tail else "did not run")
            + f"; K1 launches {run.launches}; peak bytes a char above the "
            f"start {per_char(run.above, n)}; "
            + ("permutation and k-order on "
               f"{SAMPLE_PAIRS} sampled pairs ok" if strategy == "wide"
               else "SA bit-identical to the wide SA"))
    return rows, runs


def mesh_sweep(text_host: np.ndarray, sizes, repeats: int, dev, single,
               say=print):
    """The ``experiment_b`` analog at k = MESH_K: for each mesh size D, D
    shards on ``dev`` sort with ``sharded_suffix_sort``; each SA must equal
    ``single`` (the single-device SA, uint32 numpy). Returns (CSV rows,
    {D: Run})."""
    n = len(text_host)
    rows, runs = [], {}
    where = ("all on the one card, so peer copies and NCCL are not "
             "measured" if dev.type == "cuda" else "CPU shards of this "
             "process")
    say(f"mesh sweep at k={MESH_K}: D shards on {dev}, {where}")
    for d in sizes:
        mesh = make_mesh(devices=[dev] * d)

        def sort(mesh=mesh):
            return pmesh.sharded_suffix_sort(mesh, text_host, MESH_K)

        def check(sa, sa_host, d=d):
            if not np.array_equal(sa_host, single):
                raise RuntimeError(f"D={d}: the mesh SA differs from the "
                                   "single-device SA")

        timing.sync(sort())  # warm
        runs[d] = run = _repeats(sort, repeats, dev, f"D={d}", check)
        rows += _rows(ALGO["wide"], n, MESH_K, d, run)
        say(f"D={d}: SA equal to the single-device SA; K1 launches "
            f"{run.launches}; peak bytes a char above the start "
            f"{per_char(run.above, n)}")
    return rows, runs


def summary(runs, n: int, label: str) -> list:
    """Markdown table: median seconds, the spread and the peak bytes a
    character (``space`` and above the start) of each k or D."""
    out = [f"| {label} | median s | min .. max s | space B/char | above "
           "the start B/char |", "|---|---|---|---|---|"]
    for key, run in runs.items():
        out.append(f"| {key} | {statistics.median(run.seconds):.6f} | "
                   f"{min(run.seconds):.6f} .. {max(run.seconds):.6f} | "
                   f"{max(run.space) / n:.2f} | {per_char(run.above, n)} |")
    return out


def run(args) -> dict:
    """The sweep ``args`` asks for; writes the CSV and returns {"rows",
    "runs"} (``runs`` by k, or by D for ``--devices``)."""
    dev = resolve_device(args.device)

    def say(msg):
        print(msg, flush=True)

    say(device_line(dev))
    text_host = synth_genome(args.n, seed=args.seed)
    text = torch.from_numpy(text_host).to(dev)
    if args.devices:
        single = _host(suffix_sort.k_ordered_suffix_array(
            text, MESH_K, as_numpy=False, device=dev))
        rows, runs = mesh_sweep(
            text_host, [int(d) for d in args.devices.split(",")],
            args.repeats, dev, single, say)
        label = f"D (k={MESH_K})"
    else:
        ks = [int(k) for k in args.ks.split(",") if k]
        rows, runs = sweep(text, ks, args.strategy, args.repeats, dev,
                           say=say)
        label = f"k ({args.strategy})"
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        w.writerows(rows)
    for row in rows:
        say(",".join(str(x) for x in row))
    say("\n".join(summary(runs, args.n, label)))
    say(f"wrote {args.out}")
    return {"rows": rows, "runs": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=48_800_648)
    ap.add_argument("--out", default=os.path.join(HERE, "results.csv"))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--ks", default=KS,
                    help="comma-separated k values (-1 = unbounded)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--strategy", default="wide", choices=sorted(ALGO),
        help="sort strategy of the k sweep: wide = PARALLEL_SORTING, "
        "doubling = PREFIX_DOUBLING (the algo column records it)")
    ap.add_argument(
        "--devices", default="",
        help="comma-separated mesh sizes: sweep the mesh at k = 256 "
        "instead of k (the experiment_b.sh analog; the shards share the "
        "one device)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; absent CUDA raises)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic genome")
    args = ap.parse_args(argv)
    if args.quick:
        args.n = min(args.n, 1_000_000)
        args.ks = "16,256,-1"
        args.repeats = 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
