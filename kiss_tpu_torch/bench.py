"""Benchmark of the PyTorch + CUDA port: the repository's three reference
workloads on one NVIDIA GPU, after the repository's ``bench.py``.

Run from the repository root:

    python -m kiss_tpu_torch.bench            # on the card (--device cuda)
    python -m kiss_tpu_torch.bench --device cpu --n 30000 --nq 2000 \\
        --lookup-len 6                        # a small rehearsal on the CPU

The headline mirrors the reference's flagship number: suffix_sort of a
drosophila-chr1_2-sized text (n = 48,800,648) at k = 256, which the
reference does in 0.4809 s on 24 CPU threads, about 101.5 Mbp/s
(reference: README.md:87-89; BASELINE.md). The text is the synthetic
genome of ``utils/synth.py`` (about 70% fresh sequence, 25% mutated copies
of earlier segments, 5% tandem repeats) and the queries are 1,000,000
patterns of length 25 sampled from it (90% hits), both made from fixed
seeds (``--seed`` 0, ``--pattern-seed`` 7).

The other two workloads (reference: fmindex_build / batch fmindex_query,
include/command/fmindex_{build,query}.hpp) are measured on the same text:
the index build (the sort, the tables, the block table the query kernels
read and the lookup table; the `.fmi` serialization excluded), and 1M
length-25 pattern counts and stats (occurrences and the location checksum,
fmindex_query.hpp:87-94), each from host to host and on the device alone,
on both locate routes (the per-row walk of a full-sort index, the range BFS
of a ``-k 32`` one) and on an archive saved and loaded back.

Every device timing ends in a synchronize: PyTorch returns before the card
is done. Device-side paths report the best of their repeats, paths from
host to host the median (their spread is the host's); every repeat is
printed to stderr. The SA stays on the device, as the reference keeps it in
RAM. A result that differs between routes raises: the module then exits
non-zero and prints no JSON line.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"extra_metrics": [...], "device"} -- the names, units and rounding of
``bench.py``'s line, plus ``device``, the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them ("cpu" on the CPU).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

import numpy as np
import torch

from kiss_tpu_torch.experiments.micro_kernels import device_line
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops.lms_native import LmsSorter
from kiss_tpu_torch.ops.pack import np_pack_queries_2bit
from kiss_tpu_torch.ops.suffix_sort import (
    k_ordered_suffix_array,
    k_ordered_suffix_array_device,
)
from kiss_tpu_torch.utils import native, synth, timing
from kiss_tpu_torch.utils.device import resolve_device

N = 48_800_648
K = 256
NQ = 1_000_000
QLEN = 25
LLEN = 12  # the opt-in seed table's depth (fmindex_build --lookup-len 12)
BASELINE_MBP_S = 48.800648 / 0.4809  # reference: README.md:87-89


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError("bench: " + msg)


def bench_suffix_sort(text_dev) -> float:
    """Best of 3 warm calls of the single-program sort at k = 256 (every
    round over the whole array, no tail compaction)."""
    n = text_dev.shape[0]

    def run():
        sa = k_ordered_suffix_array_device(text_dev, K)
        timing.sync(sa)
        return sa

    sa = run()  # warm: the kernels' first launches, the allocator's pools
    _check(int(sa[0]) == n, f"SA[0] = {int(sa[0])}, not the sentinel {n}")
    # the library's host path (tail compaction) keeps the same ordering
    # contract: the same SA, bit for bit
    lib = k_ordered_suffix_array(text_dev, K, as_numpy=False,
                                 device=text_dev.device)
    _check(torch.equal(sa, lib), "the device-path SA differs from "
           "k_ordered_suffix_array's")
    del sa, lib
    best, _ = _min_of(3, run, f"suffix_sort n={n} k={K}")
    return best


def bench_suffix_sort_lms_host(text_host):
    """The native HOST strategy (-s LMS_INDUCED, csrc/kiss_lms.cpp): the
    reference's LMS + induced-sort core on the tier the reference runs it
    on. One timed run with 2 threads, as ``bench.py`` runs it, or None when
    the native library is not there."""
    if native.lms_induced_sort(np.zeros(0, "int8"), 1) is None:
        return None
    n = len(text_host)
    t0 = time.perf_counter()
    sa = LmsSorter.get_suffix_array_dna(text_host, 256, num_threads=2)
    dt = time.perf_counter() - t0
    _check(int(sa[0]) == n, "LMS_INDUCED SA[0] is not the sentinel")
    print(f"# suffix_sort LMS_INDUCED host k=256 {dt:.3f}s (2 threads, "
          f"{os.cpu_count()} host cores)", file=sys.stderr, flush=True)
    return dt


def bench_suffix_sort_unbounded(text_dev):
    """k = -1 (the full suffix array) by both strategies, through the
    library's host-driven path (tail refinement syncs with the host); 3
    repeats after a warm run, best of. The two SAs are equal."""
    n = text_dev.shape[0]
    out, first = {}, None
    for strategy, label in (
        ("wide", "PARALLEL_SORTING"),
        ("doubling", "PREFIX_DOUBLING"),
    ):
        def run(strategy=strategy):
            sa = k_ordered_suffix_array(
                text_dev, -1, as_numpy=False, strategy=strategy,
                device=text_dev.device,
            )
            timing.sync(sa)
            return sa

        sa = run()  # warm every tail capacity
        _check(int(sa[0]) == n, f"k=-1 {label}: SA[0] is not the sentinel")
        if first is None:
            first = sa
        else:
            _check(torch.equal(sa, first), "the k=-1 SAs of the two "
                   "strategies differ")
        del sa
        out[strategy], _ = _min_of(3, run, f"suffix_sort k=-1 {label}")
    return out


def _min_of(k, fn, label):
    """Run fn() k times after the caller's warmup; return (best, last
    result). Device-side paths are stable, so the least of the repeats is
    the machine's number."""
    times, out = [], None
    for _ in range(k):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    print(f"# {label} times={[round(t, 6) for t in times]}", file=sys.stderr)
    return min(times), out


def _median_of(k, fn, label):
    """Median over k warm repeats, for paths from host to host: a best of
    N understates what a user sees. The caller warms first; the full list
    is printed for the spread."""
    times, out = [], None
    for _ in range(k):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    print(
        f"# {label} median={med:.6f}s times={[round(t, 6) for t in times]}"
        f" (warm)",
        file=sys.stderr,
    )
    return med, out


def bench_fmindex(text_dev, text_host, nq: int = NQ, lookup_len: int = LLEN,
                  pattern_seed: int = 7):
    """Build and query metrics, the device-side and the host-to-host
    timings reported apart.

    Paths measured:
      - build (full sort) and build -k 32 (reference parity,
        fm_index.hpp:384-386);
      - nq length-25 counts: host to host (``FMIndex.counts``) and on the
        device (K2), at lookup 0 and from a depth-``lookup_len`` seed table;
      - stats (count + locate + checksum, fmindex_query.hpp:87-94) by the
        per-row walk of the full-sort index (K2 + K3): on the device and
        host to host;
      - the same stats by the range BFS of the -k 32 index (K2 + K4), the
        locate path of every reference-written archive;
      - the same stats on an archive saved and loaded back (the CLI's
        path, routed to the walk as its `.meta` sidecar records).
    """
    dev = text_dev.device
    n = text_dev.shape[0]

    def build(sort_len):
        # what FMIndex.build does, from the text already on the device: the
        # sort, the tables, the block table K2-K4 read, the lookup table
        fmi = fm.FMIndex(sa_intv=4, lookup_len=0, device=dev)
        sa = k_ordered_suffix_array_device(text_dev, sort_len)
        arrays = fm.build_index_device(text_dev, sa, fmi.sa_intv)
        del sa
        fmi.blocks = fm.block_table(arrays, fmi.sa_intv)
        fmi.arrays = arrays
        fmi.n_rows = n + 1
        fmi.full_sa = sort_len is None
        fmi._build_lookup()
        timing.sync((fmi.arrays, fmi.blocks))
        return fmi

    build(fm.SORT_LEN)  # warm
    build_s, fmi = _min_of(2, lambda: build(fm.SORT_LEN), "fmindex_build")
    build(32)  # warm
    build32_s, fmi32 = _min_of(2, lambda: build(32), "fmindex_build -k 32")

    pats = synth.sample_patterns(text_host, nq, QLEN, seed=pattern_seed)

    # ---- counts: host to host (pack, upload, search, download), then on
    # the device alone; median of 9 here (5 elsewhere): this path moves the
    # most bytes between host and device
    fmi.counts(pats)  # warm
    count_s, cnts = _median_of(9, lambda: fmi.counts(pats),
                               "fmindex_query counts e2e")
    _check(int(cnts.sum()) > 0, "no pattern was found")
    qwords_dev = torch.from_numpy(
        np_pack_queries_2bit(pats).view(np.int32)).to(dev)
    timing.sync(qwords_dev)

    def counts_dev():
        c = fm.counts_packed_device(fmi.arrays, qwords_dev, QLEN, 0,
                                    blocks=fmi.blocks)
        timing.sync(c)
        return c

    c0 = counts_dev()  # warm
    _check(np.array_equal(c0.cpu().numpy(), cnts),
           "device counts differ from FMIndex.counts")
    count_dev_s, _ = _min_of(3, counts_dev, "fmindex_query counts device")

    # lookup-accelerated counts: a depth-lookup_len seed table (4**L + 1
    # int64 entries: 134 MB at L = 12) skips lookup_len of the 25 LF steps
    # of each pattern (reference FMIndex LOOKUP_LEN, fm_index.hpp:237-269;
    # the reference CLI hardcodes 0, so this is an opt-in lever). The table
    # is one K2 launch over every seed, early_stop off.
    fmi_l = fm.FMIndex(sa_intv=4, lookup_len=lookup_len, arrays=fmi.arrays,
                       n_rows=n + 1, full_sa=True, device=dev,
                       blocks=fmi.blocks)
    t0 = time.perf_counter()
    fmi_l._build_lookup()
    timing.sync(fmi_l.arrays.lookup)
    print(f"# lookup table L={lookup_len} "
          f"({fmi_l.arrays.lookup.shape[0]} entries) built in "
          f"{time.perf_counter() - t0:.4f}s (first build)", file=sys.stderr)

    def counts_lookup_dev():
        c = fm.counts_packed_device(fmi_l.arrays, qwords_dev, QLEN,
                                    lookup_len, blocks=fmi_l.blocks)
        timing.sync(c)
        return c

    cl = counts_lookup_dev()  # warm
    _check(np.array_equal(cl.cpu().numpy(), cnts),
           f"the lookup-{lookup_len} counts differ from the lookup-0 counts")
    count_lookup_dev_s, _ = _min_of(
        3, counts_lookup_dev, f"fmindex_query counts device(lookup{lookup_len})"
    )
    del fmi_l, cl, c0

    # ---- stats by the walk (full-sort index), on the device. The
    # kernels size their work from the ranges: bench.py's doubling `cap`
    # of located positions is a static shape of JAX's, not needed here.
    def stats_walk_dev():
        b, e, _ = fm.get_range_packed_device(fmi.arrays, qwords_dev, QLEN, 0,
                                             blocks=fmi.blocks)
        return fm.batch_locate_stats_device(fmi.arrays, b, e, fmi.sa_intv,
                                            blocks=fmi.blocks)

    stats_walk_dev()  # warm
    stats_dev_s, (occ, checksum) = _min_of(
        3, stats_walk_dev, "fmindex_query stats device(walk)"
    )
    _check(occ == int(cnts.sum()), "the walk's occurrences differ from the "
           "counts'")

    # ---- stats from host to host (host patterns in, two integers out)
    fmi.batch_query_stats(pats)  # warm
    stats_s, got = _median_of(
        5, lambda: fmi.batch_query_stats(pats), "fmindex_query stats e2e"
    )
    _check(got == (occ, checksum), f"stats e2e {got} != {(occ, checksum)}")

    # ---- stats by the range BFS (the k-ordered archive's locate path); the
    # total is sum(end - beg), as kiss_tpu reports it
    def stats_bfs_dev():
        b, e, _ = fm.get_range_packed_device(fmi32.arrays, qwords_dev, QLEN,
                                             0, blocks=fmi32.blocks)
        return fm.bfs_query_stats(fmi32.arrays, b, e, fmi32.sa_intv,
                                  blocks=fmi32.blocks)

    stats_bfs_dev()  # warm
    stats_bfs_dev_s, got = _min_of(
        2, stats_bfs_dev, "fmindex_query stats device(bfs)"
    )
    _check(got == (occ, checksum), f"BFS stats {got} != {(occ, checksum)}")
    fmi32.batch_query_stats(pats)  # warm
    stats_bfs_s, got = _median_of(
        5, lambda: fmi32.batch_query_stats(pats),
        "fmindex_query stats e2e(bfs)",
    )
    _check(got == (occ, checksum),
           f"BFS stats e2e {got} != {(occ, checksum)}")
    del fmi32

    # ---- the CLI's path: archive round trip, sidecar-routed locate
    buf = io.BytesIO()
    fmi.save(buf)
    buf.seek(0)
    fmil = fm.FMIndex(sa_intv=4, device=dev).load(buf)
    del buf
    fmil.full_sa = True  # what the `.meta` sidecar records for this build
    fmil.batch_query_stats(pats)  # warm
    stats_loaded_s, got = _median_of(
        5, lambda: fmil.batch_query_stats(pats),
        "fmindex_query stats e2e(loaded archive)",
    )
    _check(got == (occ, checksum),
           f"loaded-archive stats {got} != {(occ, checksum)}")

    print(
        f"# fmindex_query stats: occ={occ} checksum={checksum}",
        file=sys.stderr,
    )
    return {
        "build_s": build_s,
        "build32_s": build32_s,
        "counts_per_s": nq / count_s,
        "counts_device_s": count_dev_s,
        "counts_lookup12_device_s": count_lookup_dev_s,
        "stats_s": stats_s,
        "stats_device_s": stats_dev_s,
        "stats_bfs_s": stats_bfs_s,
        "stats_bfs_device_s": stats_bfs_dev_s,
        "stats_loaded_s": stats_loaded_s,
        "occ": occ,
        "checksum": checksum,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kiss_tpu_torch.bench",
        description="The repository's benchmark on the port: suffix sort, "
        "index build and 1M-pattern queries; one JSON line.",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; absent CUDA raises) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="the genome's seed")
    ap.add_argument("--pattern-seed", type=int, default=7,
                    help="the patterns' seed")
    ap.add_argument("--n", type=int, default=N, help="text length")
    ap.add_argument("--nq", type=int, default=NQ, help="patterns")
    ap.add_argument("--lookup-len", type=int, default=LLEN,
                    help="the seed table's depth for the lookup counts")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n

    text_host = synth.synth_genome(n, args.seed)
    if dev.type == "cuda":
        held = torch.cuda.memory_allocated(dev)  # a caller's tensors
        torch.cuda.reset_peak_memory_stats(dev)
    text_dev = torch.from_numpy(text_host).to(dev)
    timing.sync(text_dev)

    best = bench_suffix_sort(text_dev)
    mbps = n / 1e6 / best
    unb = bench_suffix_sort_unbounded(text_dev)
    lms_s = bench_suffix_sort_lms_host(text_host)
    r = bench_fmindex(text_dev, text_host, args.nq, args.lookup_len,
                      args.pattern_seed)
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev) - held
        print(f"# peak CUDA bytes {peak} ({peak / n:.2f} per char) above "
              f"the {held} held before the run", file=sys.stderr)

    def m(name, value, unit, **kw):
        return {
            "metric": name,
            "value": round(value, 3 if unit == "s" else 1),
            "unit": unit,
            "vs_baseline": None,  # reference publishes no number for these
            **kw,
        }

    extra = [
        # unbounded (k = -1, full SA) throughput, both strategies
        m(
            "suffix_sort_k-1_parallel_sorting_Mbp_s",
            n / 1e6 / unb["wide"], "Mbp/s", seconds=round(unb["wide"], 3),
        ),
        m(
            "suffix_sort_k-1_prefix_doubling_Mbp_s",
            n / 1e6 / unb["doubling"], "Mbp/s",
            seconds=round(unb["doubling"], 3),
        ),
        *(
            [
                m(
                    "suffix_sort_k256_lms_host_Mbp_s",
                    n / 1e6 / lms_s, "Mbp/s", seconds=round(lms_s, 3),
                    note=f"native host strategy, 2 threads on a host of "
                    f"{os.cpu_count()} cores vs reference's 24 threads; "
                    "device strategies are the headline",
                )
            ]
            if lms_s
            else []
        ),
        m("fmindex_build_seconds_drosophila", r["build_s"], "s"),
        # reference-parity sort depth (fm_index.hpp:384-386 hardcodes 32)
        m("fmindex_build_k32_seconds_drosophila", r["build32_s"], "s"),
        m(
            "fmindex_query_1M_len25_counts_per_s",
            r["counts_per_s"],
            "patterns/s",
            occ=int(r["occ"]),
            checksum=int(r["checksum"]),
            timing="median-of-9-warm",
        ),
        m(
            "fmindex_query_1M_len25_counts_device_s",
            r["counts_device_s"],
            "s",
        ),
        # opt-in --lookup-len 12 seed table (skips 12 of 25 LF steps)
        m(
            "fmindex_query_1M_len25_counts_lookup12_device_s",
            r["counts_lookup12_device_s"],
            "s",
        ),
        # the batch loop's accumulators: count + locate + Sum(positions)
        # (fmindex_query.hpp:87-94); *_device_s on the device alone, the
        # others from host patterns to two integers on the host
        m("fmindex_query_1M_len25_stats_seconds", r["stats_s"], "s",
          timing="median-of-5-warm"),
        m("fmindex_query_1M_len25_stats_device_s", r["stats_device_s"], "s"),
        # the locate path of k-ordered (e.g. reference-written) archives
        m("fmindex_query_1M_len25_stats_bfs_seconds", r["stats_bfs_s"], "s",
          timing="median-of-5-warm"),
        m(
            "fmindex_query_1M_len25_stats_bfs_device_s",
            r["stats_bfs_device_s"],
            "s",
        ),
        # archive round trip + sidecar-routed stats: the CLI's path
        m(
            "fmindex_query_1M_len25_stats_loaded_seconds",
            r["stats_loaded_s"],
            "s",
            timing="median-of-5-warm",
        ),
    ]
    print(
        json.dumps(
            {
                "metric": "suffix_sort_throughput_drosophila_k256",
                "value": round(mbps, 3),
                "unit": "Mbp/s",
                "vs_baseline": round(mbps / BASELINE_MBP_S, 3),
                "extra_metrics": extra,
                "device": device_line(dev),
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
