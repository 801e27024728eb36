#!/usr/bin/env python3
"""Smoke run of kiss_tpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints one line, and any failure raises: the script then
exits non-zero and prints no result line):

  1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: the hand-written kernels (kiss_tpu_torch/csrc/*.cu) compiled
     by nvcc for sm_90a, one process per source, into
     kiss_tpu_torch/build/;
  3. each kernel against its plain PyTorch version on the card, exact
     (tolerance 0: every output is an integer), on edge cases at
     N = 2**22 + 7: W = 1, all-equal keys, a stable payload, lookup seeds;
     K1 also at N = 0, 1 and one key either side of one and two tiles; K4
     (the range BFS) on a ``-k 32`` index of the same text, on a query
     batch, the one-symbol ranges, a quarter of the SA, the whole table,
     empty ranges and a batch of 25-mer ranges with quarters among them,
     where the quarters are shown (``kernels.SPILLED``) to take K4's spill
     route;
  4. the golden outputs of the reference binary (tests/golden/*.npz)
     reproduced on the card, and the ``.fmi`` archives the reference
     binary wrote loaded and queried through the range BFS;
  5. the main path through ``kiss_tpu_torch.cli.main`` at full width: a
     48,800,648-character synthetic genome (utils.synth.synth_genome)
     through ``suffix_sort -k 256``, ``fmindex_build``, ``fmindex_query
     -b`` with 1,000,000 patterns of length 25 (sample_patterns) and
     ``fmindex_query -q``, with every kernel's launch counter reset just
     before and read just after; the counts and checksum are held
     against an independent 25-mer oracle computed on the card;
  6. each kernel against its plain version, exact, on the inputs the
     full-size main path hands it: every K1 call of the k = 256 and
     k = -1 sorts, K2 and K3 stats on the CLI's 100,000-query chunks of
     the batch over the 48.8M-char index, K3 rows on the ``-q`` rows;
  7. the range-BFS locate path at full width: ``fmindex_build -k 32``
     through the CLI (its ``.meta`` says ``full_sa: false``), then
     ``fmindex_query -b`` and ``-q`` on it, and ``-b`` on the full-sort
     archive with its ``.meta`` removed, each step with the launch
     counters reset just before and read just after: occurrences and
     checksum equal the oracle's, positions equal the full index's per-row
     walk, K4 launched (stats once a chunk of ``-b``, locate once for
     ``-q``) and K3 never; ``ShardedFMQuery.batch_query_stats`` (the ``-t
     N`` route, four shards on this card) through K4 with the oracle's
     answer; K4's two entry points held against their plain versions
     (positions element for element) and timed at a CLI chunk and the 1M
     batch, locate also by pass (``experiments.fm_query_time.measure_bfs``);
  7a. the out-of-core sorter at full width: ``suffix_sort --external -k
     256`` through the CLI (launch counters reset just before and read
     just after), and the library call at k = 100 and k = -1 with
     ``batch_rows = 2**21`` (several seed batches and round segments),
     each SA bit-identical to the in-core SA at the same k; the first K1
     launch of each width held against the plain version; the stage
     split;
  7b. the CLI's other sort routes: ``suffix_sort -k 256`` with
     ``KISS_TPU_INCORE_CAP`` below n logs the ``routing:`` line and sorts
     out of core, and ``-s LMS_INDUCED -k -1 -t 8`` on a random
     2**22 + 6-character text, whose SA (``LmsSorter``) equals the
     in-core one;
  7c. ``serve`` on the full-sort archive and on the ``-k 32`` one (the
     range BFS: K4 launched, K3 not) with an injected stdin (the ``-q``
     pattern, the batch, a missing batch file, ``quit``): ``ready``,
     ``ok``, ``ok``, ``err ...``, and the batch's occurrences and checksum
     equal the oracle's;
  7d. the general alphabet: ``get_suffix_array`` of DNA text equals
     ``get_suffix_array_dna``'s SA (launch counters reset just before and
     read just after); a 20-symbol text at 2**20 + 6 characters, k = 256
     and -1, equals the same call on the CPU; every K1 launch of the
     general sort held against the plain version;
  7e. the range BFS at N % 64 == 0: ``fmindex_build -k 32`` at n =
     2**22 - 1, then ``-b`` (the oracle's occurrences and checksum) and
     ``-q T`` (a range that ends at row N), both through K4;
  7f. the mesh of ``kiss_tpu_torch.parallel`` at full width, its shards
     on this one card (``make_mesh(devices=[cuda:0] * D)``), each step
     with the launch counters reset just before and read just after, its
     seconds and its peak bytes (and those above its start) per char:
     ``sharded_sa_blocks`` (the suffix sort in per-shard blocks, from the
     host text) at k = 256 and -1 by columnsort (D = 4), bitonic (D = 2)
     and sample sort (D = 4), each SA block equal to its slice of the
     single-device SA; columnsort and bitonic at k = -1 on 2, 4 and 8
     shards, whose peaks give the per-card cost of a D-card mesh;
     ``build_index_blocks`` + ``tables_to_host`` (D = 4), its ``.fmi``
     bytes those of the single-device build; the columnsort D = 4, k = 256
     SA and its build under ``utils.checks.LongestTensor``: no tensor
     longer than two blocks and the seed's halo;
     ``ShardedFMQuery.batch_query_stats`` of the 1M
     batch (the oracle's count and checksum) and ``sharded_batch_query``
     (K2 on each shard; the single-device K2 ranges); then each sort and
     build step again, untimed, with every local sort held against K1's
     plain version and K1 timed at each (W, N) of the k = 256 sorts and
     the build; K2 timed at the shard's launch shape; before the mesh, K1
     timed at each new launch shape of 7a-7d (external seed batch, round
     segment, general seed);
  7g. N = 2**31 + 4096 rows on the card, its memory freed before and
     given back after: a random text of 2**31 + 4095 characters made on
     the card from a seed; K1 sorts every position's 16-character word
     (W = 1), timed beside its bound and held to the whole contract of a
     stable sort (keys not decreasing, a permutation by a bitmap, equal
     keys in ascending position; against its plain version too where the
     card holds that); the 16-ordered SA (the 16 suffixes shorter than
     16 characters put back by the ordering contract) through
     ``FMIndex.build_rows``, the row-blocked build; 65,536 random 13-mers
     (inside the BFS contract) through K2 and K4 (stats, and locate of 8
     patterns), equal to an on-card oracle that never reads the index
     (the text's 13-mer codes counted, their positions summed) and, on
     4,096 queries, to the plain versions; the launch counters reset
     before the sort and before the queries, read after each; the peak
     CUDA bytes;
  7h. the reference's experiment protocol at full width
     (``kiss_tpu_torch.experiments.run_experiments``): the k sweep of both
     strategies at k = 2, 4, ..., 256, -1, one timed call after a warm one,
     the launch counters reset just before each timed call and read just
     after, every wide SA in k-order on 100,000 sampled pairs and every
     doubling (PREFIX_DOUBLING) SA bit-identical to the wide one, each
     call's peak CUDA bytes a character (above the card's holdings, plus
     the text) at or under ``cli.IN_CORE_BYTES_PER_CHAR``; K1 at the first
     launch of each (W, N) of the doubling plans held against its plain
     version and timed; K1 on random words at W = 1, 2, 3, 5, 8 and N =
     48,800,649 beside its bound, the streaming rate and, at W = 1 and 2,
     ``torch.sort`` of the words packed into one int64, each output equal
     (``experiments.micro_roofline``); ``suffix_sort -s PREFIX_DOUBLING -k
     256`` and ``-k -1`` through the CLI in turns with the default strategy
     at each k, K1 launched, each SA the sweep's; the mesh sweep at D = 2,
     k = 256;
  7i. the port's benchmark at full width (``kiss_tpu_torch.bench.main``,
     what ``python -m kiss_tpu_torch.bench`` runs: the device-path sort at
     k = 256, both strategies at k = -1, the LMS host sort, both index
     builds, the 1M batch's counts at lookup 0 and 12 and its stats on
     every route), the launch counters reset just before and read just
     after: its JSON line printed on a line of its own, its 14 metrics
     there, the occurrences and checksum of every route the phase 5
     oracle's, K1, K2, K3 stats and K4 stats launched; then K2 at the
     benchmark's two lookup-12 shapes over the CLI's index, the
     16,777,216-seed table build (the whole table) and the 1M x 25 batch
     seeded from it, each against its plain version, exact, and timed;
  8. the probe path: ``kiss_tpu_torch.experiments.micro_kernels`` and
     ``micro_copy`` through their ``main`` at the probes' own size
     (48,758,784 elements), launch counters reset just before and read
     just after; then each probe kernel P1-P7 against its plain version,
     exact, at those shapes, with its time, the plain version's and the
     one PyTorch call's where there is one; P6 and ``x.clone()`` timed in
     turns;
  9. step times of the main path and of the plain versions at the same
     shapes, K1 also at a tail-refinement shape (W = 8, N = 1,048,576);
     K5 at the seed sort's shape and K6 at the build cell's (N =
     248,387,329 rows), each against its plain version, exact, and timed;
     K2 and K3 timed alone (``experiments.fm_query_time``) at a CLI chunk,
     the whole batch, the ``-q`` rows and 1M random rows, each output held
     to the plain version, with the 32-byte sectors each table layout
     reads and their rate, and launches x (time - bound) at the shapes the
     main path launches; the two sorts K1 and P3 split by device kernel
     (``torch.profiler``);
     then one JSON line with each kernel's launches (K1-K3: the main
     path's; K4: the BFS route's ``-b`` for stats and ``-q`` for locate,
     every BFS route's under ``launches_by_path``, the queries on its
     spill route under ``spilled_by_case``; K1-K3 stats: the other paths'
     under ``launches_by_path``, the benchmark's among them), error, times
     and bound (K1's and K2's at every shape they were timed at under
     ``shapes``, with ``torch.sort``'s time at W = 1 and 2 as
     ``library_ms``), and as the last line ``{"ok":
     true, "device": {...}}``.

It imports the standard library, numpy, torch and kiss_tpu_torch only:
the synthetic genome and the patterns come from the port's own
``kiss_tpu_torch/utils/synth.py``.
"""

import json
import logging
import os
import struct
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_TEXT = 48_800_648
N_QUERIES = 1_000_000
QLEN = 25
SMALL_N = (1 << 22) + 6  # text length whose suffix count is 2**22 + 7
CLI_CHUNK = 100_000  # queries per batch_query_stats call of ``-b``
N_PROBE = 48_758_784  # elements per probe operand: 186 tiles of 2048 x 128
PROBE_ROWS = 2048
PROBE_REPS = 50  # launches per timing of a probe kernel
# out-of-core batch rows small enough that the 48.8M genome's seed takes
# many batches and its first round (about 5M active rows) several segments
EXT_BATCH_ROWS = 1 << 21
# phase 7g: a text of BIG_N characters, N = 2**31 + 4096 rows
BIG_N = 2**31 + 4095
# the build cell's rows (chm13 chromosome 1, kissbench's chm13chr1.build_full)
BUILD_N = 248_387_329
BIG_CHUNK = 1 << 28  # positions a step of 7g's tensor code takes at once
BIG_QUERIES = 65_536
BIG_QLEN = 13  # inside the BFS contract of a 16-ordered SA at sa_intv 4
BIG_LOCATED = 8  # patterns 7g locates
BIG_PLAIN_SAMPLE = 4096  # queries 7g holds against the plain versions
BIG_PATH = "7g: N = 2**31 + 4096 (K1 sort, build_rows, 13-mer queries)"
BENCH_PATH = "7i: python -m kiss_tpu_torch.bench (the benchmark's main)"

KERNELS = {
    "radix_sort_words": (
        "kiss_tpu_torch/csrc/radix_sort.cu", "kiss_tpu/ops/suffix_sort.py:334"
    ),
    "seed_key_words": (
        "kiss_tpu_torch/csrc/seed_pack.cu",
        "none: kiss_tpu/ops/suffix_sort.py:328-333 packs with jnp ops",
    ),
    "occ_tables": (
        "kiss_tpu_torch/csrc/occ_tables.cu",
        "none: kiss_tpu/models/fm_index.py:178-189 scans with jnp ops",
    ),
    "fm_backward_search": (
        "kiss_tpu_torch/csrc/fm_search.cu", "kiss_tpu/models/fm_index.py:444"
    ),
    "fm_locate_rows": (
        "kiss_tpu_torch/csrc/fm_locate.cu", "kiss_tpu/models/fm_index.py:616"
    ),
    "fm_locate_stats": (
        "kiss_tpu_torch/csrc/fm_locate.cu", "kiss_tpu/models/fm_index.py:583"
    ),
}
# the kernels of the main path (a full-sort archive locates by the walk)
MAIN_NAMES = tuple(KERNELS)
# K4, the range BFS: the route of -k N, reference-written and .meta-less
# archives, whose launches are read on that route (phase 7)
BFS_NAMES = ("fm_bfs_stats", "fm_bfs_locate")
KERNELS.update({
    "fm_bfs_stats": (
        "kiss_tpu_torch/csrc/fm_bfs.cu", "kiss_tpu/models/fm_index.py:695"
    ),
    "fm_bfs_locate": (
        "kiss_tpu_torch/csrc/fm_bfs.cu", "kiss_tpu/models/fm_index.py:690"
    ),
})
_PROBES_CU = "kiss_tpu_torch/csrc/micro_probes.cu"
PROBES = {
    "stream_copy": (_PROBES_CU, "experiments/micro_pallas.py:52"),
    "one_stage": (_PROBES_CU, "experiments/micro_pallas.py:101"),
    "tile_sort": (_PROBES_CU, "experiments/micro_pallas.py:147"),
    "kernel_gather": (_PROBES_CU, "experiments/micro_pallas.py:176"),
    "copy_grid": (_PROBES_CU, "experiments/micro_copy.py:43"),
    "copy_2d": (_PROBES_CU, "experiments/micro_copy.py:62"),
    "run_heavy": (_PROBES_CU, "experiments/micro_copy.py:103"),
}
KERNELS.update(PROBES)
PROBE_NAMES = tuple(PROBES)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs after
    one warm-up run, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wall_s(fn):
    """(result, seconds) of ``fn()`` ending in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def exact(a, b) -> int:
    """0 when two integer results are identical, else raise."""
    import torch

    if isinstance(a, torch.Tensor):
        check(a.shape == b.shape and torch.equal(a, b),
              "kernel disagrees with its plain version")
    else:
        check(a == b, f"kernel disagrees with its plain version: {a} != {b}")
    return 0


def phase_kernels(torch, np, err):
    """Each kernel against its plain version on edge cases."""
    from kiss_tpu_torch import kernels
    from kiss_tpu_torch.experiments.sort_split import seed_sort_words
    from kiss_tpu_torch.models import fm_index as fm
    from kiss_tpu_torch.ops import pack
    from kiss_tpu_torch.ops.radix_sort import (
        radix_sort_words,
        radix_sort_words_plain,
    )
    from kiss_tpu_torch.utils.synth import sample_patterns, synth_genome

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    text = synth_genome(SMALL_N, seed=3)
    N = SMALL_N + 1
    w5 = seed_sort_words(torch.from_numpy(text).to(dev))

    def rand_words(w, high, n=N):
        x = rng.integers(0, high, (w, n), dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(x.view(np.int32)).to(dev)

    cases = {
        "seed W=5": w5,
        "random W=8": rand_words(8, 2**32),
        "random W=1": rand_words(1, 2**32),
        "all-equal W=5": torch.full((5, N), 7, dtype=torch.int32, device=dev),
        "stable payload W=8 (4 values)": rand_words(8, 4),
    }
    # keys a tile of K1's pass kernel holds
    tile = kernels.library().kt_radix_tile_keys()
    small = (0, 1, tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile + 1)
    cases.update({f"W=5 N={n}": rand_words(5, 2**32, n) for n in small})
    cases.update({f"W=8 ties N={n}": rand_words(8, 3, n) for n in small})
    for name, keys in cases.items():
        gk, gp = radix_sort_words(keys)
        pk, pp = radix_sort_words_plain(keys)
        err["radix_sort_words"] = max(
            err["radix_sort_words"], exact(gp, pp), exact(gk, pk)
        )
    payload = torch.from_numpy(rng.permutation(N)).to(dev)
    _, gp = radix_sort_words(cases["stable payload W=8 (4 values)"])
    _, pp = radix_sort_words_plain(cases["stable payload W=8 (4 values)"])
    exact(payload[gp], payload[pp])

    idx = {
        L: fm.FMIndex(sa_intv=4, lookup_len=L, device=dev).build(text)
        for L in (0, 8)
    }
    nq = 1 << 18
    for qlen in (25, 12):
        pats = sample_patterns(text, nq, qlen, seed=qlen)
        qw = torch.from_numpy(
            pack.np_pack_queries_2bit(pats).view(np.int32)
        ).to(dev)
        for L in (0, 8):
            got = fm.get_range_packed_device(idx[L].arrays, qw, qlen, L,
                                             blocks=idx[L].blocks)
            want = fm.get_range_packed_device_plain(idx[L].arrays, qw, qlen,
                                                    L)
            for g, w in zip(got, want):
                err["fm_backward_search"] = max(
                    err["fm_backward_search"], exact(g, w)
                )
        arrays, blocks = idx[0].arrays, idx[0].blocks
        beg, end, _ = fm.get_range_packed_device(arrays, qw, qlen, 0,
                                                 blocks=blocks)
        err["fm_locate_stats"] = max(
            err["fm_locate_stats"],
            exact(fm.batch_locate_stats_device(arrays, beg, end, 4,
                                               blocks=blocks),
                  fm.batch_locate_stats_device_plain(arrays, beg, end, 4)),
        )
    rows = torch.from_numpy(rng.integers(0, N, nq)).to(dev)
    err["fm_locate_rows"] = exact(
        fm.locate_rows_device(idx[0].arrays, rows, 4, blocks=idx[0].blocks),
        fm.locate_rows_device_plain(idx[0].arrays, rows, 4),
    )
    # K4 on a 32-ordered index of the same text (the BFS route's): the
    # batch's ranges, the one-symbol ranges (T's ends at row N), a quarter
    # of the SA, the whole table and empty ranges
    k32 = fm.FMIndex(sa_intv=4, device=dev).build(text, sort_len=32)
    b, e, _ = fm.get_range_packed_device(k32.arrays, qw, 12, 0,
                                         blocks=k32.blocks)
    b1, e1, _ = k32._ranges(np.arange(4, dtype=np.int8)[:, None])

    def pair(*ranges):
        return tuple(torch.tensor(x, dtype=torch.int64, device=dev)
                     for x in zip(*ranges))

    # a batch of 25-mer ranges with ranges of a quarter of the SA among
    # them: the quarters (tree bound 85 nodes, over K4's 64) take the spill
    # route, the 25-mers the shared frontier
    p25 = torch.from_numpy(pack.np_pack_queries_2bit(
        sample_patterns(text, 1 << 16, 25, seed=25)).view(np.int32)).to(dev)
    bm, em, _ = fm.get_range_packed_device(k32.arrays, p25, 25, 0,
                                           blocks=k32.blocks)
    quarters = torch.arange(7, bm.shape[0], 8191, device=dev)
    bm[quarters], em[quarters] = N // 4, N // 2
    bfs_cases = {
        f"{nq} x 12": (b, e), "one symbol": (b1, e1),
        "a quarter": pair((N // 4, N // 2)), "whole": pair((0, N)),
        "empty": pair(*[(7, 7)] * 100),
        f"{bm.shape[0]} x 25 with {quarters.numel()} quarters": (bm, em),
    }
    spilled = {}  # queries on K4's spill route, by case and entry point
    for name, (bb, ee) in bfs_cases.items():
        kernels.reset_launch_counts()
        err["fm_bfs_locate"] = max(err["fm_bfs_locate"], exact(
            fm.bfs_locate_device(k32.arrays, bb, ee, 4, blocks=k32.blocks),
            fm.bfs_locate_device_plain(k32.arrays, bb, ee, 4)))
        err["fm_bfs_stats"] = max(err["fm_bfs_stats"], exact(
            fm.batch_bfs_stats_device(k32.arrays, bb, ee, 4,
                                      blocks=k32.blocks),
            fm.batch_bfs_stats_device_plain(k32.arrays, bb, ee, 4)))
        spilled[name] = dict(kernels.SPILLED)
    torch.cuda.synchronize()
    mixed = spilled[list(bfs_cases)[-1]]
    check(spilled["a quarter"] == {"fm_bfs_stats": 1, "fm_bfs_locate": 1}
          and min(mixed.values()) >= quarters.numel(),
          f"the quarters did not take K4's spill route: {spilled}")
    say(
        f"kernels vs plain, edge cases (exact, tolerance 0): K1 on "
        f"{len(cases)} key sets, 5 at N = {N} and {2 * len(small)} at N = "
        f"{', '.join(map(str, small))}; K2 on {nq} queries x qlen 25/12 x "
        f"lookup 0/8 over a {SMALL_N}-char index; K3 rows ({nq}) and "
        f"stats; K4 locate and stats on a -k 32 index of it ("
        f"{', '.join(bfs_cases)}): all equal; queries on K4's spill route "
        f"by case {spilled}"
    )
    return spilled


def phase_goldens(torch, np):
    import io
    import glob

    from kiss_tpu_torch.models.fm_index import FMIndex
    from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array

    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "golden", "*.npz")))
    check(paths, "no golden fixtures under tests/golden")
    for path in paths:
        data = np.load(path)
        text = data["text"]
        sa = k_ordered_suffix_array(text, -1, device="cuda")
        check(np.array_equal(sa, data["sa_kiss1_k-1"]),
              f"{os.path.basename(path)}: k=-1 SA differs from the golden")
        fmi = FMIndex(sa_intv=4, lookup_len=0, device="cuda").build(text)
        raw = data["patterns"].tobytes()
        qlen, nq = struct.unpack("<II", raw[:8])
        queries = np.frombuffer(raw[8:], dtype=np.int8).reshape(nq, qlen)
        occ, checksum = fmi.batch_query_stats(queries)
        want = tuple(int(x) for x in data["query_stats"])
        check((occ, checksum) == want,
              f"{os.path.basename(path)}: query stats {(occ, checksum)} "
              f"!= golden {want}")
        if os.path.basename(path) == "random4k.npz":
            buf = io.BytesIO()
            fmi.save(buf)
            check(buf.getvalue() == data["fmi"].tobytes(),
                  "random4k .fmi bytes differ from the golden")
        # the archive the reference binary wrote (32-ordered, no sidecar):
        # loaded through the port, located by the range BFS
        loaded = FMIndex(sa_intv=4, device="cuda").load(
            io.BytesIO(data["fmi"].tobytes())
        )
        check(not loaded.full_sa, "a loaded archive must route to the BFS")
        got = loaded.batch_query_stats(queries)
        check(got == want,
              f"{os.path.basename(path)}: reference-written .fmi answers "
              f"{got} != golden {want}")
    say(f"goldens on the card: {len(paths)} fixtures, k=-1 SA bit-identical, "
        "random4k .fmi byte-identical, query_stats equal; the "
        f"{len(paths)} reference-written .fmi loaded and answered through "
        "the range BFS with the stored query_stats")


def oracle_stats(torch, text_dev, pats_dev):
    """Independent count and position sum of every pattern: every 25-mer
    of the text as a 50-bit integer, sorted with its position."""
    n = text_dev.shape[0]
    t = text_dev.to(torch.int64)
    m = n - QLEN + 1
    codes = torch.zeros(m, dtype=torch.int64, device=t.device)
    for j in range(QLEN):
        codes = (codes << 2) | t[j : j + m]
    codes, pos = torch.sort(codes)
    prefix = torch.zeros(m + 1, dtype=torch.int64, device=t.device)
    prefix[1:] = torch.cumsum(pos, dim=0)
    p = pats_dev.to(torch.int64)
    pc = torch.zeros(p.shape[0], dtype=torch.int64, device=t.device)
    for j in range(QLEN):
        pc = (pc << 2) | p[:, j]
    lo = torch.searchsorted(codes, pc, right=False)
    hi = torch.searchsorted(codes, pc, right=True)
    return int((hi - lo).sum()), int((prefix[hi] - prefix[lo]).sum())


def recorded_k1(shapes, label, every=False):
    """A sort seam that runs K1 (``radix_sort_wide``) and keeps the keys of
    its first launch of each width (of every launch with ``every``) in
    ``shapes`` for :func:`phase_k1_shapes`. It launches nothing else."""
    from kiss_tpu_torch.ops.radix_sort import radix_sort_wide

    calls = []

    def sort(keys):
        calls.append(keys.shape)
        name = f"{label} W={keys.shape[0]}"
        if every:
            name = f"{label} launch {len(calls)} W={keys.shape[0]}"
        shapes.setdefault(name, keys)
        return radix_sort_wide(keys)

    return sort


def compared_k1(err):
    """A sort seam that runs K1 and holds every launch against the plain
    version, exact."""
    from kiss_tpu_torch.ops.radix_sort import (
        radix_sort_wide,
        radix_sort_words_plain,
    )

    def sort(keys):
        got = radix_sort_wide(keys)
        want = radix_sort_words_plain(keys)
        err["radix_sort_words"] = max(
            err["radix_sort_words"], exact(got[1], want[1]),
            exact(got[0], want[0]),
        )
        return got

    return sort


def phase_external(torch, np, cli, kernels, fa, text, text_dev, err, shapes):
    """7a: the out-of-core sorter at full width against the in-core SAs.
    Returns (K1 launches of the --external CLI run, the stage splits)."""
    from kiss_tpu_torch.ops import external_sort as ext
    from kiss_tpu_torch.ops.radix_sort import radix_sort_wide
    from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
    from kiss_tpu_torch.utils.checks import Kept

    t_phase = time.perf_counter()
    incore = {k: k_ordered_suffix_array(text_dev, k, device="cuda")
              for k in (256, 100, -1)}
    splits = {run: {} for run in (
        "--external -k 256 (CLI)", f"k=100, batch_rows {EXT_BATCH_ROWS}",
        f"k=-1, batch_rows {EXT_BATCH_ROWS}")}
    # the batches' sort seam keeps each width's first keys (no launch of its
    # own): phase_k1_shapes holds them to the plain version and times them
    ext.radix_sort_wide = recorded_k1(shapes, "--external -k 256",
                                      every=True)
    try:
        with Kept(ext, "external_k_ordered_suffix_array",
                  split=splits["--external -k 256 (CLI)"]) as kept:
            kernels.reset_launch_counts()
            rc = cli.main(["suffix_sort", "--external", "-k", "256", fa])
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    finally:
        ext.radix_sort_wide = radix_sort_wide
    check(rc == 0 and len(kept.values) == 1, "--external did not run")
    check(np.array_equal(kept.values[0], incore[256]),
          "--external -k 256 SA differs from the in-core SA")
    check(launches["radix_sort_words"] > 0
          and sum(launches.values()) == launches["radix_sort_words"],
          f"the --external route's launches are not K1 only: {launches}")
    ext.radix_sort_wide = recorded_k1(shapes, f"batch_rows {EXT_BATCH_ROWS}")
    try:
        for k in (100, -1):
            sa = ext.external_k_ordered_suffix_array(
                text, k, batch_rows=EXT_BATCH_ROWS, device="cuda",
                split=splits[f"k={k}, batch_rows {EXT_BATCH_ROWS}"],
            )
            check(np.array_equal(sa, incore[k]),
                  f"out-of-core k={k} SA differs from the in-core SA")
    finally:
        ext.radix_sort_wide = radix_sort_wide
    del sa, incore
    many = splits[f"k=100, batch_rows {EXT_BATCH_ROWS}"]
    check(many["seed batches"] >= 6 and many["round segments"] >= 2,
          f"batch_rows {EXT_BATCH_ROWS} did not split the work: {many}")
    say(f"out-of-core sorter n={len(text)}: --external -k 256 through the "
        f"CLI and k=100, k=-1 at batch_rows {EXT_BATCH_ROWS} bit-identical "
        "to the in-core SAs; K1 launches of the --external run "
        f"{launches['radix_sort_words']}; stage split (s): " + "; ".join(
            f"{run}: " + ", ".join(
                f"{k} {int(v) if k.endswith(('batches', 'segments')) else v}"
                for k, v in sp.items())
            for run, sp in splits.items())
        + f"; phase {time.perf_counter() - t_phase:.3f} s")
    return launches["radix_sort_words"], splits


def phase_routes(torch, np, cli, kernels, logs, tmp):
    """7b: the automatic route under KISS_TPU_INCORE_CAP, and
    -s LMS_INDUCED on random text. Returns the K1 launches of the routed
    run."""
    from kiss_tpu_torch import LmsSorter
    from kiss_tpu_torch.ops import external_sort as ext
    from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
    from kiss_tpu_torch.utils import fasta
    from kiss_tpu_torch.utils.checks import Kept

    t_phase = time.perf_counter()
    text = np.random.default_rng(17).integers(0, 4, SMALL_N, dtype=np.int8)
    fa = os.path.join(tmp, "random.fa")
    fasta.write_fasta(fa, [fasta.FastaRecord("random", text)], width=80)
    text_dev = torch.from_numpy(text).cuda()
    cap = SMALL_N // 2
    os.environ["KISS_TPU_INCORE_CAP"] = str(cap)
    try:
        with Kept(ext, "external_k_ordered_suffix_array") as kept:
            del logs.lines[:]
            kernels.reset_launch_counts()
            rc = cli.main(["suffix_sort", "-k", "256", fa])
            torch.cuda.synchronize()
            routed = kernels.LAUNCHES["radix_sort_words"]
    finally:
        del os.environ["KISS_TPU_INCORE_CAP"]
    routing = logs.value("routing: ")
    check(rc == 0 and routing.startswith(
        f"n = {SMALL_N} exceeds the in-core device budget ({cap} chars x 1 "
        "device(s))"), f"routing line: {routing}")
    check(len(kept.values) == 1 and routed > 0
          and np.array_equal(kept.values[0], k_ordered_suffix_array(
              text_dev, 256, device="cuda")),
          "the routed sort did not run out of core through K1, or its SA "
          "differs from the in-core one")
    del logs.lines[:]
    rc, lms_cli_s = wall_s(lambda: cli.main(
        ["suffix_sort", "-s", "LMS_INDUCED", "-k", "-1", "-t", "8", fa]))
    lms_line = logs.value(f"n = {SMALL_N}, k = -1, suffix sorting elapsed ")
    lms = LmsSorter.get_suffix_array_dna(text, -1, num_threads=8)
    check(rc == 0 and np.array_equal(
        lms, k_ordered_suffix_array(text_dev, -1, device="cuda")),
        "LMS_INDUCED k=-1 SA differs from the in-core SA on the card")
    say(f"CLI routes n={SMALL_N} (random): suffix_sort -k 256 with "
        f"KISS_TPU_INCORE_CAP={cap} logged 'routing: {routing[:60]}...' and "
        f"sorted out of core (K1 launches {routed}), SA equal to the in-core "
        f"one; -s LMS_INDUCED -k -1 -t 8 elapsed {lms_line} (CLI step "
        f"{lms_cli_s:.3f} s), LmsSorter SA bit-identical to the in-core "
        f"k=-1 SA on the card; phase {time.perf_counter() - t_phase:.3f} s")
    return routed


def phase_serve(cli, kernels, logs, fa, batch, tmp, q_pattern, found, occ,
                checksum, archive):
    """7c: serve on ``fa``'s archive (``archive`` names it) with an
    injected stdin. Returns the launches of the run, the counters set to 0
    just before it."""
    import io

    t_phase = time.perf_counter()
    args = cli.build_parser().parse_args(["serve", "-n", "5", fa])
    missing = os.path.join(tmp, "missing.bin")
    requests = f"{q_pattern}\nbatch {batch}\nbatch {missing}\nquit\n"
    out = io.StringIO()
    del logs.lines[:]
    kernels.reset_launch_counts()
    cli.serve_main(args, io.StringIO(requests), out)
    launches = dict(kernels.LAUNCHES)
    lines = out.getvalue().splitlines()
    check(len(lines) == 4 and lines[0] == "ready"
          and lines[1].startswith("ok ") and lines[2].startswith("ok ")
          and lines[3].startswith("err FileNotFoundError"),
          f"serve answered {lines}")
    got = (int(logs.value("number of matched locations: ")),
           int(logs.value("location checksum: ")))
    check(got == (occ, checksum),
          f"serve batch {got} != the oracle's {(occ, checksum)}")
    check(int(logs.value(f"query = {q_pattern} found ").split()[0]) == found,
          "serve -q found count differs from fmindex_query's")
    say(f"serve on the {archive}: {lines[0]}; {lines[1]} (-q, found "
        f"{found}); {lines[2]} (batch of {N_QUERIES}, occ {got[0]} checksum "
        f"{got[1]}, the oracle's); {lines[3][:60]}...; stopped at quit; "
        f"launches {launches}; phase {time.perf_counter() - t_phase:.3f} s")
    return launches


def phase_general(torch, np, kernels, err, shapes):
    """7d: the general alphabet on the card. Returns the K1 launches of the
    general sort of DNA text at k = 256; its seed's keys go to
    ``shapes``."""
    from kiss_tpu_torch.ops import pack
    from kiss_tpu_torch.ops.suffix_sort import (
        Kiss1Sorter,
        _make_plan,
        _normalize_k,
        _run_plan,
    )
    from kiss_tpu_torch.utils.synth import synth_genome

    t_phase = time.perf_counter()
    dna = synth_genome(SMALL_N, seed=3)
    kernels.reset_launch_counts()
    general = Kiss1Sorter.get_suffix_array(dna, 256, device="cuda")
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["radix_sort_words"]
    check(launches > 0 and np.array_equal(
        general, Kiss1Sorter.get_suffix_array_dna(dna, 256, device="cuda")),
        "general-alphabet SA of DNA text differs from the DNA one")
    n20 = (1 << 20) + 6
    t20 = np.random.default_rng(20).integers(0, 20, n20, dtype=np.int8)
    for k in (256, -1):
        check(np.array_equal(
            Kiss1Sorter.get_suffix_array(t20, k, device="cuda"),
            Kiss1Sorter.get_suffix_array(t20, k, device="cpu")),
            f"20-symbol k={k} SA on the card differs from the CPU's")
    t20_dev = torch.from_numpy(t20).cuda()
    for k in (256, -1):
        plan = _make_plan(n20, _normalize_k(k), pack.GENERAL)
        _run_plan(t20_dev, plan, pack.GENERAL, sort_impl=compared_k1(err))
    plan = _make_plan(SMALL_N, 256, pack.GENERAL)
    _run_plan(torch.from_numpy(dna).cuda(), plan, pack.GENERAL,
              sort_impl=recorded_k1(shapes, "get_suffix_array k=256"))
    say(f"general alphabet: get_suffix_array of the {SMALL_N}-char DNA text "
        f"at k=256 equals get_suffix_array_dna's SA (K1 launches {launches}); "
        f"a 20-symbol text of {n20} chars at k=256 and -1 equals the CPU's "
        "(plain versions); every K1 launch of those general sorts vs plain "
        f"exact; phase {time.perf_counter() - t_phase:.3f} s")
    return launches


def phase_bfs_edge(torch, np, cli, kernels, logs, tmp):
    """7e: the range BFS at N % 64 == 0 on the card, through K4. Returns
    the launches of its ``-b`` and ``-q`` runs, the counters set to 0 just
    before them."""
    from kiss_tpu_torch.models import fm_index as fm
    from kiss_tpu_torch.utils import codec, fasta
    from kiss_tpu_torch.utils.synth import sample_patterns, synth_genome

    t_phase = time.perf_counter()
    n = (1 << 22) - 1
    text = synth_genome(n, seed=4)
    fa = os.path.join(tmp, "edge.fa")
    fasta.write_fasta(fa, [fasta.FastaRecord("edge", text)], width=80)
    nq = 100_000
    pats = sample_patterns(text, nq, QLEN, seed=5)
    batch = os.path.join(tmp, "edge.bin")
    with open(batch, "wb") as f:
        f.write(struct.pack("<II", QLEN, nq))
        f.write(codec.to_string(pats.reshape(-1)).encode())
    del logs.lines[:]
    check(cli.main(["fmindex_build", "-k", "32", fa]) == 0, "edge build")
    meta = fm.read_meta(fa + ".fmi")
    check(meta is not None and meta.get("full_sa") is False, "edge .meta")
    kernels.reset_launch_counts()
    check(cli.main(["fmindex_query", "-b", batch, fa]) == 0, "edge -b")
    got = (int(logs.value("number of matched locations: ")),
           int(logs.value("location checksum: ")))
    text_dev = torch.from_numpy(text).cuda()
    want = oracle_stats(torch, text_dev, torch.from_numpy(pats).cuda())
    check(got == want, f"BFS -b at N % 64 == 0: {got} != oracle {want}")
    check(cli.main(["fmindex_query", "-q", "T", "-n", "0", fa]) == 0,
          "edge -q T")
    t_found = int(logs.value("query = T found ").split()[0])
    launches = dict(kernels.LAUNCHES)
    t_count = int((text_dev == 3).sum())
    check(t_found == t_count, f"-q T found {t_found} != {t_count}")
    check(launches["fm_bfs_stats"] > 0 and launches["fm_bfs_locate"] > 0
          and launches["fm_locate_stats"] == 0
          and launches["fm_locate_rows"] == 0,
          f"the BFS at N % 64 == 0 did not go through K4: {launches}")
    say(f"range BFS at n={n} (N % 64 == 0), fmindex_build -k 32: -b of {nq} "
        f"x {QLEN} gives occ {got[0]} checksum {got[1]} (the oracle's); -q T "
        f"(its range ends at row N) found {t_found}, the count of T; "
        f"launches {launches}; phase {time.perf_counter() - t_phase:.3f} s")
    return launches


def phase_mesh(torch, np, kernels, fa, text, text_dev, pats, qw, single, occ,
               checksum, err, smi):
    """7f: the mesh of kiss_tpu_torch.parallel with its shards on one card
    (``make_mesh(devices=[cuda:0] * D)``), at full width, each step held
    against the single-device run of this process. The suffix sort and
    the build run in per-shard blocks (``sharded_sa_blocks``,
    ``build_index_blocks`` + ``tables_to_host``) from the host text, each
    SA block held against its slice of the single-device SA. Each sort
    and build step then runs once more, untimed, with every local sort
    held against K1's plain version; the first block of each (step, W, N)
    of the k = 256 sorts and of the build is timed there. Columnsort and
    bitonic also run at k = -1 on 2, 4 and 8 shards, whose peaks above
    the step's start give the per-card cost (below); the columnsort D = 4,
    k = 256 SA and its build run once more under ``LongestTensor``, which
    must see no tensor longer than two blocks and the seed's halo. Returns
    ({step: (seconds, K1 launches, K2 launches, peak bytes, peak bytes
    above the step's start)}, the K1 rows and the K2 rows: {shape: (ms,
    plain ms, bound ms, bound by)})."""
    import io

    from kiss_tpu_torch.experiments import fm_query_time
    from kiss_tpu_torch.models import fm_index as fm
    from kiss_tpu_torch.ops.radix_sort import (
        radix_sort_wide,
        radix_sort_words_plain,
    )
    from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
    from kiss_tpu_torch.parallel import (
        dsort,
        fm_build,
        fm_sharded,
        make_mesh,
        sharded_batch_query,
        ssort,
    )
    from kiss_tpu_torch.parallel.mesh import block_rows
    from kiss_tpu_torch.parallel.sharded_plan import sharded_sa_blocks
    from kiss_tpu_torch.utils.checks import LongestTensor
    from kiss_tpu_torch.utils.roofline import k1_bound

    t_phase = time.perf_counter()
    dev = text_dev.device
    n = text.shape[0]
    N = n + 1
    want_sa = {k: k_ordered_suffix_array(text_dev, k, as_numpy=False,
                                         device=dev) for k in (256, -1)}
    steps = {}

    def step(name, fn):
        """Run ``fn`` with the launch counters set to 0 just before and
        read just after, and the peak bytes reset; the bytes allocated at
        the start are read too."""
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, seconds = wall_s(fn)
        peak = torch.cuda.max_memory_allocated()
        steps[name] = (seconds, kernels.LAUNCHES["radix_sort_words"],
                       kernels.LAUNCHES["fm_backward_search"], peak,
                       peak - start)
        return out

    def same_sa(blocks, want, D):
        """Each SA block equal to its slice of the single-device SA, its
        pad rows holding their row ids."""
        B = block_rows(N, D)
        for s, b in enumerate(blocks):
            w = want[s * B : (s + 1) * B]
            m = w.shape[0]
            if not (torch.equal(b[:m], w) and torch.equal(b[m:], torch.arange(
                    s * B + m, (s + 1) * B, device=b.device))):
                return False
        return len(blocks) == D

    def fmi_bytes(arrays):
        built = fm.FMIndex(sa_intv=4, lookup_len=0, arrays=arrays, n_rows=N,
                           device=dev)
        buf = io.BytesIO()
        built.save(buf)
        return buf.getvalue()

    lsort = dsort._lsort
    k1_rows, compared = {}, [0]

    def compared_lsort(label, timed):
        """The mesh modules' local sort as K1 held against its plain
        version, exact; with ``timed`` each new (W, N) is timed too."""
        def sort(block):
            block = block.contiguous()
            got = radix_sort_wide(block)
            want = radix_sort_words_plain(block)
            err["radix_sort_words"] = max(
                err["radix_sort_words"], exact(got[1], want[1]),
                exact(got[0], want[0]),
            )
            compared[0] += 1
            W, n_keys = block.shape
            name = f"{label} W={W} N={n_keys}"
            if timed and name not in k1_rows:
                k1_rows[name] = (
                    cuda_ms(lambda: radix_sort_wide(block), 5),
                    cuda_ms(lambda: radix_sort_words_plain(block), 3),
                    *k1_bound(block),
                )
            return got[0]
        return sort

    def run_compared(label, timed, fn):
        """``fn()`` again, untimed, every local sort of dsort and ssort
        through :func:`compared_lsort`"""
        dsort._lsort = ssort._lsort = compared_lsort(label, timed)
        try:
            return fn()
        finally:
            dsort._lsort = ssort._lsort = lsort

    def run_sort(algo, D, k):
        mesh = make_mesh(devices=[dev] * D)
        name = f"sharded_sa_blocks {algo} D={D} k={k}"

        def sort():
            return sharded_sa_blocks(mesh, text, k, algo)

        blocks = step(name, sort)
        check(same_sa(blocks, want_sa[k], D),
              f"{name}: SA differs from the single-device SA")
        check(steps[name][1] > 0, f"{name}: K1 never launched")
        return name, sort

    mesh_sorts = []
    for algo, D in (("columnsort", 4), ("bitonic", 2), ("sample", 4)):
        for k in (256, -1):
            _, sort = run_sort(algo, D, k)
            mesh_sorts.append((f"mesh {algo} D={D} k={k}", k == 256, k, D,
                               sort))
    # the per-card cost: on one card, D shards of B = N / D rows peak at
    # about N (r + t / D) above the start -- every shard's blocks (r a row)
    # and one shard's transient (t a row) --, where each card of a D-card
    # mesh would hold B (r + t); r and t by least squares over D = 2, 4, 8
    per_card = {}
    for algo in ("columnsort", "bitonic"):
        own = []
        for D in (2, 4, 8):
            name = f"sharded_sa_blocks {algo} D={D} k=-1"
            if name not in steps:
                run_sort(algo, D, -1)
            own.append((1 / D, steps[name][4] / n))
        t, r = np.polyfit([x for x, _ in own], [y for _, y in own], 1)
        per_card[algo] = (r, t, r + t)

    mesh = make_mesh(devices=[dev] * 4)
    B4 = block_rows(N, 4)
    sa_blocks = mesh.scatter_host(want_sa[-1], B4)

    def build():
        tables = fm_build.build_index_blocks(mesh, text, sa_blocks, 4)
        return fm_build.tables_to_host(
            mesh, tables, fm_build.sharded_lookup(mesh, tables, 0), 4)

    name = "build_index_blocks + tables_to_host D=4"
    arrays = step(name, build)
    check(steps[name][1] > 0, "the sharded build never launched K1")
    with open(fa + ".fmi", "rb") as f:
        want_fmi = f.read()
    check(fmi_bytes(arrays) == want_fmi, "the sharded build's .fmi bytes "
          "differ from the single-device build's")
    del arrays

    # no op of the blocked sort and build makes a tensor longer than two
    # blocks and the seed's 63-character halo (the widest legitimate one:
    # a merge of two blocks), let alone one as long as the text
    with LongestTensor() as rec:
        blocks = sharded_sa_blocks(mesh, text, 256, "columnsort")
        tables = fm_build.build_index_blocks(mesh, text, sa_blocks, 4)
    longest = rec.longest
    check(longest <= 2 * B4 + 63 < N, f"the blocked pipeline made a tensor "
          f"of {longest} rows (B = {B4}, N = {N})")
    check(same_sa(blocks, want_sa[256], 4), "the recorded run's SA differs")
    del blocks, tables

    # every local sort of the sort and build steps against K1's plain
    # version, in runs of their own, so that the timed steps above carry
    # neither the plain sorts nor the timing of new shapes
    for label, timed, k, D, sort in mesh_sorts:
        check(same_sa(run_compared(label, timed, sort), want_sa[k], D),
              f"{label}: SA differs in the compared run")
    check(fmi_bytes(run_compared("mesh build D=4", True, build)) == want_fmi,
          "the sharded build's .fmi bytes differ in the compared run")
    del want_sa, want_fmi, mesh_sorts, sa_blocks

    query = fm_sharded.ShardedFMQuery(mesh, single)
    stats = step("ShardedFMQuery.batch_query_stats D=4 (1M x 25)",
                 lambda: query.batch_query_stats(pats))
    check(stats == (occ, checksum), f"row-sharded stats {stats} != the "
          f"oracle's {(occ, checksum)}")
    del query
    name = "sharded_batch_query D=4 (1M x 25, K2 a shard)"
    got = step(name, lambda: sharded_batch_query(mesh, single.arrays, pats, 0,
                                                 blocks=single.blocks))
    want = fm.get_range_packed_device(single.arrays, qw, QLEN, 0,
                                      blocks=single.blocks)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "sharded_batch_query ranges differ from single-device K2's")
    check(steps[name][2] == 4, f"{name}: K2 launches {steps[name][2]} != 4")
    del got, want

    # K2 at the shard's launch shape, against its plain version
    chunk = qw[: -(-qw.shape[0] // 4)]
    got = fm.get_range_packed_device(single.arrays, chunk, QLEN, 0,
                                     blocks=single.blocks)
    plain = fm.get_range_packed_device_plain(single.arrays, chunk, QLEN, 0)
    for g, w in zip(got, plain):
        err["fm_backward_search"] = max(err["fm_backward_search"],
                                        exact(g, w))
    lf_steps = int((QLEN - plain[2]).sum())
    k2_rows = {f"shard chunk {chunk.shape[0]} x {QLEN}": (
        cuda_ms(lambda: fm.get_range_packed_device(
            single.arrays, chunk, QLEN, 0, blocks=single.blocks), 20),
        cuda_ms(lambda: fm.get_range_packed_device_plain(
            single.arrays, chunk, QLEN, 0), 3),
        *fm_query_time.k2_bound(single, chunk.shape[0], chunk.numel(),
                                lf_steps),
    )}
    say(f"mesh on one card ({smi}), D shards on cuda:0, n={N - 1}, each "
        "SA and table in per-shard blocks from the host text: every SA "
        "bit-identical to the single-device SA, the sharded build's .fmi "
        f"byte-identical, every one of their {compared[0]} local sorts equal "
        "to K1's plain version (a second, untimed run); the longest tensor "
        f"of the columnsort D=4 k=256 SA and build {longest} rows (B {B4}, "
        f"2B + 63 {2 * B4 + 63}, N {N}); row-sharded stats occ "
        f"{occ} checksum {checksum} (the oracle's), sharded_batch_query "
        "ranges equal single-device K2's. Steps (seconds, K1 launches, K2 "
        "launches, peak CUDA bytes and per char, peak above the step's "
        "start and per char): " + "; ".join(
            f"{name} {s:.3f} s, {k1}, {k2}, {peak} ({peak / n:.1f}), {own} "
            f"({own / n:.1f})"
            for name, (s, k1, k2, peak, own) in steps.items())
        + "; per-card cost of a D-card mesh from the k=-1 peaks above the "
        "start, N (r + t / D) fitted over D = 2, 4, 8, B/char of a "
        "shard's block (r, t, r + t): " + "; ".join(
            f"{algo} {r:.1f}, {t:.1f}, {c:.1f}"
            for algo, (r, t, c) in per_card.items())
        + "; K1 at the mesh's local-sort shapes, ms, plain ms, bound ms: "
        + "; ".join(f"{name} {t:.4f}, {p:.4f}, {b:.5f} ({by})"
                    for name, (t, p, b, by) in k1_rows.items())
        + "; K2 at the shard's shape, ms, plain ms, bound ms: " + "; ".join(
            f"{name} {t:.4f}, {p:.4f}, {b:.4f} ({by})"
            for name, (t, p, b, by) in k2_rows.items())
        + f"; phase {time.perf_counter() - t_phase:.3f} s")
    return steps, k1_rows, k2_rows


def phase_k1_shapes(torch, smi, err, shapes):
    """K1 at each new launch shape held against its plain version, exact,
    and timed beside it and its bound. Returns {shape: (ms, plain ms, bound
    ms, bound by)}."""
    from kiss_tpu_torch.ops.radix_sort import (
        radix_sort_words,
        radix_sort_words_plain,
    )
    from kiss_tpu_torch.utils.roofline import k1_bound

    rows = {}
    for name, keys in shapes.items():
        got, want = radix_sort_words(keys), radix_sort_words_plain(keys)
        err["radix_sort_words"] = max(
            err["radix_sort_words"], exact(got[1], want[1]),
            exact(got[0], want[0]),
        )
        del got, want
        bound = k1_bound(keys)
        rows[f"{name} N={keys.shape[1]}"] = (
            cuda_ms(lambda: radix_sort_words(keys), 5),
            cuda_ms(lambda: radix_sort_words_plain(keys), 3), *bound,
        )
    say(f"K1 at the new launch shapes on {smi}, each equal to the plain "
        "version (exact), ms, plain ms, bound ms: "
        + "; ".join(f"{name} {t:.4f}, {p:.4f}, {b:.5f} ({by})"
                    for name, (t, p, b, by) in rows.items()))
    return rows


def _packed_words16(torch, text, N: int):
    """int32 [1, N]: position p's 16 characters, 2 bits each, big-endian,
    zero past the text (a uint32 key), made 2**28 positions at a time."""
    from kiss_tpu_torch.ops import pack

    n = text.shape[0]
    keys = torch.empty((1, N), dtype=torch.int32, device=text.device)
    for lo in range(0, N, BIG_CHUNK):
        hi = min(lo + BIG_CHUNK, N)
        win = torch.zeros(hi - lo + 15, dtype=torch.int64, device=text.device)
        m = max(min(n, hi + 15) - lo, 0)
        win[:m] = text[lo : lo + m]
        acc = torch.zeros(hi - lo, dtype=torch.int64, device=text.device)
        for j in range(16):
            acc |= win[j : j + hi - lo] << (2 * (15 - j))
        keys[0, lo:hi] = pack.to_u32_bits(acc)
        del win, acc
    return keys


def _place_short_suffixes(torch, sorted_keys, perm, n: int):
    """The 16-ordered SA (int32 bits [N]) from K1's stable sort of every
    row's zero-padded 16-character word: the 16 rows whose suffix holds
    fewer than 16 characters (positions n - 15 .. n, the sentinel n among
    them) are taken out and put back by the ordering contract. Such a
    suffix p comes after every full row whose word is below its zero-padded
    word w(p) and before the rest (its end sorts below any character); the
    short ones order by w(p), a shorter one first."""
    from kiss_tpu_torch.ops import pack
    from kiss_tpu_torch.ops.suffix_sort import _compact_rows

    N = n + 1
    short_rows = _compact_rows(perm >= n - 15)
    pos = perm[short_rows]
    words = pack.as_u32(sorted_keys[0, short_rows])
    order = sorted(range(16), key=lambda i: (int(words[i]), -int(pos[i])))
    below = torch.zeros(16, dtype=torch.int64, device=perm.device)
    for lo in range(0, N, BIG_CHUNK):  # rows with a word below each w(p)
        chunk = pack.as_u32(sorted_keys[0, lo : lo + BIG_CHUNK])
        below += torch.searchsorted(chunk, words)
        del chunk
    # the full rows below w(p): all rows below it, less the short ones
    full_below = below - (words[None, :] < words[:, None]).sum(dim=1)
    # each short suffix's row, and its position as uint32 bits in int32
    targets = {}
    for rank, i in enumerate(order):
        p = int(pos[i])
        targets[int(full_below[i]) + rank] = p - (1 << 32) if p >= 2**31 else p
    # the full rows in K1's order, the short ones taken out, as uint32 bits
    full = torch.empty(N - 16, dtype=torch.int32, device=perm.device)
    prev = out = 0
    for r in sorted(short_rows.tolist()) + [N]:
        for lo in range(prev, r, BIG_CHUNK):
            hi = min(lo + BIG_CHUNK, r)
            full[out : out + hi - lo] = pack.to_u32_bits(perm[lo:hi])
            out += hi - lo
        prev = r + 1
    sa = torch.empty(N, dtype=torch.int32, device=perm.device)
    src = dst = 0
    for row in sorted(targets):
        sa[dst:row] = full[src : src + row - dst]
        src += row - dst
        sa[row] = targets[row]
        dst = row + 1
    sa[dst:] = full[src:]
    return sa


def phase_big_n(torch, np, kernels, err, smi):
    """7g: N = 2**31 + 4096 rows on the card. A random text from a seed;
    K1 sorts every position's 16-character word (W = 1) and is held to the
    whole stable-sort contract; the 16-ordered SA, its short suffixes put
    back by the contract, goes through the row-blocked build; 65,536
    random 13-mers (inside the BFS contract: 13 + 4 - 1 <= 16) through K2
    and K4, equal to an oracle on the card that never reads the index (the
    text's 13-mer codes counted and their positions summed) and, on a
    sample, to the plain versions. Returns ({kernel: launches}, K1's
    (ms, plain ms, bound ms, bound by) at this shape)."""
    import gc

    from kiss_tpu_torch.models import fm_index as fm
    from kiss_tpu_torch.ops import pack
    from kiss_tpu_torch.ops.radix_sort import radix_sort_words
    from kiss_tpu_torch.utils.checks import (
        check_k_sorted_sample,
        check_stable_sort,
    )
    from kiss_tpu_torch.utils.roofline import k1_bound

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    n, N = BIG_N, BIG_N + 1
    g = torch.Generator(device=dev).manual_seed(31)
    text = torch.empty(n, dtype=torch.int8, device=dev)
    for lo in range(0, n, BIG_CHUNK):
        hi = min(lo + BIG_CHUNK, n)
        text[lo:hi] = torch.randint(0, 4, (hi - lo,), dtype=torch.int8,
                                    device=dev, generator=g)
    keys = _packed_words16(torch, text, N)

    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sorted_keys, perm = radix_sort_words(keys)
    stop.record()
    torch.cuda.synchronize()
    k1_ms = start.elapsed_time(stop)
    k1_launches = kernels.LAUNCHES["radix_sort_words"]
    check(k1_launches == 1, f"7g: K1 launched {k1_launches} times")
    check_stable_sort(keys, sorted_keys, perm)
    bound = k1_bound(keys)
    # the plain version: a stable torch.sort of int64 values with int64
    # indices and their gathers, about 64 bytes a key besides the keys
    plain_need = 64 * N
    plain_free = torch.cuda.mem_get_info()[0]
    plain = (f"K1's plain version needs about {plain_need / 1e9:.0f} GB "
             f"here, the card has {plain_free / 1e9:.0f} GB free: held by the "
             f"stable-sort contract alone")
    if plain_need < 0.9 * plain_free:
        from kiss_tpu_torch.ops.radix_sort import radix_sort_words_plain

        want = radix_sort_words_plain(keys)
        err["radix_sort_words"] = max(err["radix_sort_words"],
                                      exact(perm, want[1]),
                                      exact(sorted_keys, want[0]))
        plain = "equal to K1's plain version"
        del want
    del keys
    sa = _place_short_suffixes(torch, sorted_keys, perm, n)
    del sorted_keys, perm
    check_k_sorted_sample(text, pack.as_u32(sa), 16, 1_000_000)

    fmi = fm.FMIndex(sa_intv=4, lookup_len=0, device=dev)
    _, build_s = wall_s(lambda: fmi.build_rows(text, sa, full_sa=False))
    del sa
    gc.collect()
    arrays, blocks = fmi.arrays, fmi.blocks

    # the oracle: every 13-mer of the text as a 26-bit code, counted, and
    # its positions summed
    rng = np.random.default_rng(13)
    qcodes_np = rng.integers(0, 4**BIG_QLEN, BIG_QUERIES)
    counts = torch.zeros(4**BIG_QLEN, dtype=torch.int64, device=dev)
    sums = torch.zeros_like(counts)
    m = n - BIG_QLEN + 1
    located = BIG_LOCATED
    pick = torch.from_numpy(qcodes_np[:located]).to(dev)
    where = [[] for _ in range(located)]
    for lo in range(0, m, BIG_CHUNK):
        hi = min(lo + BIG_CHUNK, m)
        code = torch.zeros(hi - lo, dtype=torch.int64, device=dev)
        for j in range(BIG_QLEN):
            code = (code << 2) | text[lo + j : hi + j].to(torch.int64)
        counts += torch.bincount(code, minlength=4**BIG_QLEN)
        sums.index_add_(0, code, torch.arange(lo, hi, device=dev))
        for i in range(located):
            where[i].append((code == pick[i]).nonzero().flatten() + lo)
        del code
    qc = torch.from_numpy(qcodes_np).to(dev)
    want_counts, want_sums = counts[qc], sums[qc]
    pats = np.stack([(qcodes_np >> (2 * (BIG_QLEN - 1 - j))) & 3
                     for j in range(BIG_QLEN)], axis=1).astype(np.int8)
    qw = fm._packed_queries(pats, dev)

    kernels.reset_launch_counts()
    beg, end, _ = fm.get_range_packed_device(arrays, qw, BIG_QLEN, 0,
                                             blocks=blocks)
    check(torch.equal(end - beg, want_counts),
          "7g: K2's counts differ from the 13-mer oracle's")
    stats = fm.batch_bfs_stats_device(arrays, beg, end, 4, blocks=blocks)
    want = (int(want_counts.sum()), int(want_sums.sum()))
    check(stats == want, f"7g: K4 stats {stats} != the oracle's {want}")
    check(fm.bfs_query_stats(arrays, beg, end, 4, blocks=blocks) == want,
          "7g: the BFS route's stats differ from the oracle's")
    got = fm.bfs_locate_device(arrays, beg[:located], end[:located], 4,
                               blocks=blocks)
    lens = (end[:located] - beg[:located]).tolist()
    for i, part in enumerate(torch.split(got, lens)):
        check(torch.equal(part.sort().values, torch.cat(where[i])),
              f"7g: K4 locate of pattern {i} differs from the oracle's")
    launches = {name: kernels.LAUNCHES[name] for name in
                ("fm_backward_search", "fm_bfs_stats", "fm_bfs_locate")}
    check(all(launches.values()), f"7g: a kernel was not launched: "
          f"{launches}")
    # the plain versions on a sample
    qs = qw[:BIG_PLAIN_SAMPLE]
    sb, se = beg[:BIG_PLAIN_SAMPLE], end[:BIG_PLAIN_SAMPLE]
    plain_ranges = fm.get_range_packed_device_plain(arrays, qs, BIG_QLEN, 0)
    for name, a, b in (("beg", sb, plain_ranges[0]),
                       ("end", se, plain_ranges[1])):
        err["fm_backward_search"] = max(err["fm_backward_search"],
                                        exact(a, b))
    err["fm_bfs_stats"] = max(err["fm_bfs_stats"], exact(
        fm.batch_bfs_stats_device(arrays, sb, se, 4, blocks=blocks),
        fm.batch_bfs_stats_device_plain(arrays, sb, se, 4)))
    err["fm_bfs_locate"] = max(err["fm_bfs_locate"], exact(
        got, fm.bfs_locate_device_plain(arrays, beg[:located],
                                        end[:located], 4)))
    peak = torch.cuda.max_memory_allocated()
    del fmi, arrays, blocks, text, counts, sums, where, got
    gc.collect()
    torch.cuda.empty_cache()
    free_after = torch.cuda.mem_get_info()[0]
    check(free_after >= free_before - (1 << 28),
          f"7g: card memory not given back ({free_before} free before, "
          f"{free_after} after)")
    say(f"N >= 2**31 on {smi}: N = {N} rows of a random text; K1 (W=1) "
        f"{k1_ms:.3f} ms, bound {bound[0]:.3f} ({bound[1]}), the whole "
        f"stable-sort contract exact, {plain}; the 16-ordered SA (its 16 "
        f"short suffixes put back by the contract) a permutation with "
        f"1000000 rows in order; build_rows {build_s:.3f} s; "
        f"{BIG_QUERIES} random {BIG_QLEN}-mers: K2 counts and K4 stats "
        f"{want} equal the on-card 13-mer oracle, K4 locate of {located} "
        f"patterns its positions, K2 and K4 equal their plain versions on "
        f"{BIG_PLAIN_SAMPLE} queries; launches {launches}; peak CUDA bytes "
        f"{peak}; card free {free_before} bytes before, {free_after} after; "
        f"phase {time.perf_counter() - t_phase:.3f} s")
    launches["radix_sort_words"] = k1_launches
    return launches, (k1_ms, None, *bound)


def phase_sweep(torch, np, cli, kernels, fa, text, text_dev, err, smi,
                default_s):
    """7h: the reference's experiment protocol at full width
    (``experiments.run_experiments``): both strategies at the nine ks, one
    timed call each after a warm one, every wide SA in k-order and every
    doubling SA bit-identical to the wide one, each call's peak bytes a
    character within ``cli.IN_CORE_BYTES_PER_CHAR``; K1 at each new (W, N)
    of the doubling rounds held against its plain version and timed; K1
    against the operand count with ``torch.sort`` of the packed words at W
    = 1, 2 (``experiments.micro_roofline``); ``suffix_sort -s
    PREFIX_DOUBLING -k 256`` and ``-k -1`` through the CLI in turns with the
    default strategy at each k, K1 launched, every SA the sweep's; the mesh
    sweep at D = 2. Returns ({path: K1 launches}, K1 rows {shape: (ms,
    plain ms, bound ms, bound by)}, the roofline's K1 rows {shape: {ms,
    plain_ms, bound_ms, bound_by, library_ms}})."""
    from kiss_tpu_torch.experiments import micro_roofline as mr
    from kiss_tpu_torch.experiments import run_experiments as rx
    from kiss_tpu_torch.ops import pack
    from kiss_tpu_torch.ops import suffix_sort as ss
    from kiss_tpu_torch.ops.radix_sort import radix_sort_wide
    from kiss_tpu_torch.utils.checks import Kept

    t_phase = time.perf_counter()
    dev = text_dev.device
    ks = [int(k) for k in rx.KS.split(",")]
    runs = {}
    for strategy in ("wide", "doubling"):
        reference = None
        if strategy == "doubling":
            reference = {k: r.sa for k, r in runs["wide"].items()}
        _, runs[strategy] = rx.sweep(text_dev, ks, strategy, 1, dev,
                                     reference=reference, say=say)
    # each call's peak above what the card held before it, plus its text
    per_char = {(strategy, k): (max(r.above) + N_TEXT) / N_TEXT
                for strategy, by_k in runs.items() for k, r in by_k.items()}
    worst = max(per_char, key=per_char.get)
    check(per_char[worst] <= cli.IN_CORE_BYTES_PER_CHAR,
          f"{worst} peaks at {per_char[worst]:.2f} bytes a character, over "
          f"cli.IN_CORE_BYTES_PER_CHAR = {cli.IN_CORE_BYTES_PER_CHAR}")
    launches = {f"7h: k sweep, {strategy} (one timed call a k)": sum(
        r.launches for r in by_k.values()) for strategy, by_k in runs.items()}
    say(f"k sweep n={N_TEXT} on {smi}: seconds, K1 launches, peak bytes a "
        "char (the call's peak above the card's holdings, plus the text): "
        + "; ".join(f"{strategy} k={k} {r.seconds[0]:.4f} s, "
                    f"{r.launches}, {per_char[(strategy, k)]:.2f}"
                    for strategy, by_k in runs.items()
                    for k, r in by_k.items())
        + f"; the largest {per_char[worst]:.2f} ({worst}), within "
        f"cli.IN_CORE_BYTES_PER_CHAR = {cli.IN_CORE_BYTES_PER_CHAR}")

    # K1 at the first launch of each (W, N) of the doubling rounds, untimed
    # here: phase_k1_shapes holds each to the plain version and times it
    shapes, seen = {}, set()

    def first_of_shape(label):
        calls = []

        def sort(keys):
            calls.append(keys.shape)
            if tuple(keys.shape) not in seen:
                seen.add(tuple(keys.shape))
                shapes[f"7h doubling {label} launch {len(calls)} "
                       f"W={keys.shape[0]}"] = keys
            return radix_sort_wide(keys)

        return sort

    shape = ss._plan_shape("doubling", pack.DNA)
    for k in ks:
        plan = ss._make_plan(N_TEXT, ss._normalize_k(k), pack.DNA, *shape)
        ss._run_plan(text_dev, plan, pack.DNA,
                     sort_impl=first_of_shape(f"k={k}"))
    k1_rows = phase_k1_shapes(torch, smi, err, shapes)
    del shapes

    # K1 against the operand count, torch.sort of the packed words at W <= 2
    floor = mr.dispatch_floor(dev)
    sums = mr.stream(dev, mr.STREAM_BYTES, 0)
    roof = mr.k1_rows(mr.N_SORT, mr.WIDTHS, dev, sums[1] / sums[0])
    say(f"K1 roofline on {smi} (experiments.micro_roofline; each output "
        "equal to the plain version's, at W <= 2 to torch.sort's):\n"
        + "\n".join(mr.table(mr.N_SORT, floor, sums, roof)))
    roofline = {
        f"roofline W={w} N={mr.N_SORT} (random words)": {
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms")}
        for w, r in roof.items()}

    # the CLI: PREFIX_DOUBLING at k = 256 and -1 beside the default
    cli_s = {}
    for name, argv, k in (
        ("suffix_sort -k 256", ["suffix_sort", "-k", "256", fa], 256),
        ("suffix_sort -s PREFIX_DOUBLING -k 256",
         ["suffix_sort", "-s", "PREFIX_DOUBLING", "-k", "256", fa], 256),
        ("suffix_sort -k -1", ["suffix_sort", "-k", "-1", fa], -1),
        ("suffix_sort -s PREFIX_DOUBLING -k -1",
         ["suffix_sort", "-s", "PREFIX_DOUBLING", "-k", "-1", fa], -1),
    ):
        with Kept(ss, "k_ordered_suffix_array") as kept:
            kernels.reset_launch_counts()
            rc, cli_s[name] = wall_s(lambda argv=argv: cli.main(argv))
            launches[f"7h: {name}"] = kernels.LAUNCHES["radix_sort_words"]
        check(rc == 0 and launches[f"7h: {name}"] > 0,
              f"{name}: rc {rc}, K1 launches {launches[f'7h: {name}']}")
        check(len(kept.values) == 1
              and np.array_equal(kept.values[0], runs["wide"][k].sa),
              f"{name}: its SA is not the sweep's wide SA")
    del kept

    _, mesh = rx.mesh_sweep(text, [2], 1, dev, runs["wide"][256].sa, say=say)
    launches["7h: mesh sweep D=2, k=256 (shards on one card)"] = (
        mesh[2].launches)
    del runs
    say(f"CLI on {smi}, n={N_TEXT}: " + ", ".join(
        f"{name} {t:.3f} s (K1 {launches[f'7h: {name}']})"
        for name, t in cli_s.items())
        + " (in turns; phase 5's suffix_sort -k 256, the process's first CLI "
        f"call, {default_s:.3f} s); each SA the sweep's; mesh D=2 k=256 "
        f"{mesh[2].seconds[0]:.4f} s, its SA the single-card one; phase "
        f"{time.perf_counter() - t_phase:.3f} s")
    return launches, k1_rows, roofline


def phase_bench(torch, kernels, fmi, qw, lens, occ, checksum, err, smi):
    """7i: the port's benchmark (``kiss_tpu_torch.bench.main``, what
    ``python -m kiss_tpu_torch.bench`` runs) at full width, the launch
    counters reset just before and read just after: its JSON line printed
    (never as the last line), its 14 metrics there, the occurrences and
    checksum that every route gave it (it raises where two differ) the
    phase 5 oracle's, K1, K2, K3 stats and K4 stats launched. Then K2 at the
    benchmark's two lookup-12 shapes over the CLI's index ``fmi``: the
    4**12-seed table build (early stop off; the whole table held) and the
    1M x 25 batch seeded from that table (beg, end, offs; its counts
    ``lens``, the unseeded ones), each against the plain version, exact,
    and timed. Returns ({kernel: launches}, K2 rows {shape: (ms, plain ms,
    bound ms, bound by)})."""
    import contextlib
    import io

    from kiss_tpu_torch import bench
    from kiss_tpu_torch.experiments.fm_query_time import k2_bound
    from kiss_tpu_torch.models import fm_index as fm

    t_phase = time.perf_counter()
    out = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = bench.main([])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    bench_s = time.perf_counter() - t_phase
    lines = out.getvalue().splitlines()
    check(rc == 0 and len(lines) == 1,
          f"the bench returned {rc} and printed {len(lines)} lines")
    say(lines[0])
    line = json.loads(lines[0])
    metrics = {e["metric"]: e for e in line["extra_metrics"]}
    check(len(metrics) == 13 and line["device"] == smi
          and line["metric"] == "suffix_sort_throughput_drosophila_k256",
          f"the bench's line lacks a metric or the card: {sorted(metrics)}, "
          f"{line['device']!r}")
    counts = metrics["fmindex_query_1M_len25_counts_per_s"]
    check((counts["occ"], counts["checksum"]) == (occ, checksum),
          f"the bench's occ/checksum {(counts['occ'], counts['checksum'])} "
          f"!= the oracle's {(occ, checksum)}")
    on_path = ("radix_sort_words", "fm_backward_search", "fm_locate_stats",
               "fm_bfs_stats")
    check(all(launches[name] > 0 for name in on_path),
          f"a kernel of the bench's path was never launched: {launches}")

    dev, L = qw.device, bench.LLEN
    arrays, blocks = fmi.arrays, fmi.blocks
    seeds = fm.lookup_seed_words(L, dev)
    rows = {}

    def table_build():
        return fm.get_range_packed_device(arrays, seeds, L, 0,
                                          early_stop=False, blocks=blocks)

    def table_plain():
        return fm.get_range_packed_device_plain(arrays, seeds, L, 0,
                                                early_stop=False)

    got = table_build()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want = table_plain()
    plain_peak = torch.cuda.max_memory_allocated() - held
    for g, w in zip(got, want):
        err["fm_backward_search"] = max(err["fm_backward_search"],
                                        exact(g, w))
    fl = fm.FMIndex(sa_intv=4, lookup_len=L, arrays=arrays,
                    n_rows=fmi.n_rows, device=dev, blocks=blocks)
    fl._build_lookup()
    n_rows = torch.tensor([fmi.n_rows], device=dev)
    exact(fl.arrays.lookup, torch.cat([want[0], n_rows]))
    del got, want
    nseeds = seeds.shape[0]
    rows[f"7i lookup-{L} table build, {nseeds} seeds x {L} (early stop "
         "off)"] = (cuda_ms(table_build, 10), cuda_ms(table_plain, 2),
                    *k2_bound(fmi, nseeds, seeds.numel(), L * nseeds))

    def seeded():
        return fm.get_range_packed_device(fl.arrays, qw, QLEN, L,
                                          blocks=blocks)

    def seeded_plain():
        return fm.get_range_packed_device_plain(fl.arrays, qw, QLEN, L)

    got, want = seeded(), seeded_plain()
    for g, w in zip(got, want):
        err["fm_backward_search"] = max(err["fm_backward_search"],
                                        exact(g, w))
    exact(got[1] - got[0], lens)
    lf_steps = int(((QLEN - L) - got[2]).sum())
    nq = qw.shape[0]
    rows[f"7i batch {nq} x {QLEN} seeded from the lookup-{L} table"] = (
        cuda_ms(seeded, 100), cuda_ms(seeded_plain, 3),
        *k2_bound(fl, nq, qw.numel(), lf_steps, lookup_reads=2 * nq))
    del got, want, fl, seeds
    say(f"bench n={N_TEXT} on {smi} (kiss_tpu_torch.bench.main, its line "
        f"above): {bench_s:.3f} s, occ {occ} and checksum {checksum} (the "
        f"oracle's) on the walk, the BFS, both host-to-host routes and the "
        f"loaded archive, the lookup-{L} counts the lookup-0 counts, the "
        f"device-path SA the library's; launches {launches}. K2 at the "
        f"lookup-{L} shapes (exact against the plain version; the plain "
        f"table build peaks {plain_peak} bytes above the card's holdings; "
        f"{lf_steps} LF steps in the seeded batch), ms, plain ms, bound ms: "
        + "; ".join(f"{name} {t:.4f}, {p:.4f}, {b:.4f} ({by})"
                    for name, (t, p, b, by) in rows.items())
        + f"; phase {time.perf_counter() - t_phase:.3f} s")
    return launches, rows


def phase_probe_path(torch, kernels):
    """The probe entry points as a user runs them, counters reset just
    before and read just after."""
    from kiss_tpu_torch.experiments import micro_copy, micro_kernels

    kernels.reset_launch_counts()
    for mod in (micro_kernels, micro_copy):
        check(mod.main(["--device", "cuda"]) == 0,
              f"{mod.__name__}.main failed")
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in PROBE_NAMES}
    check(all(v > 0 for v in launches.values()),
          f"a probe kernel was never launched by the probe path: {launches}")
    return launches


def phase_probes(torch, smi, err, ms, plain_ms, library_ms, bounds):
    """P1-P7 against their plain versions at the probes' shapes, exact,
    with the kernel's, the plain version's and the PyTorch call's time.
    Returns the bytes a second ``x.clone()`` moved (read + written)."""
    import math
    import statistics

    from kiss_tpu_torch.experiments import micro_copy as mc
    from kiss_tpu_torch.experiments import micro_kernels as mk
    from kiss_tpu_torch.utils.roofline import bound_ms

    dev = torch.device("cuda")
    n, rows = N_PROBE, PROBE_ROWS
    k, v = mk.probe_inputs(n, dev)
    gb = n * 4 / 1e9
    notes = []

    def run(name, kernel_fn, plain_fn, library_fn=None, plain_reps=2):
        """Compare, then time; returns (kernel, plain, library) ms. The
        plain version of a streaming copy is itself one streaming call
        and is timed as the kernel is (``plain_reps=PROBE_REPS``); the
        others take many milliseconds, and 2 runs are enough."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            err[name] = max(err[name], exact(g, w))
        del got, want
        # 50 launches in a row: the host's preparation of the first one
        # (tens of microseconds) is a tenth of a streaming probe's time
        return (cuda_ms(kernel_fn, PROBE_REPS),
                cuda_ms(plain_fn, plain_reps),
                cuda_ms(library_fn, PROBE_REPS) if library_fn else None)

    def keep(name, times, bytes_moved, int_ops):
        ms[name], plain_ms[name], library_ms[name] = times
        bounds[name] = bound_ms(bytes_moved, int_ops)

    def fmt(times):
        return " / ".join("none" if t is None else f"{t:.3f}" for t in times)

    t = run("stream_copy", lambda: mk.stream_copy(k, rows),
            lambda: mk.stream_copy_plain(k, rows), lambda: k + 1,
            plain_reps=PROBE_REPS)
    keep("stream_copy", t, 8 * n, n)
    notes.append(f"stream_copy {fmt(t)} -> {2 * gb / t[0] * 1e3:.0f} GB/s "
                 f"(x + 1: {2 * gb / t[2] * 1e3:.0f} GB/s)")

    for d in (1, 128, 1 << 16):
        t = run("one_stage", lambda: mk.one_stage(k, v, rows, d, d),
                lambda: mk.one_stage_plain(k, v, rows, d, d))
        if d == 128:  # one compare of (key, payload) per element
            keep("one_stage", t, 16 * n, n)
        notes.append(f"one_stage d={d} {fmt(t)} -> "
                     f"{4 * gb / t[0] * 1e3:.0f} GB/s")

    for r in (256, 1024, rows):
        key = mk.sort_key(k, v).reshape(-1, r * mk.LANES)
        t = run("tile_sort", lambda: mk.tile_sort(k, v, r),
                lambda: mk.tile_sort_plain(k, v, r),
                lambda: torch.sort(key, dim=1))
        del key
        lg = math.log2(r * mk.LANES)
        if r == rows:  # n log2(T) compares: the least a comparison sort does
            keep("tile_sort", t, 16 * n, n * lg)
        notes.append(f"tile_sort T={r * mk.LANES // 1024}K {fmt(t)} -> "
                     f"{t[0] / (lg * (lg + 1) / 2):.4f} ms per "
                     "stage-equivalent")

    for entries in (1 << 15, 1 << 16):
        table = k.reshape(-1)[:entries]
        idx = v % entries
        t = run("kernel_gather", lambda: mk.kernel_gather(table, idx, rows),
                lambda: mk.kernel_gather_plain(table, idx, rows),
                lambda: table[idx])
        if entries == 1 << 16:
            keep("kernel_gather", t, 8 * n + 4 * entries, 0)
        notes.append(f"kernel_gather {entries >> 10}K table {fmt(t)} -> "
                     f"{n / t[0] / 1e6:.1f} G elements/s")
        del table, idx

    for r in (128, 512, 8192, 32768):  # the other tile sizes of the sweep
        err["copy_grid"] = max(err["copy_grid"],
                               exact(mc.copy_grid(k, r), k))
    t = run("copy_grid", lambda: mc.copy_grid(k, rows),
            lambda: mc.copy_grid_plain(k, rows), k.clone,
            plain_reps=PROBE_REPS)
    keep("copy_grid", t, 8 * n, 0)
    notes.append(f"copy_grid {fmt(t)} -> {2 * gb / t[0] * 1e3:.0f} GB/s "
                 f"(clone: {2 * gb / t[2] * 1e3:.0f} GB/s)")
    t = run("copy_2d", lambda: mc.copy_2d(k, rows),
            lambda: mc.copy_2d_plain(k, rows), k.clone,
            plain_reps=PROBE_REPS)
    keep("copy_2d", t, 8 * n, 0)
    notes.append(f"copy_2d {fmt(t)} -> {2 * gb / t[0] * 1e3:.0f} GB/s")
    # P6 against the call in turns: two timings a few seconds apart differ
    # by more than the two differ from each other
    turns = [(cuda_ms(lambda: mc.copy_2d(k, rows), PROBE_REPS),
              cuda_ms(k.clone, PROBE_REPS)) for _ in range(7)]
    p6, clone = (statistics.median(x) for x in zip(*turns))
    notes.append(f"copy_2d and x.clone() in turns, {len(turns)} x "
                 f"{PROBE_REPS} launches each: medians {p6:.4f} / "
                 f"{clone:.4f} ms, ratio {p6 / clone:.4f}")
    t = run("run_heavy", lambda: mc.run_heavy(k, rows),
            lambda: mc.run_heavy_plain(k, rows))
    keep("run_heavy", t, 8 * n, 128 * n)
    notes.append(f"run_heavy {fmt(t)} -> {n * 128 / t[0] / 1e9:.2f} Tops/s")
    say(f"probes vs plain on {smi} at N={n}, rows={rows} (exact, tolerance "
        "0; kernel / plain / PyTorch call ms): " + "; ".join(notes))
    return 8 * n / (clone * 1e-3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, ROOT)
    from kiss_tpu_torch import cli, kernels
    from kiss_tpu_torch.experiments import fm_query_time
    from kiss_tpu_torch.experiments import micro_kernels as mk
    from kiss_tpu_torch.experiments import sort_split
    from kiss_tpu_torch.utils.checks import LogLines, check_k_sorted_sample
    from kiss_tpu_torch.utils.roofline import (
        bound_ms, k1_bound, k5_bound, k6_bound,
    )
    from kiss_tpu_torch.models import fm_index as fm
    from kiss_tpu_torch.ops import pack
    from kiss_tpu_torch.ops.radix_sort import (
        radix_sort_words,
        radix_sort_words_plain,
    )
    from kiss_tpu_torch.ops.suffix_sort import (
        _make_plan,
        _normalize_k,
        _run_plan,
        k_ordered_suffix_array,
        k_ordered_suffix_array_device,
    )
    from kiss_tpu_torch.utils import codec, fasta
    from kiss_tpu_torch.utils.synth import sample_patterns, synth_genome

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---- 2. build
    build_s = kernels.timed_build()
    say(f"build: nvcc sm_90a of {len(kernels.SOURCES)} sources in "
        f"kiss_tpu_torch/csrc/, one process each -> "
        f"{os.path.relpath(kernels.library_path(), ROOT)} in {build_s:.3f} s")

    # ---- 3. kernels against their plain versions
    err = {name: 0 for name in KERNELS}
    spilled = phase_kernels(torch, np, err)

    # ---- 4. goldens
    phase_goldens(torch, np)

    # ---- 5. the main path at full width
    dev = torch.device("cuda")
    text = synth_genome(N_TEXT)
    pats = sample_patterns(text, N_QUERIES, QLEN)
    tmpdir = tempfile.TemporaryDirectory(prefix="kiss_chip_smoke_")
    tmp = tmpdir.name
    fa = os.path.join(tmp, "genome.fa")
    fasta.write_fasta(fa, [fasta.FastaRecord("synth", text)], width=80)
    batch = os.path.join(tmp, "patterns.bin")
    with open(batch, "wb") as f:
        f.write(struct.pack("<II", QLEN, N_QUERIES))
        f.write(codec.to_string(pats.reshape(-1)).encode())
    q_pattern = codec.to_string(pats[0])

    logs = LogLines()
    logging.getLogger().addHandler(logs)
    kernels.reset_launch_counts()
    steps = {}
    torch.cuda.reset_peak_memory_stats()
    for name, argv in (
        ("suffix_sort -k 256", ["suffix_sort", "-k", "256", fa]),
        ("fmindex_build", ["fmindex_build", fa]),
        ("fmindex_query -b", ["fmindex_query", "-b", batch, fa]),
        ("fmindex_query -q", ["fmindex_query", "-q", q_pattern, "-n", "5",
                              fa]),
    ):
        rc, steps[name] = wall_s(lambda argv=argv: cli.main(argv))
        check(rc == 0, f"{name} returned {rc}")
    launches = {name: kernels.LAUNCHES[name] for name in MAIN_NAMES}
    peak_bytes = torch.cuda.max_memory_allocated()
    logging.getLogger().removeHandler(logs)
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was never launched: {launches}")

    occ = int(logs.value("number of matched locations: "))
    checksum = int(logs.value("location checksum: "))
    search_s = float(logs.value("searching time: ").split()[0])
    text_dev = torch.from_numpy(text).to(dev)
    want_occ, want_checksum = oracle_stats(
        torch, text_dev, torch.from_numpy(pats).to(dev)
    )
    check((occ, checksum) == (want_occ, want_checksum),
          f"-b occ/checksum {(occ, checksum)} != 25-mer oracle "
          f"{(want_occ, want_checksum)}")
    found = int(logs.value(f"query = {q_pattern} found ").split()[0])
    shown = [m for m in logs.lines if m.startswith("The ")]
    check(found >= 1 and len(shown) == min(found, 5), "-q found/positions")
    for m in shown:
        loc = int(m.split(" position is ")[1].split(",")[0])
        check(codec.to_string(text[loc : loc + QLEN]) == q_pattern,
              f"-q position {loc} does not spell the pattern")
    meta = fm.read_meta(fa + ".fmi")
    check(meta is not None and meta.get("full_sa") is True,
          ".meta sidecar does not say full_sa: true")
    sa256, sort_s = wall_s(
        lambda: k_ordered_suffix_array(text_dev, 256, as_numpy=False,
                                       device=dev)
    )
    check_k_sorted_sample(text_dev, sa256, 256, 100_000)
    del sa256
    say(f"main path n={N_TEXT}: occ {occ} and checksum {checksum} equal the "
        f"25-mer oracle; -q found {found}, positions spell the pattern; "
        f"k=256 SA permutation + 100000-row order sample ok; .meta full_sa "
        f"true; launches {launches}; peak CUDA bytes {peak_bytes} "
        f"({peak_bytes / N_TEXT:.1f} per char)")

    # ---- 6. kernels against their plain versions on the inputs the
    # full-size main path hands them
    fmi = fm.FMIndex(sa_intv=4, device=dev)
    with open(fa + ".fmi", "rb") as f:
        fmi.load(f)
    arrays, blocks, L = fmi.arrays, fmi.blocks, fmi.lookup_len
    qw = torch.from_numpy(pack.np_pack_queries_2bit(pats).view(np.int32)).to(
        dev
    )

    def sort_with(sort_impl, k):
        plan = _make_plan(N_TEXT, _normalize_k(k), pack.DNA)
        return _run_plan(text_dev, plan, pack.DNA, sort_impl=sort_impl)

    sort_calls = []

    def compared_sort(keys):
        got = radix_sort_words(keys)
        want = radix_sort_words_plain(keys)
        err["radix_sort_words"] = max(
            err["radix_sort_words"], exact(got[1], want[1]),
            exact(got[0], want[0]),
        )
        sort_calls.append((*keys.shape, sort_split.digit_passes(keys)))
        return got

    for k in (256, -1):
        # the rounds on the tied rows alone against every round over the
        # whole array
        check(torch.equal(sort_with(compared_sort, k),
                          k_ordered_suffix_array_device(text_dev, k)),
              f"k={k}: the tied-row rounds' SA differs from the whole-array "
              "rounds' SA")

    def compare_ranges(q):
        got = fm.get_range_packed_device(arrays, q, QLEN, L, blocks=blocks)
        want = fm.get_range_packed_device_plain(arrays, q, QLEN, L)
        for g, w in zip(got, want):
            err["fm_backward_search"] = max(
                err["fm_backward_search"], exact(g, w)
            )
        stats = fm.batch_locate_stats_device(arrays, got[0], got[1], 4,
                                             blocks=blocks)
        err["fm_locate_stats"] = max(
            err["fm_locate_stats"],
            exact(stats, fm.batch_locate_stats_device_plain(
                arrays, want[0], want[1], 4)),
        )
        return got, stats

    # the -b path's split of the 1M batch into 100k-query chunks
    chunk_stats = [
        compare_ranges(qw[c : c + CLI_CHUNK])[1]
        for c in range(0, N_QUERIES, CLI_CHUNK)
    ]
    check(tuple(map(sum, zip(*chunk_stats))) == (occ, checksum),
          "the chunks' kernel stats do not add up to the CLI's")
    (beg, end, _), _ = compare_ranges(qw)  # the whole batch
    qb, qe, _ = fm.get_range_device(
        arrays, codec.to_istring(q_pattern)[None, :], L, blocks=blocks
    )
    rows = torch.arange(int(qb[0]), int(qe[0]), device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    rand_rows = torch.randint(0, N_TEXT + 1, (N_QUERIES,), device=dev,
                              generator=g)
    for r in (rows, rand_rows):
        err["fm_locate_rows"] = max(
            err["fm_locate_rows"],
            exact(fm.locate_rows_device(arrays, r, 4, blocks=blocks),
                  fm.locate_rows_device_plain(arrays, r, 4)),
        )
    torch.cuda.synchronize()
    say(f"kernels vs plain at the main path's shapes (exact, tolerance 0): "
        f"K1 on all {len(sort_calls)} sort calls of k=256 and k=-1 at "
        f"n={N_TEXT} (W, N, digit passes: {sort_calls}), their SAs equal to "
        f"the whole-array rounds'; K2 and K3 stats on "
        f"{len(chunk_stats)} chunks of {CLI_CHUNK} x {QLEN} and the "
        f"{N_QUERIES}-query batch, lookup {L}; K3 rows on the -q rows "
        f"({rows.shape[0]}) and {N_QUERIES} random rows: all equal")

    # ---- 7. the range-BFS locate path at full width
    fa32 = os.path.join(tmp, "genome_k32.fa")
    fa_nometa = os.path.join(tmp, "genome_nometa.fa")
    os.symlink(fa, fa32)
    os.symlink(fa, fa_nometa)
    os.link(fa + ".fmi", fa_nometa + ".fmi")  # the full-sort archive alone
    lens = end - beg
    # the batch's most frequent pattern among those found at most 200 times
    qi = int(torch.argmax(torch.where(lens <= 200, lens, 0)))
    bfs_pattern = codec.to_string(pats[qi])
    logging.getLogger().addHandler(logs)

    # each step's launches, the counters set to 0 just before it
    bfs_steps = {}

    def run_cli(name, argv):
        del logs.lines[:]
        kernels.reset_launch_counts()
        rc, steps[name] = wall_s(lambda: cli.main(argv))
        bfs_steps[name] = dict(kernels.LAUNCHES)
        check(rc == 0, f"{name} returned {rc}")

    def batch_stats():
        return (int(logs.value("number of matched locations: ")),
                int(logs.value("location checksum: ")))

    run_cli("fmindex_build -k 32", ["fmindex_build", "-k", "32", fa32])
    meta32 = fm.read_meta(fa32 + ".fmi")
    check(meta32 is not None and meta32.get("full_sa") is False
          and meta32.get("sort_len") == 32,
          f"-k 32 .meta does not say full_sa: false, sort_len 32: {meta32}")
    run_cli("fmindex_query -b (BFS, -k 32)",
            ["fmindex_query", "-b", batch, fa32])
    check(batch_stats() == (occ, checksum),
          f"BFS -b on the -k 32 archive: {batch_stats()} != the oracle's "
          f"{(occ, checksum)}")
    bfs_search_s = float(logs.value("searching time: ").split()[0])
    run_cli("fmindex_query -q (BFS, -k 32)",
            ["fmindex_query", "-q", bfs_pattern, "-n", "200", fa32])
    found32 = int(logs.value(f"query = {bfs_pattern} found ").split()[0])
    shown32 = sorted(
        int(m.split(" position is ")[1].split(",")[0])
        for m in logs.lines if m.startswith("The ")
    )
    check(fm.read_meta(fa_nometa + ".fmi") is None, "stray .meta")
    run_cli("fmindex_query -b (BFS, .meta removed)",
            ["fmindex_query", "-b", batch, fa_nometa])
    check(batch_stats() == (occ, checksum),
          f"BFS -b on the full-sort archive without .meta: {batch_stats()} "
          f"!= {(occ, checksum)}")
    bfs_launches = {name: sum(step[name] for step in bfs_steps.values())
                    for name in kernels.LAUNCHES}
    logging.getLogger().removeHandler(logs)
    walk_rows = torch.arange(int(beg[qi]), int(end[qi]), device=dev)
    walked = sorted(
        fm.locate_rows_device(arrays, walk_rows, 4, blocks=blocks).tolist()
    )
    check(found32 == int(lens[qi]) and shown32 == walked,
          "BFS -q positions differ from the full index's per-row walk")
    check(bfs_launches["radix_sort_words"] > 0
          and bfs_launches["fm_backward_search"] > 0
          and all(bfs_launches[name] > 0 for name in BFS_NAMES)
          and bfs_launches["fm_locate_stats"] == 0
          and bfs_launches["fm_locate_rows"] == 0,
          f"the BFS path's launches are not K1, K2 and K4: {bfs_launches}")
    # K4 on its route: stats once a CLI chunk of -b, locate once for -q
    b_step = bfs_steps["fmindex_query -b (BFS, -k 32)"]
    q_step = bfs_steps["fmindex_query -q (BFS, -k 32)"]
    check(b_step["fm_bfs_stats"] == -(-N_QUERIES // CLI_CHUNK)
          and b_step["fm_bfs_locate"] == 0 and q_step["fm_bfs_stats"] == 0
          and q_step["fm_bfs_locate"] == 1,
          f"K4 launches: -b {b_step}, -q {q_step}")
    launches["fm_bfs_stats"] = b_step["fm_bfs_stats"]
    launches["fm_bfs_locate"] = q_step["fm_bfs_locate"]
    bfs_by_path = {name: {step: counts[name] for step, counts
                          in bfs_steps.items() if counts[name]}
                   for name in BFS_NAMES}

    # the library's batch_query on both indexes: per query, the same
    # positions (the BFS orders them by depth, the walk by row)
    fmi32 = fm.FMIndex(sa_intv=4, device=dev)
    with open(fa32 + ".fmi", "rb") as f:
        fmi32.load(f)
    check(not fmi32.full_sa, "a loaded archive must route to the BFS")
    fmi.full_sa = True  # it was built from the full sort (.meta said so)
    l32, p32, s32 = fmi32.batch_query(pats[:CLI_CHUNK])
    lf, pf, sf = fmi.batch_query(pats[:CLI_CHUNK])
    qid = np.repeat(np.arange(CLI_CHUNK), lf)
    check(np.array_equal(l32, lf) and np.array_equal(s32, sf)
          and np.array_equal(p32[np.lexsort((p32, qid))],
                             pf[np.lexsort((pf, qid))]),
          "batch_query by the BFS differs from the per-row walk")
    b32, e32, _ = fm.get_range_packed_device(fmi32.arrays, qw, QLEN,
                                             fmi32.lookup_len,
                                             blocks=fmi32.blocks)
    check(fm.batch_bfs_stats_device(fmi32.arrays, b32, e32, 4,
                                    blocks=fmi32.blocks) == (occ, checksum),
          "BFS stats of the whole batch")
    # the -t N route: ShardedFMQuery's BFS stats on four shards of this
    # card take K4 on the lead card's tables
    from kiss_tpu_torch.parallel import make_mesh
    from kiss_tpu_torch.parallel.fm_sharded import ShardedFMQuery

    sharded = ShardedFMQuery(make_mesh(devices=[dev] * 4), fmi32)
    kernels.reset_launch_counts()
    mesh_bfs = sharded.batch_query_stats(pats)
    mesh_pos = sorted(sharded.get_offsets(
        *sharded.get_range(pats[qi])[:2]).tolist())
    mesh_launches = dict(kernels.LAUNCHES)
    check(mesh_bfs == (occ, checksum) and mesh_pos == walked
          and all(mesh_launches[name] == 1 for name in BFS_NAMES)
          and mesh_launches["fm_locate_stats"] == 0
          and mesh_launches["fm_locate_rows"] == 0,
          f"ShardedFMQuery BFS stats {mesh_bfs} (the oracle's: "
          f"{(occ, checksum)}), -q positions equal the walk's: "
          f"{mesh_pos == walked}, launches {mesh_launches}")
    del sharded
    for name in BFS_NAMES:
        bfs_by_path[name]["ShardedFMQuery D=4 (shards on one card)"] = (
            mesh_launches[name])
    # K4 alone at the CLI chunk and the 1M batch, each output held to the
    # plain version (positions element for element), and the plain times
    bfs_split = fm_query_time.measure_bfs(fmi32, b32, e32, CLI_CHUNK, smi,
                                          say=say)
    say(f"BFS path n={N_TEXT}: fmindex_build -k 32 wrote .meta full_sa "
        f"false; -b on it and on the full-sort archive without .meta give "
        f"occ {occ} and checksum {checksum} (the oracle's), searching time "
        f"{bfs_search_s:.3f} s (the walk's {search_s:.3f}); -q "
        f"{bfs_pattern} found {found32}, positions equal the per-row walk; "
        f"batch_query of {CLI_CHUNK} patterns ({int(lf.sum())} positions) "
        f"equal per query; ShardedFMQuery D=4 BFS stats the oracle's and "
        f"its -q positions the walk's; "
        f"launches by step {bfs_steps}")
    del fmi32, b32, e32

    # ---- 7a-7e. the out-of-core sorter, the other sort routes, serve, the
    # general alphabet and the BFS at N % 64 == 0
    logging.getLogger().addHandler(logs)
    k1_shapes = {}
    ext_launches, ext_splits = phase_external(
        torch, np, cli, kernels, fa, text, text_dev, err, k1_shapes
    )
    routed_launches = phase_routes(torch, np, cli, kernels, logs, tmp)
    phase_serve(cli, kernels, logs, fa, batch, tmp, q_pattern, found, occ,
                checksum, "full-sort archive")
    served = phase_serve(cli, kernels, logs, fa32, batch, tmp, q_pattern,
                         found, occ, checksum, "-k 32 archive (range BFS)")
    check(all(served[name] > 0 for name in BFS_NAMES)
          and served["fm_locate_stats"] == 0
          and served["fm_locate_rows"] == 0,
          f"serve on the -k 32 archive did not go through K4: {served}")
    for name in BFS_NAMES:
        bfs_by_path[name]["serve (-k 32 archive)"] = served[name]
    general_launches = phase_general(torch, np, kernels, err, k1_shapes)
    edge = phase_bfs_edge(torch, np, cli, kernels, logs, tmp)
    for name in BFS_NAMES:
        bfs_by_path[name]["7e: -b and -q at N % 64 == 0"] = edge[name]
    logging.getLogger().removeHandler(logs)
    check(fmi.full_sa, "the full-sort index must take the per-row walk")
    k1_rows = phase_k1_shapes(torch, smi, err, k1_shapes)
    del k1_shapes
    mesh_steps, mesh_k1_rows, k2_rows = phase_mesh(
        torch, np, kernels, fa, text, text_dev, pats, qw, fmi, occ, checksum,
        err, smi)
    k1_rows.update(mesh_k1_rows)
    big_launches, k1_rows[f"7g W=1 N={BIG_N + 1}"] = phase_big_n(
        torch, np, kernels, err, smi)
    for name in BFS_NAMES:
        bfs_by_path[name][BIG_PATH] = big_launches[name]
    sweep_launches, sweep_k1_rows, roofline = phase_sweep(
        torch, np, cli, kernels, fa, text, text_dev, err, smi,
        steps["suffix_sort -k 256"])
    k1_rows.update(sweep_k1_rows)
    bench_launches, bench_k2_rows = phase_bench(
        torch, kernels, fmi, qw, lens, occ, checksum, err, smi)
    k2_rows.update(bench_k2_rows)
    bfs_by_path["fm_bfs_stats"][BENCH_PATH] = bench_launches["fm_bfs_stats"]

    # ---- 8. the probe path, then the probes against their plain versions
    launches.update(phase_probe_path(torch, kernels))
    ms, plain_ms, library_ms, bounds = {}, {}, {}, {}
    clone_bytes_per_s = phase_probes(torch, smi, err, ms, plain_ms,
                                     library_ms, bounds)

    # ---- 9. step and kernel times, kernels vs plain versions
    def build_with(sort_impl):
        sa = sort_with(sort_impl, -1)
        return fm.build_index_device(text_dev, sa, 4)

    times = {}
    for label, fn in (
        ("sort k=256", lambda impl: sort_with(impl, 256)),
        ("build (k=-1 sort + index)", build_with),
    ):
        _, t_k = wall_s(lambda: fn(radix_sort_words))
        _, t_p = wall_s(lambda: fn(radix_sort_words_plain))
        _, t_k2 = wall_s(lambda: fn(radix_sort_words))
        times[label] = (min(t_k, t_k2), t_p)

    # K5 at the seed sort's shape (W = 5, N = n + 1) against its plain
    # version, and timed; then K1 on the same words
    w5 = pack.seed_key_words(text_dev, 64)
    err["seed_key_words"] = exact(w5, pack.seed_key_words_plain(text_dev, 64))
    ms["seed_key_words"] = cuda_ms(lambda: pack.seed_key_words(text_dev, 64),
                                   50)
    plain_ms["seed_key_words"] = cuda_ms(
        lambda: pack.seed_key_words_plain(text_dev, 64), 3
    )
    bounds["seed_key_words"] = k5_bound(w5)
    say(f"K5 on {smi}: W = {w5.shape[0]}, N = {w5.shape[1]}: equal to the "
        f"plain version; {ms['seed_key_words']:.4f} ms (plain "
        f"{plain_ms['seed_key_words']:.3f}), bound "
        f"{bounds['seed_key_words'][0]:.4f} ({bounds['seed_key_words'][1]})")
    check(torch.equal(w5, sort_split.seed_sort_words(text_dev)),
          "K5's words are not the plain chain's")
    # K6 at the build cell's shape (N = 248,387,329 rows, the sentinel in a
    # middle superblock, random words) against its plain version, and timed
    occ_g = torch.Generator(device=dev).manual_seed(BUILD_N)
    occ_words = torch.randint(-2**31, 2**31 - 1, (-(-BUILD_N // 16),),
                              dtype=torch.int32, device=dev,
                              generator=occ_g)
    occ_at = BUILD_N // 2 + 100  # row 100 of its superblock
    occ_pri = torch.tensor(occ_at, device=dev)
    occ_words[occ_at // 16] &= ~(3 << 2 * (occ_at % 16))  # symbol 0 there
    occ_off = torch.zeros(4, dtype=torch.int64, device=dev)
    occ = fm.occ_tables(occ_words, BUILD_N, occ_pri, occ_off)
    err["occ_tables"] = max(exact(a, b) for a, b in zip(
        occ, fm.occ_tables_plain(occ_words, BUILD_N, occ_pri, occ_off)))
    ms["occ_tables"] = cuda_ms(
        lambda: fm.occ_tables(occ_words, BUILD_N, occ_pri, occ_off), 50)
    plain_ms["occ_tables"] = cuda_ms(
        lambda: fm.occ_tables_plain(occ_words, BUILD_N, occ_pri, occ_off), 3)
    bounds["occ_tables"] = k6_bound(occ)
    say(f"K6 on {smi}: N = {BUILD_N}, {occ.lf_tab.shape[0]} table rows: "
        f"equal to the plain version; {ms['occ_tables']:.4f} ms (plain "
        f"{plain_ms['occ_tables']:.3f}), bound "
        f"{bounds['occ_tables'][0]:.4f} ({bounds['occ_tables'][1]})")
    del occ, occ_words
    ms["radix_sort_words"] = cuda_ms(lambda: radix_sort_words(w5), 5)
    plain_ms["radix_sort_words"] = cuda_ms(
        lambda: radix_sort_words_plain(w5), 3
    )
    bounds["radix_sort_words"] = k1_bound(w5)
    passes5 = sort_split.digit_passes(w5)
    # beside the bound: what an 8-bit LSD sort of these keys must move, a
    # (key, index) pair read and written in every pass, at the rate
    # x.clone() reached in the probe phase of this run
    lsd_floor_ms = passes5 * 16 * w5.shape[1] / clone_bytes_per_s * 1e3
    del w5
    tail_shape = sort_split.TAIL_SHAPE  # a tail-refinement sort
    w8 = sort_split.rank_like_words(tail_shape, dev)
    got, want = radix_sort_words(w8), radix_sort_words_plain(w8)
    err["radix_sort_words"] = max(
        err["radix_sort_words"], exact(got[1], want[1]), exact(got[0], want[0])
    )
    del got, want
    tail_ms = (cuda_ms(lambda: radix_sort_words(w8), 5),
               cuda_ms(lambda: radix_sort_words_plain(w8), 3))
    tail_bound = k1_bound(w8)
    del w8
    say(f"K1 on {smi}: seed sort {ms['radix_sort_words']:.3f} ms (plain "
        f"{plain_ms['radix_sort_words']:.3f}), bound "
        f"{bounds['radix_sort_words'][0]:.3f}, floor of an 8-bit LSD sort of "
        f"its {passes5} passes at x.clone()'s {clone_bytes_per_s / 1e12:.2f} TB/s "
        f"{lsd_floor_ms:.3f}; tail shape W={tail_shape[0]} N={tail_shape[1]} "
        f"{tail_ms[0]:.3f} ms (plain {tail_ms[1]:.3f}), bound "
        f"{tail_bound[0]:.5f} ({tail_bound[1]})")
    # K2 and K3 alone at the shapes the main path launches them (a CLI
    # chunk, the whole batch, the -q rows) and at 1M random rows, with the
    # sectors each table layout reads, their rates and the bounds
    check(L == 0, "the CLI's index has no lookup table")
    split = fm_query_time.measure(fmi, qw, rows, rand_rows, CLI_CHUNK, smi,
                                  say=say)
    chunk, batch = f"chunk {CLI_CHUNK}", f"batch {N_QUERIES}"
    q_shape = f"-q rows {rows.shape[0]}"
    for name, shape in (("fm_backward_search", batch),
                        ("fm_locate_stats", batch),
                        ("fm_locate_rows", q_shape)):
        ms[name] = split[(name, shape)]["ms"]
        bounds[name] = split[(name, shape)]["bound"]
    plain_ms["fm_backward_search"] = cuda_ms(
        lambda: fm.get_range_packed_device_plain(arrays, qw, QLEN, L), 3
    )
    plain_ms["fm_locate_stats"] = cuda_ms(
        lambda: fm.batch_locate_stats_device_plain(arrays, beg, end, 4), 3
    )
    plain_ms["fm_locate_rows"] = cuda_ms(
        lambda: fm.locate_rows_device_plain(arrays, rows, 4), 20
    )
    # the plain versions at the other shapes the kernels are timed at
    qc = qw[:CLI_CHUNK]
    cb, ce, _ = fm.get_range_packed_device(arrays, qc, QLEN, L, blocks=blocks)
    other = (
        cuda_ms(lambda: fm.get_range_packed_device_plain(arrays, qc, QLEN, L),
                3),
        cuda_ms(lambda: fm.batch_locate_stats_device_plain(arrays, cb, ce, 4),
                3),
        cuda_ms(lambda: fm.locate_rows_device_plain(arrays, rand_rows, 4), 3),
    )
    say(f"plain versions on {smi}, ms: K2 chunk {CLI_CHUNK} x {QLEN} "
        f"{other[0]:.4f}; K3 stats chunk {other[1]:.4f}; K3 rows "
        f"{N_QUERIES} random {other[2]:.4f}")
    del qc, cb, ce
    # what the main path spends over the bounds, at the shape it launches:
    # K2 and K3 stats once a 100,000-query chunk (K2 once more for -q's one
    # pattern, counted here at the chunk's gap), K3 rows once for -q
    over = {
        name: (launches[name], split[(name, shape)]["ms"],
               split[(name, shape)]["bound"][0])
        for name, shape in (("fm_backward_search", chunk),
                            ("fm_locate_stats", chunk),
                            ("fm_locate_rows", q_shape))
    }
    say(f"K2/K3 launches x (time - bound) at the main path's shapes on "
        f"{smi}: " + "; ".join(
            f"{name} {n} x ({t:.4f} - {b:.4f}) = {n * (t - b):.4f} ms"
            for name, (n, t, b) in over.items()))
    for name in BFS_NAMES:
        ms[name] = bfs_split[(name, batch)]["ms"]
        plain_ms[name] = bfs_split[(name, batch)]["plain_ms"]
        bounds[name] = bfs_split[(name, batch)]["bound"]
    for name in bounds:
        library_ms.setdefault(name, None)  # K1-K4: no one PyTorch call
    times["query counts (1M x 25, K2)"] = (
        ms["fm_backward_search"] / 1e3, plain_ms["fm_backward_search"] / 1e3
    )
    times["locate stats (1M ranges, K3)"] = (
        ms["fm_locate_stats"] / 1e3, plain_ms["fm_locate_stats"] / 1e3
    )
    say(f"step seconds on {smi} (n={N_TEXT}): CLI "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
        + f", searching time {search_s:.3f}; library sort k=256 "
        f"{sort_s:.3f}; kernel path vs plain: "
        + ", ".join(f"{k} {a:.4f} vs {b:.4f}" for k, (a, b) in times.items())
        + f"; range BFS: -b searching time {bfs_search_s:.3f} (the walk's "
        f"{search_s:.3f}), K4 stats of the 1M ranges "
        f"{bfs_split[('fm_bfs_stats', batch)]['ms'] / 1e3:.6f} (plain "
        f"{bfs_split[('fm_bfs_stats', batch)]['plain_ms'] / 1e3:.4f}) and of "
        f"one {CLI_CHUNK}-query chunk "
        f"{bfs_split[('fm_bfs_stats', chunk)]['ms'] / 1e3:.6f} (plain "
        f"{bfs_split[('fm_bfs_stats', chunk)]['plain_ms'] / 1e3:.4f}), "
        f"beside K3 stats")

    # ---- the two sorts split by device kernel. Last of all: once the
    # profiler has run, every launch of the process costs the host more,
    # which would show in the timings of the small kernels above
    def split_line(label, fn):
        """One line: what the device ran inside ``fn()``, summed by
        kernel, largest first (count, total ms)."""
        events, _ = sort_split.device_events(fn)
        parts = sorted(sort_split.by_name(events).items(),
                       key=lambda kv: -kv[1][1])
        say(f"split of {label} on {smi} (device kernels by torch.profiler, "
            "count and total ms): "
            + ", ".join(f"{name[:48]} x{c} {us / 1e3:.3f}"
                        for name, (c, us) in parts))

    w5 = sort_split.seed_sort_words(text_dev)
    split_line(f"K1 seed sort W=5 N={w5.shape[1]} ({passes5} passes)",
               lambda: radix_sort_words(w5))
    del w5
    w8 = sort_split.rank_like_words(tail_shape, dev)
    split_line(f"K1 tail shape W={tail_shape[0]} N={tail_shape[1]}",
               lambda: radix_sort_words(w8))
    del w8
    pk, pv = mk.probe_inputs(N_PROBE, dev)
    for r in (256, 1024, PROBE_ROWS):
        split_line(f"P3 tile_sort T={r * mk.LANES // 1024}K N={N_PROBE}",
                   lambda: mk.tile_sort(pk, pv, r))
    del pk, pv
    # K4's two entry points on the 1M ranges of the -k 32 archive
    fmi32 = fm.FMIndex(sa_intv=4, device=dev)
    with open(fa32 + ".fmi", "rb") as f:
        fmi32.load(f)
    b32, e32, _ = fm.get_range_packed_device(fmi32.arrays, qw, QLEN, 0,
                                             blocks=fmi32.blocks)
    for label, fn in (("stats", fm.batch_bfs_stats_device),
                      ("locate", fm.bfs_locate_device)):
        split_line(f"K4 {label}, the {N_QUERIES} ranges of the batch",
                   lambda fn=fn: fn(fmi32.arrays, b32, e32, 4,
                                    blocks=fmi32.blocks))
    del fmi32, b32, e32

    tmpdir.cleanup()
    check(sys.modules.get("jax") is None, "jax was imported")
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library_ms[name]}
        for name, (src, rep) in KERNELS.items()
    ]}
    # K1's launches on the paths of this slice, and its times at their shapes
    by_name = {k["name"]: k for k in report["kernels"]}
    by_name["radix_sort_words"].update({
        "launches_by_path": {
            "main path": launches["radix_sort_words"],
            "suffix_sort --external -k 256": ext_launches,
            "suffix_sort -k 256 routed out of core": routed_launches,
            "get_suffix_array k=256": general_launches,
            **{name: k1 for name, (_, k1, _, _, _) in mesh_steps.items()
               if k1},
            BIG_PATH: big_launches["radix_sort_words"],
            **sweep_launches,
            BENCH_PATH: bench_launches["radix_sort_words"],
        },
        "shapes": {name: {"ms": t, "plain_ms": p, "bound_ms": b,
                          "bound_by": by}
                   for name, (t, p, b, by) in k1_rows.items()}
        | roofline,
        "external_split_s": ext_splits,
    })
    # K2's launches on the mesh path, and its time at the shard's shape
    by_name["fm_backward_search"].update({
        "launches_by_path": {
            "main path": launches["fm_backward_search"],
            **{name: k2 for name, (_, _, k2, _, _) in mesh_steps.items()
               if k2},
            BIG_PATH: big_launches["fm_backward_search"],
            BENCH_PATH: bench_launches["fm_backward_search"],
        },
        "shapes": {name: {"ms": t, "plain_ms": p, "bound_ms": b,
                          "bound_by": by}
                   for name, (t, p, b, by) in k2_rows.items()},
    })
    # K3 stats' launches on the main path and the benchmark's
    by_name["fm_locate_stats"]["launches_by_path"] = {
        "main path": launches["fm_locate_stats"],
        BENCH_PATH: bench_launches["fm_locate_stats"],
    }
    # K4's launches on each BFS route, and its times at the CLI chunk and the
    # whole batch
    for name in BFS_NAMES:
        by_name[name].update({
            "launches_by_path": bfs_by_path[name],
            "shapes": {shape: {key: v[key] for key in ("ms", "plain_ms",
                                                       "wrapper_ms",
                                                       "passes", "spilled")}
                       | {"bound_ms": v["bound"][0],
                          "bound_by": v["bound"][1]}
                       for (k, shape), v in bfs_split.items() if k == name},
            "spilled_by_case": {case: counts[name]
                                for case, counts in spilled.items()},
        })
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
