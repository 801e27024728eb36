#!/usr/bin/env python3
"""Smoke run of kiss_tpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints one line, and any failure raises: the script then
exits non-zero and prints no result line):

  1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: the three hand-written kernels (kiss_tpu_torch/csrc/*.cu)
     compiled by nvcc for sm_90a into kiss_tpu_torch/build/;
  3. each kernel against its plain PyTorch version on the card, exact
     (tolerance 0: every output is an integer), on edge cases at
     N = 2**22 + 7: W = 1, all-equal keys, a stable payload, lookup seeds;
  4. the golden outputs of the reference binary (tests/golden/*.npz)
     reproduced on the card;
  5. the main path through ``kiss_tpu_torch.cli.main`` at full width: a
     48,800,648-character synthetic genome (bench.synth_genome) through
     ``suffix_sort -k 256``, ``fmindex_build``, ``fmindex_query -b`` with
     1,000,000 patterns of length 25 (bench.sample_patterns) and
     ``fmindex_query -q``, with every kernel's launch counter reset just
     before and read just after; the counts and checksum are held
     against an independent 25-mer oracle computed on the card;
  6. each kernel against its plain version, exact, on the inputs the
     full-size main path hands it: every K1 call of the k = 256 and
     k = -1 sorts, K2 and K3 stats on the CLI's 100,000-query chunks of
     the batch over the 48.8M-char index, K3 rows on the ``-q`` rows;
  7. step times of the main path and of the plain versions at the same
     shapes, then one JSON line with each kernel's launches, error and
     time, and as the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX: bench.py's module level is numpy only.
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

KERNELS = {
    "radix_sort_words": (
        "kiss_tpu_torch/csrc/radix_sort.cu", "kiss_tpu/ops/suffix_sort.py:334"
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


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def say(msg: str) -> None:
    print(msg, flush=True)


class LogLines(logging.Handler):
    """Collects the CLI's log messages (they propagate to the root)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def value(self, prefix: str) -> str:
        hits = [m[len(prefix):] for m in self.lines if m.startswith(prefix)]
        check(hits, f"no log line starting {prefix!r}")
        return hits[-1]


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


def seed_sort_words(text_dev):
    """The 5 words the seed sort hands K1 (64 raw chars + end/position)."""
    from kiss_tpu_torch.ops import pack
    from kiss_tpu_torch.ops.suffix_sort import _pack_fields

    n = text_dev.shape[0]
    words, _ = _pack_fields(
        [(w, 32, False) for w in pack.suffix_key_words_2bit(text_dev, 64, 0)]
        + [(pack.fused_end_pos(n, 64, text_dev.device),
            max(n.bit_length(), 1), True)]
    )
    return words


def phase_kernels(torch, np, bench, err):
    """Each kernel against its plain version on edge cases."""
    from kiss_tpu_torch.models import fm_index as fm
    from kiss_tpu_torch.ops import pack
    from kiss_tpu_torch.ops.radix_sort import (
        radix_sort_words,
        radix_sort_words_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    text = bench.synth_genome(SMALL_N, seed=3)
    N = SMALL_N + 1
    w5 = seed_sort_words(torch.from_numpy(text).to(dev))

    def rand_words(w, high):
        x = rng.integers(0, high, (w, N), dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(x.view(np.int32)).to(dev)

    cases = {
        "seed W=5": w5,
        "random W=8": rand_words(8, 2**32),
        "random W=1": rand_words(1, 2**32),
        "all-equal W=5": torch.full((5, N), 7, dtype=torch.int32, device=dev),
        "stable payload W=8 (4 values)": rand_words(8, 4),
    }
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
        pats = bench.sample_patterns(text, nq, qlen, seed=qlen)
        qw = torch.from_numpy(
            pack.np_pack_queries_2bit(pats).view(np.int32)
        ).to(dev)
        for L in (0, 8):
            got = fm.get_range_packed_device(idx[L].arrays, qw, qlen, L)
            want = fm.get_range_packed_device_plain(idx[L].arrays, qw, qlen,
                                                    L)
            for g, w in zip(got, want):
                err["fm_backward_search"] = max(
                    err["fm_backward_search"], exact(g, w)
                )
        arrays = idx[0].arrays
        beg, end, _ = fm.get_range_packed_device(arrays, qw, qlen, 0)
        err["fm_locate_stats"] = max(
            err["fm_locate_stats"],
            exact(fm.batch_locate_stats_device(arrays, beg, end, 4),
                  fm.batch_locate_stats_device_plain(arrays, beg, end, 4)),
        )
    rows = torch.from_numpy(rng.integers(0, N, nq)).to(dev)
    err["fm_locate_rows"] = exact(
        fm.locate_rows_device(idx[0].arrays, rows, 4),
        fm.locate_rows_device_plain(idx[0].arrays, rows, 4),
    )
    torch.cuda.synchronize()
    say(
        f"kernels vs plain, edge cases (exact, tolerance 0): K1 on "
        f"{len(cases)} key sets "
        f"at N = {N}; K2 on {nq} queries x qlen 25/12 x lookup 0/8 over a "
        f"{SMALL_N}-char index; K3 rows ({nq}) and stats: all equal"
    )


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
    say(f"goldens on the card: {len(paths)} fixtures, k=-1 SA bit-identical, "
        "random4k .fmi byte-identical, query_stats equal")


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


def check_k_sorted_sample(torch, text_dev, sa, k: int, samples: int):
    """``samples`` random adjacent SA rows are in order by their first k
    characters (a suffix that ends sorts first), ties by position; the
    SA is a permutation of 0..n."""
    n = text_dev.shape[0]
    N = n + 1
    check(sa.shape[0] == N, "SA length")
    check(bool((torch.bincount(sa, minlength=N) == 1).all()),
          "SA is not a permutation")
    padded = torch.full((n + k,), -1, dtype=torch.int16, device=sa.device)
    padded[:n] = text_dev.to(torch.int16)
    g = torch.Generator(device=sa.device).manual_seed(5)
    r = torch.randint(0, N - 1, (samples,), device=sa.device, generator=g)
    a, b = sa[r], sa[r + 1]
    cols = torch.arange(k, device=sa.device)
    wa, wb = padded[a[:, None] + cols], padded[b[:, None] + cols]
    diff = wa != wb
    first = torch.argmax(diff.to(torch.int32), dim=1)
    rows = torch.arange(samples, device=sa.device)
    ok = torch.where(
        diff.any(dim=1), wa[rows, first] < wb[rows, first], a < b
    )
    check(bool(ok.all()), "k=256 SA sample out of order")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, ROOT)
    import bench
    from kiss_tpu_torch import cli, kernels
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
    )
    from kiss_tpu_torch.utils import codec, fasta

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
    say(f"build: nvcc sm_90a of kiss_tpu_torch/csrc/*.cu -> "
        f"{os.path.relpath(kernels.library_path(), ROOT)} in {build_s:.3f} s")

    # ---- 3. kernels against their plain versions
    err = {name: 0 for name in KERNELS}
    phase_kernels(torch, np, bench, err)

    # ---- 4. goldens
    phase_goldens(torch, np)

    # ---- 5. the main path at full width
    dev = torch.device("cuda")
    text = bench.synth_genome(N_TEXT)
    pats = bench.sample_patterns(text, N_QUERIES, QLEN)
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
    launches = dict(kernels.LAUNCHES)
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
    check_k_sorted_sample(torch, text_dev, sa256, 256, 100_000)
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
    arrays, L = fmi.arrays, fmi.lookup_len
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
        sort_calls.append(tuple(keys.shape))
        return got

    for k in (256, -1):
        sort_with(compared_sort, k)

    def compare_ranges(q):
        got = fm.get_range_packed_device(arrays, q, QLEN, L)
        want = fm.get_range_packed_device_plain(arrays, q, QLEN, L)
        for g, w in zip(got, want):
            err["fm_backward_search"] = max(
                err["fm_backward_search"], exact(g, w)
            )
        stats = fm.batch_locate_stats_device(arrays, got[0], got[1], 4)
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
    (beg, end, _), _ = compare_ranges(qw)  # the whole batch, as timed below
    qb, qe, _ = fm.get_range_device(
        arrays, codec.to_istring(q_pattern)[None, :], L
    )
    rows = torch.arange(int(qb[0]), int(qe[0]), device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    rand_rows = torch.randint(0, N_TEXT + 1, (N_QUERIES,), device=dev,
                              generator=g)
    for r in (rows, rand_rows):
        err["fm_locate_rows"] = max(
            err["fm_locate_rows"],
            exact(fm.locate_rows_device(arrays, r, 4),
                  fm.locate_rows_device_plain(arrays, r, 4)),
        )
    torch.cuda.synchronize()
    say(f"kernels vs plain at the main path's shapes (exact, tolerance 0): "
        f"K1 on all {len(sort_calls)} sort calls of k=256 and k=-1 at "
        f"n={N_TEXT} (W x N: {sort_calls}); K2 and K3 stats on "
        f"{len(chunk_stats)} chunks of {CLI_CHUNK} x {QLEN} and the "
        f"{N_QUERIES}-query batch, lookup {L}; K3 rows on the -q rows "
        f"({rows.shape[0]}) and {N_QUERIES} random rows: all equal")

    # ---- 7. step and kernel times, kernels vs plain versions
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
    ms, plain_ms = {}, {}
    w5 = seed_sort_words(text_dev)
    ms["radix_sort_words"] = cuda_ms(lambda: radix_sort_words(w5), 5)
    plain_ms["radix_sort_words"] = cuda_ms(
        lambda: radix_sort_words_plain(w5), 3
    )
    del w5
    ms["fm_backward_search"] = cuda_ms(
        lambda: fm.get_range_packed_device(arrays, qw, QLEN, L), 10
    )
    plain_ms["fm_backward_search"] = cuda_ms(
        lambda: fm.get_range_packed_device_plain(arrays, qw, QLEN, L), 3
    )
    ms["fm_locate_stats"] = cuda_ms(
        lambda: fm.batch_locate_stats_device(arrays, beg, end, 4), 10
    )
    plain_ms["fm_locate_stats"] = cuda_ms(
        lambda: fm.batch_locate_stats_device_plain(arrays, beg, end, 4), 3
    )
    ms["fm_locate_rows"] = cuda_ms(
        lambda: fm.locate_rows_device(arrays, rows, 4), 20
    )
    plain_ms["fm_locate_rows"] = cuda_ms(
        lambda: fm.locate_rows_device_plain(arrays, rows, 4), 20
    )
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
        + ", ".join(f"{k} {a:.4f} vs {b:.4f}" for k, (a, b) in times.items()))

    tmpdir.cleanup()
    check(sys.modules.get("jax") is None, "jax was imported")
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": plain_ms[name]}
        for name, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
