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
     archive with its ``.meta`` removed: occurrences and checksum equal
     the oracle's, positions equal the full index's per-row walk;
  8. the probe path: ``kiss_tpu_torch.experiments.micro_kernels`` and
     ``micro_copy`` through their ``main`` at the probes' own size
     (48,758,784 elements), launch counters reset just before and read
     just after; then each probe kernel P1-P7 against its plain version,
     exact, at those shapes, with its time, the plain version's and the
     one PyTorch call's where there is one;
  9. step times of the main path and of the plain versions at the same
     shapes, then one JSON line with each kernel's launches, error,
     times and bound, and as the last line ``{"ok": true, "device":
     {...}}``.

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

# Published peaks of one H100 SXM (NVIDIA's data sheet). The sheet gives no
# rate for 32-bit integer arithmetic outside the tensor cores; Hopper runs
# it on half of the lanes that give the sheet's 67 TFLOP/s in float32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 2

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
_PROBES_CU = "kiss_tpu_torch/csrc/micro_probes.cu"
KERNELS.update({
    "stream_copy": (_PROBES_CU, "experiments/micro_pallas.py:52"),
    "one_stage": (_PROBES_CU, "experiments/micro_pallas.py:101"),
    "tile_sort": (_PROBES_CU, "experiments/micro_pallas.py:147"),
    "kernel_gather": (_PROBES_CU, "experiments/micro_pallas.py:176"),
    "copy_grid": (_PROBES_CU, "experiments/micro_copy.py:43"),
    "copy_2d": (_PROBES_CU, "experiments/micro_copy.py:62"),
    "run_heavy": (_PROBES_CU, "experiments/micro_copy.py:103"),
})
PROBE_NAMES = tuple(KERNELS)[4:]


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


def phase_kernels(torch, np, err):
    """Each kernel against its plain version on edge cases."""
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
        pats = sample_patterns(text, nq, qlen, seed=qlen)
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


def bound_ms(bytes_moved: float, int_ops: float):
    """(least milliseconds the card could take, what bounds it): the
    larger of the bytes over the memory rate and the integer operations
    over the integer rate."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = int_ops / PEAK_INT32_OPS_PER_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


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
    with the kernel's, the plain version's and the PyTorch call's time."""
    import math

    from kiss_tpu_torch.experiments import micro_copy as mc
    from kiss_tpu_torch.experiments import micro_kernels as mk

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
    t = run("run_heavy", lambda: mc.run_heavy(k, rows),
            lambda: mc.run_heavy_plain(k, rows))
    keep("run_heavy", t, 8 * n, 128 * n)
    notes.append(f"run_heavy {fmt(t)} -> {n * 128 / t[0] / 1e9:.2f} Tops/s")
    say(f"probes vs plain on {smi} at N={n}, rows={rows} (exact, tolerance "
        "0; kernel / plain / PyTorch call ms): " + "; ".join(notes))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, ROOT)
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
    phase_kernels(torch, np, err)

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
    launches = {name: kernels.LAUNCHES[name] for name in KERNELS
                if name not in PROBE_NAMES}
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
    (beg, end, offs), _ = compare_ranges(qw)  # the whole batch, as timed below
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

    def run_cli(name, argv):
        del logs.lines[:]
        rc, steps[name] = wall_s(lambda: cli.main(argv))
        check(rc == 0, f"{name} returned {rc}")

    def batch_stats():
        return (int(logs.value("number of matched locations: ")),
                int(logs.value("location checksum: ")))

    kernels.reset_launch_counts()
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
    bfs_launches = dict(kernels.LAUNCHES)
    logging.getLogger().removeHandler(logs)
    walk_rows = torch.arange(int(beg[qi]), int(end[qi]), device=dev)
    walked = sorted(fm.locate_rows_device(arrays, walk_rows, 4).tolist())
    check(found32 == int(lens[qi]) and shown32 == walked,
          "BFS -q positions differ from the full index's per-row walk")
    check(bfs_launches["radix_sort_words"] > 0
          and bfs_launches["fm_backward_search"] > 0
          and bfs_launches["fm_locate_stats"] == 0
          and bfs_launches["fm_locate_rows"] == 0,
          f"the BFS path's launches are not K1 + K2 only: {bfs_launches}")

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
                                             fmi32.lookup_len)
    check(fm.batch_bfs_stats_device(fmi32.arrays, b32, e32, 4)
          == (occ, checksum), "BFS stats of the whole batch")
    bfs_ms = cuda_ms(
        lambda: fm.batch_bfs_stats_device(fmi32.arrays, b32, e32, 4), 3
    )
    bfs_chunk_ms = cuda_ms(
        lambda: fm.batch_bfs_stats_device(
            fmi32.arrays, b32[:CLI_CHUNK], e32[:CLI_CHUNK], 4), 3
    )
    say(f"BFS path n={N_TEXT}: fmindex_build -k 32 wrote .meta full_sa "
        f"false; -b on it and on the full-sort archive without .meta give "
        f"occ {occ} and checksum {checksum} (the oracle's); -q "
        f"{bfs_pattern} found {found32}, positions equal the per-row walk; "
        f"batch_query of {CLI_CHUNK} patterns ({int(lf.sum())} positions) "
        f"equal per query; launches {bfs_launches}")
    del fmi32, b32, e32

    # ---- 8. the probe path, then the probes against their plain versions
    launches.update(phase_probe_path(torch, kernels))
    ms, plain_ms, library_ms, bounds = {}, {}, {}, {}
    phase_probes(torch, smi, err, ms, plain_ms, library_ms, bounds)

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
    w5 = seed_sort_words(text_dev)
    ms["radix_sort_words"] = cuda_ms(lambda: radix_sort_words(w5), 5)
    plain_ms["radix_sort_words"] = cuda_ms(
        lambda: radix_sort_words_plain(w5), 3
    )
    # K1 bound: the W key words read and written once, the permutation
    # written (8 bytes a key); one digit step per key byte
    bounds["radix_sort_words"] = bound_ms(
        2 * w5.numel() * 4 + 8 * w5.shape[1], w5.numel() * 4
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
    # K2 and K3 bounds count what this run's data needs: the LF steps the
    # queries really take (early stop) and the walk steps the rows really
    # take (a row at text position p walks p % sa_intv steps), one 20-byte
    # lf_tab row per step and bound, one 12-byte b_tab row per mark probe,
    # 8 bytes per sa_samp read -- but no table counted beyond its size,
    # since each input byte counts once
    def table_bytes(lf_rows, b_rows, samp_reads):
        return (min(arrays.lf_tab.numel() * 4, lf_rows * 20)
                + min(arrays.b_tab.numel() * 4, b_rows * 12)
                + min(arrays.sa_samp.numel() * 8, samp_reads * 8))

    lf_steps = int(((QLEN - L if L and QLEN >= L else QLEN) - offs).sum())
    bounds["fm_backward_search"] = bound_ms(
        qw.numel() * 4 + 24 * N_QUERIES + table_bytes(2 * lf_steps, 0, 0),
        2 * lf_steps * 16,  # about 16 integer operations per LF
    )
    for name, pos, io_bytes in (
        ("fm_locate_stats", fm.bfs_locate_device(arrays, beg, end, 4),
         16 * N_QUERIES + 8),
        ("fm_locate_rows", fm.locate_rows_device(arrays, rows, 4),
         16 * rows.shape[0]),
    ):
        walk = int((pos % 4).sum())
        bounds[name] = bound_ms(
            io_bytes + table_bytes(walk, walk + pos.shape[0], pos.shape[0]),
            walk * 16 + pos.shape[0] * 8,
        )
    for name in bounds:
        library_ms.setdefault(name, None)  # K1-K3: no one PyTorch call
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
        + f"; range BFS stats (plain PyTorch ops) of the 1M ranges "
        f"{bfs_ms / 1e3:.4f} and of one {CLI_CHUNK}-query chunk "
        f"{bfs_chunk_ms / 1e3:.4f}, beside K3 stats")

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
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
