"""chm13-scale end-to-end run of the port on one card: the out-of-core
suffix sort, the row-blocked index build, counts, stats and a planted
locate, and the ``.fmi`` archive, at n = 3,117,292,070 (the reference's
headline corpus size, reference: README.md:94-101) or at the largest n the
host holds. The port of ``experiments/chm13_full.py``: the same stages,
seeds and checks.

    python -m kiss_tpu_torch.experiments.chm13_full [--workdir DIR] [-n N]

Stages (each timed, with the peak host RSS and the stage's peak CUDA
bytes):
  - a synthetic genome (``utils.synth.synth_genome``, seed 0) with a
    25-mer planted at five known positions;
  - the out-of-core sort at k = 256 (``ops.external_sort``: buckets and
    rounds on the host, each batch of at most 2**26 rows sorted by kernel
    K1 on the card);
  - checks of the SA: a permutation of 0..n (bitmap), and the whole
    ordering contract on 2,000,000 sampled adjacent pairs;
  - an independent numpy oracle of the counts and position sums of
    200,000 25-mers (sampled from the text, the planted one first): the
    SA's 25-character keys searched, short suffixes corrected; its own
    code, none of the port's;
  - on the card: the row-blocked build (``FMIndex.build_rows``: the text
    on the card, the SA uploaded a block at a time), ``counts`` (kernel
    K2), ``batch_query_stats`` (kernel K4's stats; the index comes from a
    k-ordered SA, so locate takes the range BFS), the planted pattern's
    positions (K4's locate), each equal to the oracle's; K2 and K4 timed
    at this index beside their bounds and held against their plain
    versions;
  - the ``.fmi`` saved, reloaded and re-queried;
  - the in-core seed sort at n = 2**31 + 4096, k = 16 (JAX's
    ``_pos_dtype`` switch): on the card when the bytes a character it
    takes there (measured on a 2**22-character prefix) fit the card's free
    memory, else on the CPU device when they fit the host's, else skipped,
    with the reckoning printed either way;
  - ``_compact_rows`` at N = 2**31 + 2**17 flags on the card, against
    numpy's ``flatnonzero``.

Host memory: the out-of-core sorter keeps about 36 bytes a character on
the host beside a few GB (``HOST_BYTES_PER_CHAR``), the oracle about 17.
Before anything runs, n is cut to 0.9 MemAvailable / HOST_BYTES_PER_CHAR
when the host cannot hold it, and the cut is printed and recorded.

Stages checkpoint the text and the SA to ``--workdir`` (``text.bin``,
``sa.bin``): a run cut short resumes from them. The stage table, with the
card's name and power limit, is printed and appended to ``--results``
(``results_chm13_full.md`` beside this file); the last line is one JSON
object with the same numbers.

``--device cpu -n 200000`` (with small ``--incore-n``, ``--compact-n``
and ``--pairs``) rehearses the control flow on the CPU, the kernels' plain
versions in their place.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

from kiss_tpu_torch import cli, kernels
from kiss_tpu_torch.experiments import fm_query_time as fqt
from kiss_tpu_torch.experiments.external_scale import host_memory
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import external_sort, suffix_sort
from kiss_tpu_torch.utils.device import resolve_device
from kiss_tpu_torch.utils.synth import synth_genome

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results_chm13_full.md")
N_CHM13 = 3_117_292_070
K = 256
QLEN = 25
NQ = 200_000
SA_INTV = 4
INCORE_N = 2**31 + 4096
INCORE_K = 16
INCORE_PROBE = 1 << 22  # characters of the sort that measures its bytes
COMPACT_N = 2**31 + (1 << 17)
PAIRS = 2_000_000  # adjacent SA rows the ordering check samples
# the host's bytes a character: the out-of-core sorter's peak RSS fitted
# over two runs on the card's host (45.3 bytes a character in all at n =
# 487.8M by external_scale.py, 8.2 GB at n = 100M by this script) is about
# 4.6 GB and 35.8 bytes a character; 40 leaves a margin, of MEM_FRACTION
# of the available memory. The oracle and the build need less.
HOST_BYTES_PER_CHAR = 40
MEM_FRACTION = 0.9  # of free memory a reckoned run may plan to take
_CHUNK = 1 << 27


def plant_positions(n: int) -> list[int]:
    return [int(f * n) for f in (0.0001, 0.31, 0.62, 0.75, 0.962)]


class Stages:
    """Stage timer: seconds, peak host RSS and the stage's peak CUDA
    bytes of each stage, in order (``with stages("name"): ...``)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.rows: list[tuple[str, float, float, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        print(f"[chm13] {name} ...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        dt = time.perf_counter() - t0
        self.rows.append((name, dt, rss_gb(), peak))
        print(f"[chm13] {name}: {dt:.1f} s, peak RSS {rss_gb():.1f} GB, peak "
              f"CUDA {peak / 1e9:.2f} GB", file=sys.stderr, flush=True)

    def peak_cuda(self) -> int:
        return max((r[3] for r in self.rows), default=0)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def card_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def planted_pattern() -> np.ndarray:
    rng = np.random.default_rng(424242)
    return rng.integers(0, 4, QLEN).astype(np.int8)


def synth(n: int, workdir: str, stage) -> np.ndarray:
    path = os.path.join(workdir, "text.bin")
    if os.path.exists(path) and os.path.getsize(path) == n:
        with stage("load text checkpoint"):
            return np.fromfile(path, dtype=np.int8)
    with stage("synthesize genome"):
        text = synth_genome(n, seed=0)
        pat = planted_pattern()
        for p in plant_positions(n):
            text[p : p + QLEN] = pat
        text.tofile(path)
    return text


def run_sort(text: np.ndarray, workdir: str, dev, stage,
             split: dict) -> np.ndarray:
    path = os.path.join(workdir, "sa.bin")
    if os.path.exists(path) and os.path.getsize(path) == 4 * (len(text) + 1):
        with stage("load SA checkpoint"):
            return np.fromfile(path, dtype=np.uint32)
    with stage(f"suffix_sort k={K} (out-of-core, K1 batches)"):
        sa = external_sort.external_k_ordered_suffix_array(
            text, K, batch_rows=1 << 26, bucket_chars=8, verbose=True,
            device=dev, split=split,
        )
    with stage("checkpoint SA"):
        sa.tofile(path)
    return sa


def check_permutation(sa: np.ndarray, n: int, stage) -> None:
    with stage("check: SA is a permutation"):
        seen = np.zeros(n + 1, dtype=bool)
        for lo in range(0, n + 1, _CHUNK):
            seen[sa[lo : lo + _CHUNK]] = True
        for lo in range(0, n + 1, _CHUNK):
            assert seen[lo : lo + _CHUNK].all(), "SA misses some position"
        del seen
        gc.collect()


def check_order(text: np.ndarray, sa: np.ndarray, k: int, stage,
                samples: int, seed: int = 5) -> None:
    """The whole ordering contract on sampled adjacent pairs: k-character
    windows over the -1-padded text (the end of the text sorts smallest),
    ties in ascending position."""
    with stage(f"check: ordering contract ({samples} pairs, k={k})"):
        n = len(text)
        rng = np.random.default_rng(seed)
        i = rng.integers(1, n + 1, samples)
        pad = np.full(n + k, -1, dtype=np.int8)
        pad[:n] = text
        a = sa[i - 1].astype(np.int64)
        b = sa[i].astype(np.int64)
        wa = pad[a[:, None] + np.arange(k)[None, :]]
        wb = pad[b[:, None] + np.arange(k)[None, :]]
        del pad
        neq = wa != wb
        first = np.argmax(neq, axis=1)
        r = np.arange(samples)
        ok = np.where(neq.any(axis=1), wa[r, first] < wb[r, first], a < b)
        bad = np.flatnonzero(~ok)
        assert bad.size == 0, (
            f"{bad.size} misordered pairs, first at row {i[bad[0]]}")


def window_words(text: np.ndarray, total: int) -> np.ndarray:
    """uint32[total]: entry p packs characters [p, p + 16) of the text,
    zero-padded, big-endian, 2 bits each: words of 16-character blocks,
    then each offset r of a block by two shifts."""
    n = len(text)
    nb = -(-total // 16) + 1
    vals = np.zeros(16 * (nb + 1), dtype=np.uint32)
    vals[:n] = text.view(np.uint8)
    blocks = np.zeros(nb + 1, dtype=np.uint32)
    for j in range(16):
        blocks[:nb] |= vals[j : j + 16 * nb : 16] << np.uint32(2 * (15 - j))
    del vals
    out = np.empty(16 * nb, dtype=np.uint32)
    out[0::16] = blocks[:nb]
    for r in range(1, 16):
        out[r::16] = (blocks[:nb] << np.uint32(2 * r)) | (
            blocks[1 : nb + 1] >> np.uint32(32 - 2 * r))
    return out[:total]


def oracle_counts_sums(text: np.ndarray, sa: np.ndarray, pats: np.ndarray,
                       stage):
    """Independent oracle: each pattern's count and sum of positions by a
    binary search of the 50-bit (25-character) keys along the SA, less
    the suffixes shorter than a pattern whose zero-padded key collides
    with it. Returns (counts int64, sums uint64, the planted pattern's
    sorted positions)."""
    n = len(text)
    N = n + 1
    mask = np.uint32(0xFFFFC000)  # characters 16..24 of the window
    with stage("oracle: build sorted 25-char keys"):
        w = window_words(text, N + 16)
        key = np.empty(N, dtype=np.uint64)
        for lo in range(0, N, _CHUNK):
            s = sa[lo : lo + _CHUNK].astype(np.int64)
            hi32 = w[s].astype(np.uint64)
            lo32 = (w[s + 16] & mask).astype(np.uint64)
            key[lo : lo + _CHUNK] = (hi32 << np.uint64(32)) | lo32
            del s, hi32, lo32
    with stage("oracle: key monotonicity check"):
        for lo in range(0, N - 1, _CHUNK):
            seg = key[lo : lo + _CHUNK + 1]
            assert (seg[1:] >= seg[:-1]).all(), "oracle keys unsorted"
    with stage("oracle: pattern counts + position sums"):
        shifts = np.uint64(62) - np.uint64(2) * np.arange(QLEN,
                                                           dtype=np.uint64)
        pk = (pats.astype(np.uint64) << shifts[None, :]).sum(
            axis=1, dtype=np.uint64)
        # an inclusive upper bound: no uint64 wrap for all-T prefixes
        tail = (np.uint64(1) << np.uint64(64 - 2 * QLEN)) - np.uint64(1)
        lo_i = np.searchsorted(key, pk, side="left")
        hi_i = np.searchsorted(key, pk | tail, side="right")
        del key
        counts = (hi_i - lo_i).astype(np.int64)
        starts = np.cumsum(counts) - counts
        rows = np.repeat(lo_i - starts, counts) + np.arange(counts.sum())
        pos = sa[rows].astype(np.uint64)
        sums = np.zeros(len(pats), dtype=np.uint64)
        hit = counts > 0
        if hit.any():
            sums[hit] = np.add.reduceat(pos, starts[hit])
        p0 = sa[lo_i[0] : hi_i[0]]
        planted = np.sort(p0[p0 <= np.uint32(n - QLEN)])
        for p in range(max(0, n - QLEN + 1), n + 1):
            kk = (np.uint64(w[p]) << np.uint64(32)) | np.uint64(
                w[p + 16] & mask)
            m = pk == kk
            counts[m] -= 1
            sums[m] -= np.uint64(p)
        del w
        gc.collect()
    return counts, sums, planted


def query_times(fmi, pats: np.ndarray, dev, say) -> dict:
    """K2 (counts) and K4 (stats) at this index on the batch: the time of
    each entry point over prepared inputs (CUDA events on a card, the
    host's clock on the CPU), its bound, and its plain version's time and
    output, which must equal the kernel's."""
    arrays, blocks = fmi.arrays, fmi.blocks
    qw = fm._packed_queries(pats, dev)
    reps = 10 if dev.type == "cuda" else 1
    out = {}
    ranges = fm.get_range_packed_device(arrays, qw, QLEN, 0, blocks=blocks)
    plain = fm.get_range_packed_device_plain(arrays, qw, QLEN, 0)
    for got, want in zip(ranges, plain):
        assert torch.equal(got, want), "K2 disagrees with its plain version"
    steps = fqt.k2_sectors(arrays, qw, QLEN)[0]
    out["fm_backward_search"] = {
        "ms": fqt.time_ms(lambda: fm.get_range_packed_device(
            arrays, qw, QLEN, 0, blocks=blocks), reps, dev),
        "plain_ms": fqt.time_ms(lambda: fm.get_range_packed_device_plain(
            arrays, qw, QLEN, 0), 1, dev),
        "bound": fqt.k2_bound(fmi, len(pats), qw.numel(), steps),
        "lf_steps": steps,
    }
    beg, end, _ = ranges
    got = fm.batch_bfs_stats_device(arrays, beg, end, SA_INTV, blocks=blocks)
    want = fm.batch_bfs_stats_device_plain(arrays, beg, end, SA_INTV)
    assert got == want, f"K4 stats {got} != plain {want}"
    work = fqt.bfs_work(arrays, beg, end, SA_INTV)
    out["fm_bfs_stats"] = {
        "ms": fqt.time_ms(lambda: fm.batch_bfs_stats_device(
            arrays, beg, end, SA_INTV, blocks=blocks), reps, dev),
        "plain_ms": fqt.time_ms(lambda: fm.batch_bfs_stats_device_plain(
            arrays, beg, end, SA_INTV), 1, dev),
        "bound": fqt.k4_bound(fmi, len(pats), work, True),
        "positions": work.positions,
    }
    for name, v in out.items():
        say(f"{name} at the index of {fmi.n_rows} rows, {len(pats)} x "
            f"{QLEN}: {v['ms']:.4f} ms (plain {v['plain_ms']:.3f}), bound "
            f"{v['bound'][0]:.4f} ({v['bound'][1]}), output equal to the "
            f"plain version's")
    return out


def incore_seed_sort(args, dev, workdir: str, stage, say) -> dict:
    """The in-core sort at n = ``--incore-n``, k = 16, where it fits: its
    bytes a character measured on a prefix on the card (on a CPU-only run,
    the CLI's IN_CORE_BYTES_PER_CHAR), then the card, the CPU device or a
    skip, with the reckoning. Returns what was decided and why."""
    m = args.incore_n
    path = os.path.join(workdir, "text.bin")
    head = np.fromfile(path, dtype=np.int8, count=min(m, INCORE_PROBE))
    if dev.type == "cuda":
        probe = torch.from_numpy(head).to(dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        suffix_sort.k_ordered_suffix_array(probe, INCORE_K, as_numpy=False,
                                           device=dev)
        per_char = (torch.cuda.max_memory_allocated() - base) / len(probe)
        del probe
        torch.cuda.empty_cache()
        source = f"measured on a {len(head)}-char prefix on the card"
        card_free = torch.cuda.mem_get_info()[0]
    else:
        per_char = float(cli.IN_CORE_BYTES_PER_CHAR)
        source = "cli.IN_CORE_BYTES_PER_CHAR (no card to measure on)"
        card_free = 0
    need = int(per_char * m)
    host_free = host_memory()["MemAvailable"]
    reckoning = (f"n = {m}, k = {INCORE_K}: {per_char:.1f} bytes a char "
                 f"({source}) -> {need / 1e9:.1f} GB; card free "
                 f"{card_free / 1e9:.1f} GB, host available "
                 f"{host_free / 1e9:.1f} GB (a run may plan "
                 f"{MEM_FRACTION:.0%} of either)")
    if dev.type == "cuda" and need <= MEM_FRACTION * card_free:
        where = dev
    elif need <= MEM_FRACTION * host_free:
        where = torch.device("cpu")
    else:
        say(f"in-core seed sort skipped: {reckoning}")
        return {"ran_on": None, "reckoning": reckoning}
    say(f"in-core seed sort on {where}: {reckoning}")
    sub = (np.fromfile(path, dtype=np.int8, count=m)
           if os.path.getsize(path) >= m else synth_genome(m, seed=0))
    with stage(f"in-core seed sort at n={m}, k={INCORE_K}, on {where}"):
        sa = suffix_sort.k_ordered_suffix_array(sub, INCORE_K, device=where)
        assert sa.dtype == np.uint32
    check_order(sub, sa, INCORE_K, stage, samples=args.pairs // 2, seed=11)
    check_permutation(sa, m, stage)
    del sa, sub
    gc.collect()
    return {"ran_on": str(where), "reckoning": reckoning}


def compact_rows_check(n_flags: int, dev, stage) -> None:
    """``_compact_rows`` of ``n_flags`` flags on ``dev`` against numpy's
    flatnonzero (row ids past 2**31 included at the full size)."""
    with stage(f"_compact_rows of {n_flags} flags"):
        rows = np.unique(np.random.default_rng(3).integers(
            0, n_flags, 3000).astype(np.int64))
        rows[-1] = n_flags - 1  # the last row, past 2**31 at full size
        rows = np.unique(rows)
        act = torch.zeros(n_flags, dtype=torch.bool, device=dev)
        act[torch.from_numpy(rows).to(dev)] = True
        got = suffix_sort._compact_rows(act, 4096).cpu().numpy()
        assert np.array_equal(got[: rows.size], rows), "_compact_rows ids"
        assert not got[rows.size :].any(), "_compact_rows fill"
        del act


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(ROOT, "chm13_work"))
    ap.add_argument("-n", type=int, default=N_CHM13)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-incore", action="store_true")
    ap.add_argument("--incore-n", type=int, default=INCORE_N)
    ap.add_argument("--compact-n", type=int, default=COMPACT_N)
    ap.add_argument("--pairs", type=int, default=PAIRS,
                    help="adjacent SA rows the ordering check samples")
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    card = card_line(dev)

    def say(msg):
        print(msg, flush=True)

    say(card)
    stage = Stages(dev)
    mem = host_memory()
    fits = int(MEM_FRACTION * mem["MemAvailable"]) // HOST_BYTES_PER_CHAR
    n, cut = args.n, None
    if n > fits:
        cut = (f"n cut from {n} to {fits}: the host has {mem['MemAvailable']} "
               f"bytes available, a run may plan {MEM_FRACTION:.0%} of them, "
               f"and it needs about {HOST_BYTES_PER_CHAR} a character")
        n = fits
    say(f"host memory: total {mem['MemTotal']}, available "
        f"{mem['MemAvailable']} bytes; n = {n}" + (f" ({cut})" if cut else ""))

    text = synth(n, args.workdir, stage)
    pat = planted_pattern()
    split: dict = {}
    sa = run_sort(text, args.workdir, dev, stage, split)
    if split:
        say("out-of-core stage split (s): " + json.dumps(split))
    check_permutation(sa, n, stage)
    check_order(text, sa, K, stage, samples=args.pairs)

    # sampled patterns (mostly hits), the planted one first
    nq = min(NQ, max(1000, n // 1000))
    starts = np.random.default_rng(7).integers(0, n - QLEN, nq - 1)
    pats = np.empty((nq, QLEN), dtype=np.int8)
    pats[0] = pat
    pats[1:] = text[starts[:, None] + np.arange(QLEN)[None, :]]

    want_counts, want_sums, planted_set = oracle_counts_sums(text, sa, pats,
                                                             stage)
    planted_expected = np.sort(np.array(plant_positions(n), dtype=np.uint64))
    assert want_counts[0] >= len(planted_expected)
    assert set(planted_expected.tolist()) <= set(
        planted_set.astype(np.uint64).tolist())
    want_occ = int(want_counts.sum())
    want_chk = int(want_sums.sum(dtype=np.uint64))

    # ---- the index and the queries, on the card
    kernels.reset_launch_counts()
    with stage(f"FM build (build_rows, blocks of {fm.BUILD_BLOCK_ROWS} "
               "rows)"):
        fmi = fm.FMIndex(sa_intv=SA_INTV, lookup_len=0, device=dev)
        fmi.build_rows(text, sa, full_sa=False)
    del sa
    gc.collect()
    with stage(f"FM counts ({nq} x len-{QLEN}, K2)"):
        got_counts = fmi.counts(pats).astype(np.int64)
    assert np.array_equal(got_counts, want_counts), (
        f"count mismatch: {np.sum(got_counts != want_counts)} of {nq}")
    with stage(f"FM stats (count + locate + checksum, {nq} patterns, K4)"):
        occ, checksum = fmi.batch_query_stats(pats)
    assert (occ, checksum) == (want_occ, want_chk), (
        (occ, checksum), (want_occ, want_chk))
    with stage("FM locate planted pattern (K4 locate)"):
        beg, end, offs = fmi.get_range(pat)
        assert offs == 0 and end - beg == want_counts[0]
        pos = np.sort(fmi.get_offsets(beg, end).astype(np.uint64))
    assert np.array_equal(pos, planted_set.astype(np.uint64)), (
        "planted positions differ from the oracle's")
    launches = {name: kernels.LAUNCHES[name] for name in
                ("fm_backward_search", "fm_bfs_stats", "fm_bfs_locate")}
    if dev.type == "cuda":
        assert all(launches.values()), f"a kernel was not launched: {launches}"
    times = query_times(fmi, pats, dev, say)

    fmi_path = os.path.join(args.workdir, "chm13.fmi")
    with stage("save .fmi archive"):
        with open(fmi_path, "wb") as f:
            fmi.save(f)
    fmi_bytes = os.path.getsize(fmi_path)
    cnt = fmi.arrays.cnt.cpu()
    del fmi
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with stage("reload .fmi and re-query"):
        fmi2 = fm.FMIndex(sa_intv=SA_INTV, device=dev)
        with open(fmi_path, "rb") as f:
            fmi2.load(f)
        assert fmi2.n_rows == n + 1
        assert torch.equal(fmi2.arrays.cnt.cpu(), cnt)
        c2 = fmi2.counts(pats[:1024]).astype(np.int64)
        assert np.array_equal(c2, want_counts[:1024])
    del fmi2
    os.remove(fmi_path)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    incore = {"ran_on": None, "reckoning": "skipped by --skip-incore"}
    if not args.skip_incore:
        incore = incore_seed_sort(args, dev, args.workdir, stage, say)
    compact_rows_check(args.compact_n, dev, stage)

    # ---- report
    peak_cuda = stage.peak_cuda()
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        assert peak_cuda <= total, "peak CUDA bytes beyond the card"
    table = ["| stage | seconds | peak RSS (GB) | stage peak CUDA (GB) |",
             "|---|---|---|---|"]
    table += [f"| {name} | {dt:.1f} | {rss:.1f} | {cuda / 1e9:.2f} |"
              for name, dt, rss, cuda in stage.rows]
    notes = [
        f"- card: {card}; host memory total {mem['MemTotal']}, available "
        f"{mem['MemAvailable']} bytes",
        f"- n = {n}" + (f" ({cut})" if cut else " (not cut)"),
        f"- queries: {nq} len-{QLEN}; occ={want_occ} checksum={want_chk} "
        f"(K2 counts, K4 stats == SA oracle, bit-exact)",
        f"- planted pattern found {int(want_counts[0])}x, at exactly the "
        f"oracle's positions (K4 locate), incl. all "
        f"{len(planted_expected)} planted sites",
        f"- .fmi archive: {fmi_bytes} bytes, reloaded + re-queried",
        f"- kernel launches {launches}; peak CUDA bytes {peak_cuda}",
        "- at this index, ms (plain ms; bound ms): " + "; ".join(
            f"{k} {v['ms']:.4f} ({v['plain_ms']:.3f}; {v['bound'][0]:.4f} "
            f"{v['bound'][1]})" for k, v in times.items()),
        f"- in-core seed sort: {incore['ran_on'] or 'skipped'}: "
        f"{incore['reckoning']}",
    ]
    say("\n".join(table + [""] + notes))
    with open(args.results, "a") as f:
        f.write(f"\n## Run {time.strftime('%Y-%m-%d %H:%M')} (n={n}, k={K}, "
                f"{card})\n\n" + "\n".join(table) + "\n\n"
                + "\n".join(notes) + "\n")
    say(json.dumps({
        "card": card, "n": n, "cut": cut, "k": K, "nq": nq,
        "stages": [{"name": name, "s": dt, "peak_rss_gb": rss,
                    "peak_cuda_bytes": cuda}
                   for name, dt, rss, cuda in stage.rows],
        "occ": want_occ, "checksum": want_chk, "fmi_bytes": fmi_bytes,
        "launches": launches, "peak_cuda_bytes": peak_cuda,
        "times": {k: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                      "bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                  for k, v in times.items()},
        "incore": incore, "split_s": split,
        "host_mem_total": mem["MemTotal"],
        "host_mem_available": mem["MemAvailable"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
