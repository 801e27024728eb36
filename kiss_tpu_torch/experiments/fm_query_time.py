"""K2 ``fm_backward_search`` and K3 ``fm_locate_stats`` / ``fm_locate_rows``
timed alone at the shapes the main path launches them, beside the 32-byte
sectors each table layout must read for this run's inputs; and K4
``fm_bfs_stats`` / ``fm_bfs_locate`` (the range BFS) at the same query
shapes over a 32-ordered index of the same text, the BFS route's: locate
also by pass (the walk, the expansion), the stats pass split into builds
without its ``samp_sum`` reads, with a visit that does nothing and as its
skeleton alone (``measure_bfs_split``), and ``nvcc -Xptxas -v`` of its
source (registers, stack frame and spills of each kernel, ``ptxas_report``).

Shapes, over the index of the 48,800,648-character synthetic genome
(``utils.synth``): one CLI chunk of ``fmindex_query -b`` (100,000 patterns
of length 25, the shape the main path launches ten times), the whole
1,000,000-pattern batch, the rows of the ``-q`` pattern (the batch's first)
and 1,000,000 random rows.

Each kernel is timed by CUDA events over ``REPS`` launches in a row, each
launch a direct call of the library's entry point with every input
prepared beforehand (outputs allocated, the range starts computed): no
Python wrapper runs and nothing is downloaded inside the window. K3 stats
is also timed as the CLI calls it, ``batch_locate_stats_device`` with its
download, by the host's clock, on a line of its own.

Sectors: the unique (query or row, step, 32-byte sector) reads of the
index tables that this run's LF steps and walk steps make, replayed with
the plain versions, for two layouts: ``lf_tab``/``b_tab`` (a 20-byte row
per 16 rows, a 12-byte row per 64) and the block table (one aligned
32-byte entry per 64 rows). The rate printed is the block table's
sectors, which the kernels read, over the kernel's time.

    python -m kiss_tpu_torch.experiments.fm_query_time [--device cuda]
        [--bfs-only]

``--device cpu --n 300000 --queries 20000 --chunk 5000`` rehearses the
control flow on the CPU (the plain versions, the host's clock).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from kiss_tpu_torch import kernels
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.utils.device import resolve_device
from kiss_tpu_torch.utils.roofline import bound_ms
from kiss_tpu_torch.utils.synth import sample_patterns, synth_genome

N_TEXT = 48_800_648
N_QUERIES = 1_000_000
CLI_CHUNK = 100_000
QLEN = 25
SA_INTV = 4
REPS = 100
K2_SECTORS_PER_S = 131e9  # K2's random 32-byte sectors from L2 (PERF.md §6)

# The K2 and K3 bounds count what this run's data needs: the LF steps the
# queries really take (early stop), the walk steps the rows really take and
# 8 bytes per sa_samp read. The index is counted in whichever of its two
# layouts needs fewer bytes for those steps, each capped at its own size,
# since each input byte counts once: lf_tab/b_tab (a 20-byte lf_tab row per
# LF, a 12-byte b_tab row per mark probe) or the block table (a 32-byte
# entry and an 8-byte superblock value per LF or probe).
def index_bytes(arrays, blocks, lfs: int, probes: int) -> int:
    """Least bytes of the index that ``lfs`` LF steps and ``probes`` mark
    probes read (an LF at a probed row shares its entry)."""
    split = (min(arrays.lf_tab.numel() * 4, lfs * 20)
             + min(arrays.b_tab.numel() * 4, probes * 12))
    reads = max(lfs, probes)
    table = (min(blocks.blk.numel() * 4, reads * 32)
             + min(blocks.sup.numel() * 8, reads * 8))
    return min(split, table)


def k2_bound(fmi, nq: int, qwords: int, lf_steps: int,
             lookup_reads: int = 0):
    """K2: packed queries in, three int64 outputs, the index the steps
    read and the ``lookup_reads`` lookup-table entries the seeded queries
    read (capped at the table's size); about 16 integer operations per
    LF."""
    return bound_ms(
        qwords * 4 + 24 * nq
        + index_bytes(fmi.arrays, fmi.blocks, 2 * lf_steps, 0)
        + min(fmi.arrays.lookup.numel(), lookup_reads) * 8,
        2 * lf_steps * 16,
    )


def k3_bound(fmi, io_bytes: int, walk: int, rows: int):
    """K3: ranges or rows in, result out; per walk step one LF, a mark
    probe per row visited, an sa_samp entry per row."""
    samp = min(fmi.arrays.sa_samp.numel() * 8, rows * 8)
    return bound_ms(
        io_bytes + samp
        + index_bytes(fmi.arrays, fmi.blocks, walk, walk + rows),
        walk * 16 + rows * 8,
    )


class BfsWork(NamedTuple):
    """What K4's pruned walk of a batch's trees visits and emits."""

    nodes: int  # non-empty nodes
    entries: int  # block-table entries they read: one a row, else two
    lfs: int  # LF steps: one for a row's child (none at the sentinel
    # row), four for each endpoint of a wider node above the last depth
    segments: int  # non-empty segments
    positions: int


def bfs_work(arrays, beg: torch.Tensor, end: torch.Tensor,
             sa_intv: int) -> BfsWork:
    """K4's work on the range BFS of [beg, end), counted with the plain
    version's level-by-level expansion (an empty node's descendants are
    empty, and K4 visits the rest)."""
    bs, es = beg[:, None], end[:, None]
    nodes = entries = lfs = segments = positions = 0
    for d in range(sa_intv):
        live = (bs < es).to(torch.int64)
        one = (es - bs == 1).to(torch.int64)
        mb, me = fm._b_rank(arrays, bs), fm._b_rank(arrays, es)
        nodes += int(live.sum())
        entries += int((2 * live - one).sum())
        if d + 1 < sa_intv:
            lfs += int((8 * (live - one) + one * (bs != arrays.pri)).sum())
            bs = fm._lf_all4(arrays, bs).reshape(bs.shape[0], -1)
            es = fm._lf_all4(arrays, es).reshape(es.shape[0], -1)
        segments += int((me > mb).sum())
        positions += int((me - mb).sum())
    return BfsWork(nodes, entries, lfs, segments, positions)


def k4_bound(fmi, nq: int, work: BfsWork, stats: bool):
    """K4: the ranges in (16 bytes a query); the block-table entries its
    walk reads (32 bytes each, capped at the table); the samples: 8 bytes
    of sa_samp a position, or for the stats, where fewer, two 8-byte
    samp_sum values a non-empty segment; the output (the positions, or the
    two integers). Operations: about 16 a mark rank (one an entry) and 16
    an LF."""
    samp = 8 * work.positions
    if stats:
        samp = min(samp, 16 * work.segments)
    out = 16 if stats else 8 * work.positions
    return bound_ms(
        16 * nq + min(fmi.blocks.blk.numel() * 4, 32 * work.entries) + samp
        + out,
        16 * (work.entries + work.lfs),
    )


# ---------------------------------------------------------------- sectors


def k2_sectors(arrays, qw: torch.Tensor, qlen: int):
    """(LF steps, lf_tab sectors, block-table sectors) of the backward
    search of ``qw`` from the full range (lookup 0, early stop), replayed
    with the plain LF. A step reads, for each bound x, the words
    ``5 (x >> 4) + c`` and ``5 (x >> 4) + 4`` of lf_tab, or the 32-byte
    entry ``x >> 6`` of the block table."""
    w = pack.as_u32(qw)
    nq = qw.shape[0]
    b = torch.zeros(nq, dtype=torch.int64, device=qw.device)
    e = arrays.lookup[-1].expand(nq).clone()
    steps = old = new = 0
    for j in range(qlen - 1, -1, -1):
        alive = e > b
        c = (w[:, j // 16] >> (2 * (j % 16))) & 3
        sec = torch.stack(
            [(20 * (x >> 4) + off) >> 5 for x in (b, e) for off in (4 * c, 16)],
            dim=1,
        ).sort(dim=1).values
        uniq = 1 + (sec[:, 1:] != sec[:, :-1]).sum(dim=1)
        old += int(uniq[alive].sum())
        new += int((1 + ((b >> 6) != (e >> 6)).to(torch.int64))[alive].sum())
        steps += int(alive.sum())
        nb, ne = fm._lf(arrays, c, b), fm._lf(arrays, c, e)
        b, e = torch.where(alive, nb, b), torch.where(alive, ne, e)
    return steps, old, new


def walk_sectors(arrays, rows: torch.Tensor, sa_intv: int):
    """(walk steps, lf_tab + b_tab sectors, block-table sectors) of the
    locate walk of ``rows``, each with one sa_samp sector a row. The old
    layout reads at a visited row the mark word of b_tab (and at the last
    visit b_tab's whole 12-byte row for the rank), and, to step, the BWT
    word and one count of lf_tab; the block table one entry a visit."""
    i = rows.to(torch.int64).clone()
    live = torch.ones_like(i, dtype=torch.bool)
    steps = old = new = 0
    for k in range(sa_intv):
        last = fm._b_at(arrays, i) | (k == sa_intv - 1)
        r0, r2 = (12 * (i >> 6)) >> 5, (12 * (i >> 6) + 8) >> 5
        b_uni = torch.where(last, 1 + (r0 != r2).to(torch.int64), 1)
        c = fm._bwt_at(arrays, i)
        l4, lc = (20 * (i >> 4) + 16) >> 5, (20 * (i >> 4) + 4 * c) >> 5
        lf_uni = torch.where(last, 0, 1 + (l4 != lc).to(torch.int64))
        old += int((b_uni + lf_uni)[live].sum())
        new += int(live.sum())
        step = live & ~last
        steps += int(step.sum())
        i = torch.where(step, fm._lf_own_symbol(arrays, i), i)
        live = step
    n = rows.numel()
    return steps, old + n, new + n


def range_rows(beg: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """The rows of the ranges [beg, end), query after query."""
    lens = end - beg
    total = int(lens.sum())
    starts = torch.cumsum(lens, dim=0) - lens
    base = torch.repeat_interleave(beg - starts, lens, output_size=total)
    return base + torch.arange(total, dtype=torch.int64, device=beg.device)


# ---------------------------------------------------------------- timing


def time_ms(fn, reps: int, dev: torch.device) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    by CUDA events on the card and by the host's clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` by the host's clock (``fn`` ends in a
    download, so no synchronize is needed)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


SAMPLES_LINE = ("the same rows' sa_samp entries gathered by one PyTorch call "
                "(sa_samp[idx]: also reads idx, writes its output)")


def sample_index(arrays, rows: torch.Tensor, sa_intv: int) -> torch.Tensor:
    """The sa_samp entry that the locate walk of each row reads: a walked
    row stays once marked, so sa_intv - 1 masked steps reach them all."""
    i = rows.clone()
    for _ in range(sa_intv - 1):
        i = torch.where(fm._b_at(arrays, i), i, fm._lf_own_symbol(arrays, i))
    return fm._b_rank(arrays, i)


def samples_ms(arrays, rows: torch.Tensor, reps: int) -> float:
    """Milliseconds of ``sa_samp[idx]`` for the entries that the locate
    walk of ``rows`` reads (one random read a row): the part of K3's work
    that no layout of the index tables changes."""
    sample = sample_index(arrays, rows, SA_INTV)
    return time_ms(lambda: arrays.sa_samp[sample], reps, rows.device)


def _entry_points(fmi, dev):
    """Launchers of K2 / K3 on prepared inputs: ``k2(qw)``,
    ``k3_rows(rows)`` and ``k3_stats(beg, end)`` each return (launch,
    result): ``launch()`` runs the kernel, ``result()`` reads its last
    output in the plain version's form. On the CPU they call the wrappers
    (the plain versions)."""
    a, blocks = fmi.arrays, fmi.blocks
    if dev.type != "cuda":
        def wrapped(fn, *args):
            last = [None]

            def launch():
                last[0] = fn(a, *args, blocks=blocks)

            return launch, lambda: last[0]

        return (
            lambda qw: wrapped(fm.get_range_packed_device, qw, QLEN, 0),
            lambda rows: wrapped(fm.locate_rows_device, rows, SA_INTV),
            lambda beg, end: wrapped(fm.batch_locate_stats_device, beg, end,
                                     SA_INTV),
        )
    lib = kernels.library()
    stream = kernels.stream_of(dev)
    tabs = (blocks.blk.data_ptr(), blocks.sup.data_ptr(), a.pri.data_ptr())

    def checked(name, fn):
        kernels.check(fn(), name)
        return fn

    def k2(qw):
        outs = [torch.empty(qw.shape[0], dtype=torch.int64, device=dev)
                for _ in range(3)]
        args = (*tabs, a.lookup.data_ptr(), a.lookup.shape[0], qw.data_ptr(),
                qw.shape[0], qw.shape[1], QLEN, 0, 1,
                *(o.data_ptr() for o in outs), stream)
        return (checked("kt_fm_backward_search",
                        lambda: lib.kt_fm_backward_search(*args)),
                lambda: tuple(outs))

    def k3_rows(rows):
        out = torch.empty_like(rows)
        args = (*tabs, a.sa_samp.data_ptr(), SA_INTV, rows.data_ptr(),
                rows.shape[0], out.data_ptr(), stream)
        return (checked("kt_fm_locate_rows",
                        lambda: lib.kt_fm_locate_rows(*args)),
                lambda: out)

    def k3_stats(beg, end):
        incl = torch.cumsum(end - beg, dim=0)
        out = torch.empty(2, dtype=torch.int64, device=dev)
        args = (*tabs, a.sa_samp.data_ptr(), SA_INTV, beg.data_ptr(),
                incl.data_ptr(), beg.shape[0], out.data_ptr(), stream)
        keep = (incl, out)  # alive as long as the launchers
        return (checked("kt_fm_locate_stats",
                        lambda: lib.kt_fm_locate_stats(*args)),
                lambda: tuple(keep[1].tolist()))

    return k2, k3_rows, k3_stats


def _exact(got, want, what: str) -> None:
    """Raise unless the kernel's output equals the plain version's."""
    if isinstance(want, torch.Tensor):
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        same = torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w
        if not same:
            raise RuntimeError(f"{what}: kernel disagrees with its plain "
                               "version")


def measure(fmi, qw: torch.Tensor, q_rows: torch.Tensor,
            rand_rows: torch.Tensor, chunk: int, smi: str, say=print,
            reps: int = REPS):
    """Time K2 and K3 at their shapes, hold each output to the plain
    version's (exact), count sectors, print one line per kernel and shape
    and one for the wrapper; return {(kernel, shape): dict}."""
    dev = qw.device
    a = fmi.arrays
    k2, k3_rows, k3_stats = _entry_points(fmi, dev)
    out = {}
    shapes = {f"chunk {chunk}": qw[:chunk], f"batch {qw.shape[0]}": qw}
    for shape, q in shapes.items():
        nq = q.shape[0]
        beg, end, offs = fm.get_range_packed_device_plain(a, q, QLEN, 0)
        launch, result = k2(q)
        ms = time_ms(launch, reps, dev)
        _exact(result(), (beg, end, offs), f"K2 {shape}")
        steps, old, new = k2_sectors(a, q, QLEN)
        if steps != int((QLEN - offs).sum()):
            raise RuntimeError("K2 sector replay disagrees with the plain "
                               "version's steps")
        bound = k2_bound(fmi, nq, q.numel(), steps)
        out[("fm_backward_search", shape)] = dict(
            ms=ms, bound=bound, steps=steps, sectors_lf_tab=old,
            sectors_blocks=new)
        say(f"K2 {shape} x {QLEN} on {smi}: kernel alone {ms:.4f} "
            f"ms over {reps} launches; {steps} LF steps; sectors lf_tab/b_tab "
            f"{old} ({old / max(steps, 1):.3f} a step), block table {new} "
            f"({new / max(steps, 1):.3f} a step); {new / ms / 1e6:.1f} G "
            f"sectors/s read; bound {bound[0]:.4f} ms ({bound[1]})")

        rows = range_rows(beg, end)
        launch, result = k3_stats(beg, end)
        ms = time_ms(launch, reps, dev)
        _exact(result(), fm.batch_locate_stats_device_plain(a, beg, end,
                                                            SA_INTV),
               f"K3 stats {shape}")
        wrapper = host_ms(lambda: fm.batch_locate_stats_device(
            a, beg, end, SA_INTV, blocks=fmi.blocks), reps)
        walk, old, new = walk_sectors(a, rows, SA_INTV)
        bound = k3_bound(fmi, 16 * nq + 8, walk, rows.numel())
        samples = samples_ms(a, rows, reps)
        out[("fm_locate_stats", shape)] = dict(
            ms=ms, wrapper_ms=wrapper, bound=bound, rows=rows.numel(),
            steps=walk, sectors_lf_tab=old, sectors_blocks=new,
            samples_ms=samples)
        say(f"K3 stats {shape} ranges ({rows.numel()} rows) on {smi}"
            f": kernel alone {ms:.4f} ms over {reps} launches; "
            f"{walk} walk steps; sectors lf_tab/b_tab {old}, block table "
            f"{new}; {new / ms / 1e6:.1f} G sectors/s read; bound "
            f"{bound[0]:.4f} ms ({bound[1]}); {SAMPLES_LINE} {samples:.4f} ms")
        say(f"K3 stats {shape} as the CLI calls it (batch_locate_stats_device"
            f", download included, host clock): {wrapper:.4f} ms a call")

    for shape, rows in ((f"-q rows {q_rows.numel()}", q_rows),
                        (f"random rows {rand_rows.numel()}", rand_rows)):
        launch, result = k3_rows(rows)
        ms = time_ms(launch, reps, dev)
        _exact(result(), fm.locate_rows_device_plain(a, rows, SA_INTV),
               f"K3 rows {shape}")
        walk, old, new = walk_sectors(a, rows, SA_INTV)
        bound = k3_bound(fmi, 16 * rows.numel(), walk, rows.numel())
        samples = samples_ms(a, rows, reps)
        out[("fm_locate_rows", shape)] = dict(
            ms=ms, bound=bound, rows=rows.numel(), steps=walk,
            sectors_lf_tab=old, sectors_blocks=new, samples_ms=samples)
        say(f"K3 rows {shape} on {smi}: kernel alone {ms:.4f} ms "
            f"over {reps} launches; {walk} walk steps; sectors lf_tab/b_tab "
            f"{old}, block table {new}; {new / ms / 1e6:.2f} G sectors/s "
            f"read; bound {bound[0]:.6f} ms ({bound[1]}); {SAMPLES_LINE} "
            f"{samples:.4f} ms")
    return out


def _bfs_entry_points(fmi, dev):
    """Launchers of K4 on prepared inputs: ``stats(beg, end)`` and
    ``locate(beg, end)`` each return (launch, result) as
    :func:`_entry_points`'s, and ``locate``'s also its passes, {name:
    launch}. Their buffers are sized by one earlier run (as the wrappers
    size them), so the locate launch runs the walk and the expansion with
    no read of the sizes in the window. On the CPU they call the wrappers
    (the plain versions), and locate has no passes."""
    a, blocks = fmi.arrays, fmi.blocks
    if dev.type != "cuda":
        def wrapped(fn, beg, end):
            last = [None]

            def launch():
                last[0] = fn(a, beg, end, SA_INTV, blocks=blocks)

            return launch, lambda: last[0]

        return (lambda beg, end: wrapped(fm.batch_bfs_stats_device, beg, end),
                lambda beg, end: (*wrapped(fm.bfs_locate_device, beg, end),
                                  {}))
    lib = kernels.library()
    stream = kernels.stream_of(dev)
    tabs = (blocks.blk.data_ptr(), blocks.sup.data_ptr(), a.pri.data_ptr())

    def pool_of(nodes):
        return torch.empty(fm._BFS_NODE_BYTES * nodes, dtype=torch.uint8,
                           device=dev)

    def stats(beg, end):
        out = torch.empty(4, dtype=torch.int64, device=dev)
        keep = {}

        def run(_, pool_cap):
            keep["pool"] = pool_of(pool_cap)
            keep["args"] = (*tabs, blocks.samp_sum.data_ptr(), SA_INTV,
                            beg.data_ptr(), end.data_ptr(), beg.shape[0],
                            keep["pool"].data_ptr(), pool_cap, out.data_ptr(),
                            stream)
            kernels.check(lib.kt_fm_bfs_stats(*keep["args"]),
                          "kt_fm_bfs_stats")
            keep["runs"] = keep.get("runs", 0) + 1
            keep["need"] = out[3].item()
            return None, 0, keep["need"]

        fm.bfs_until_it_fits(run, 0, fm.bfs_guess(beg.shape[0])[1])

        def launch():
            kernels.check(lib.kt_fm_bfs_stats(*keep["args"]),
                          "kt_fm_bfs_stats")

        launch.fit = (keep["need"], keep["runs"])

        return launch, lambda: tuple(out[:2].tolist())

    def locate(beg, end):
        q = beg.shape[0]
        scratch = torch.empty(5 + 5 * -(-q // fm.BFS_TILE),
                              dtype=torch.int64, device=dev)
        keep = {}

        def run(seg_cap, pool_cap):
            keep["pool"] = pool_of(pool_cap)
            keep["segs"] = torch.empty((2, seg_cap), dtype=torch.int64,
                                       device=dev)
            keep["args"] = (*tabs, SA_INTV, beg.data_ptr(), end.data_ptr(), q,
                            keep["pool"].data_ptr(), pool_cap,
                            keep["segs"][0].data_ptr(),
                            keep["segs"][1].data_ptr(), seg_cap,
                            scratch.data_ptr(), stream)
            kernels.check(lib.kt_fm_bfs_segments(*keep["args"]),
                          "kt_fm_bfs_segments")
            nseg, total, _, need = scratch[:4].tolist()
            keep["runs"] = keep.get("runs", 0) + 1
            keep["need"] = need
            return (nseg, total), nseg, need

        nseg, total = fm.bfs_until_it_fits(run, *fm.bfs_guess(q))
        out = torch.empty(total, dtype=torch.int64, device=dev)
        segs = keep["segs"]
        expand_args = (a.sa_samp.data_ptr(), segs[0].data_ptr(),
                       segs[1].data_ptr(), nseg, total, out.data_ptr(),
                       stream)

        def walk():
            kernels.check(lib.kt_fm_bfs_segments(*keep["args"]),
                          "kt_fm_bfs_segments")

        def expand():
            kernels.check(lib.kt_fm_bfs_expand(*expand_args),
                          "kt_fm_bfs_expand")

        def launch():
            walk()
            expand()

        launch.fit = (keep["need"], keep["runs"])
        return launch, lambda: out, {"walk": walk, "expansion": expand}

    return stats, locate


def measure_bfs(fmi, beg: torch.Tensor, end: torch.Tensor, chunk: int,
                smi: str, say=print, reps: int = REPS):
    """Time K4's stats and locate entry points at a CLI chunk of the ranges
    and at all of them, on prepared inputs (CUDA events), and as the CLI
    calls them (the wrappers, download included, host clock); locate also
    by pass (the walk, the expansion); hold each output to the plain
    version's (exact) and time the plain versions too. Prints one line a
    kernel and shape, with the block-table entries a second the walk reaches
    beside K2's sectors a second, and the queries on the spill route;
    returns {(kernel, shape): dict}."""
    dev = beg.device
    a = fmi.arrays
    stats, locate = _bfs_entry_points(fmi, dev)
    out = {}
    for shape, (b, e) in ((f"chunk {chunk}", (beg[:chunk], end[:chunk])),
                          (f"batch {beg.shape[0]}", (beg, end))):
        work = bfs_work(a, b, e, SA_INTV)
        for name, entry, plain, wrapper, is_stats in (
                ("fm_bfs_stats", stats, fm.batch_bfs_stats_device_plain,
                 fm.batch_bfs_stats_device, True),
                ("fm_bfs_locate", locate, fm.bfs_locate_device_plain,
                 fm.bfs_locate_device, False)):
            launch, result, *passes = entry(b, e)
            ms = time_ms(launch, reps, dev)
            want = plain(a, b, e, SA_INTV)
            _exact(result(), want, f"K4 {name} {shape}")
            pass_ms = {p: time_ms(fn, reps, dev)
                       for p, fn in (passes[0] if passes else {}).items()}
            plain_ms = time_ms(lambda: plain(a, b, e, SA_INTV), 3, dev)
            kernels.SPILLED[name] = 0
            wrapped = host_ms(lambda: wrapper(a, b, e, SA_INTV,
                                              blocks=fmi.blocks), reps)
            spilled = kernels.SPILLED[name] // (reps + 1)
            bound = k4_bound(fmi, b.shape[0], work, is_stats)
            out[(name, shape)] = dict(ms=ms, plain_ms=plain_ms,
                                      wrapper_ms=wrapped, bound=bound,
                                      work=work, passes=pass_ms,
                                      spilled=spilled)
            by_pass = "".join(f", {p} {t:.4f} ms" for p, t in pass_ms.items())
            fit = getattr(launch, "fit", None)
            if fit:
                out[(name, shape)]["pool_need"] = fit[0]
                by_pass += (f"; pool need {fit[0]} nodes (first given "
                            f"{fm.bfs_guess(b.shape[0])[1]}, {fit[1]} "
                            f"launch(es) to fit)")
            say(f"K4 {name} {shape} ranges on {smi}: kernel alone {ms:.4f} "
                f"ms over {reps} launches{by_pass}, as the CLI calls it (host "
                f"clock, download included) {wrapped:.4f} ms, plain version "
                f"{plain_ms:.4f} ms; {work.nodes} non-empty nodes, "
                f"{work.entries} entries read "
                f"({work.entries / (pass_ms.get('walk', ms) * 1e6):.1f} G/s; "
                f"K2 {K2_SECTORS_PER_S / 1e9:.0f} G sectors/s), {work.lfs} LF "
                f"steps, {work.segments} non-empty segments, {work.positions} "
                f"positions, {spilled} queries on the spill route; bound "
                f"{bound[0]:.4f} ms ({bound[1]})")
    return out


# ---------------------------------------------------------------- K4 split

SPLIT_MODES = ("full", "without the samp_sum reads",
               "a visit that does nothing",
               "the walk's skeleton (no table reads, one child a node)")


def measure_bfs_split(fmi, beg: torch.Tensor, end: torch.Tensor, chunk: int,
                      smi: str, say=print, reps: int = REPS):
    """K4's stats pass at a CLI chunk and at all the ranges, in builds of
    the same source (``kt_fm_bfs_stats_split``, which only this experiment
    calls; ``SPLIT_MODES``): as the kernel runs, without its samp_sum reads,
    with a visit that does nothing (the walk's reads and LF steps alone),
    and the walk's skeleton (its rounds with no table read). Prints one line
    a shape with the times and the block-table entries a second each
    reaches, beside K2's 131 G sectors a second; returns {shape: {mode:
    ms}}. Needs the card."""
    dev = beg.device
    a, blocks = fmi.arrays, fmi.blocks
    lib = kernels.library()
    stream = kernels.stream_of(dev)
    out = {}
    for shape, (b, e) in ((f"chunk {chunk}", (beg[:chunk], end[:chunk])),
                          (f"batch {beg.shape[0]}", (beg, end))):
        work = bfs_work(a, b, e, SA_INTV)
        res = torch.empty(4, dtype=torch.int64, device=dev)
        # nq + 2^16 pool nodes of 9 bytes, as the wrapper first gives
        pool = torch.empty(9 * (b.shape[0] + (1 << 16)), dtype=torch.uint8,
                           device=dev)
        times = {}
        for mode, name in enumerate(SPLIT_MODES):
            args = (mode, blocks.blk.data_ptr(), blocks.sup.data_ptr(),
                    a.pri.data_ptr(), blocks.samp_sum.data_ptr(), SA_INTV,
                    b.data_ptr(), e.data_ptr(), b.shape[0], pool.data_ptr(),
                    b.shape[0] + (1 << 16), res.data_ptr(), stream)

            def launch():
                kernels.check(lib.kt_fm_bfs_stats_split(*args),
                              "kt_fm_bfs_stats_split")

            times[name] = time_ms(launch, reps, dev)
            if res[3] > b.shape[0] + (1 << 16):
                raise RuntimeError("K4 split: the pool is too small")
            if mode == 0:
                _exact(tuple(res[:2].tolist()),
                       fm.batch_bfs_stats_device_plain(a, b, e, SA_INTV),
                       f"K4 split {shape}")
        out[shape] = times
        say(f"K4 stats split {shape} ranges on {smi}: "
            + "; ".join(f"{name} {ms:.4f} ms ({work.entries / ms / 1e6:.1f} "
                        f"G entries/s)" for name, ms in times.items())
            + f"; {work.entries} entries, {work.segments} samp_sum pairs; "
              f"K2 reads {K2_SECTORS_PER_S / 1e9:.0f} G sectors/s")
    return out


def parse_ptxas(text: str, demangle=None):
    """[(kernel, registers, stack frame, spill stores, spill loads)] of
    ``nvcc -Xptxas -v`` output, one a kernel (bytes); ``demangle`` maps the
    list of mangled names to readable ones."""
    rows, props = [], {}
    name = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            props[name] = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1))))
    names = [name for name, _ in rows]
    if demangle and names:
        names = demangle(names)
    return [
        (re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::|\(int\)", "",
                short).split("(")[0], regs, *props.get(name, (0, 0, 0)))
        for (name, regs), short in zip(rows, names)
    ]


def ptxas_report(source: str = "fm_bfs.cu", say=print):
    """:func:`parse_ptxas` of ``nvcc -Xptxas -v`` on one kernel source with
    the library's flags, printed one kernel a line."""
    run = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         os.path.join(kernels.CSRC, source), "-o", os.devnull],
        capture_output=True, text=True, check=True)
    filt = os.path.join(os.path.dirname(kernels._nvcc()), "cu++filt")

    def demangle(names):
        if not os.path.exists(filt):
            return names
        return subprocess.run([filt], input="\n".join(names),
                              capture_output=True, text=True,
                              check=True).stdout.split("\n")

    out = parse_ptxas(run.stdout + run.stderr, demangle)
    for short, regs, stack, st, ld in out:
        say(f"ptxas {source} {short}: {regs} registers, {stack} bytes stack "
            f"frame, {st} bytes spill stores, {ld} bytes spill loads")
    return out


def query_inputs(fmi, text, nq: int, dev):
    """(packed patterns, rows of the first pattern's range, nq random
    rows) as the main path and chip_smoke.py make them."""
    pats = sample_patterns(text, nq, QLEN)
    qw = torch.from_numpy(pack.np_pack_queries_2bit(pats).view(np.int32)).to(
        dev
    )
    b, e, _ = fm.get_range_packed_device_plain(fmi.arrays, qw[:1], QLEN, 0)
    q_rows = torch.arange(int(b[0]), int(e[0]), device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    rand_rows = torch.randint(0, len(text) + 1, (nq,), device=dev,
                              generator=g)
    return qw, q_rows, rand_rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=N_TEXT)
    p.add_argument("--queries", type=int, default=N_QUERIES)
    p.add_argument("--chunk", type=int, default=CLI_CHUNK)
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--bfs-only", action="store_true",
                   help="K4 alone: its split, ptxas report and timings")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    smi = "cpu (host clock)"
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
    say = lambda m: print(m, flush=True)  # noqa: E731
    text = synth_genome(args.n)
    fmi = fm.FMIndex(sa_intv=SA_INTV, lookup_len=0, device=dev).build(text)
    qw, q_rows, rand_rows = query_inputs(fmi, text, args.queries, dev)
    if not args.bfs_only:
        measure(fmi, qw, q_rows, rand_rows, args.chunk, smi, say=say,
                reps=args.reps)
    # K4 on a 32-ordered index of the same text, the BFS route's archives
    bfs = fm.FMIndex(sa_intv=SA_INTV, lookup_len=0, device=dev).build(
        text, sort_len=32)
    beg, end, _ = fm.get_range_packed_device(bfs.arrays, qw, QLEN, 0,
                                             blocks=bfs.blocks)
    measure_bfs(bfs, beg, end, args.chunk, smi, say=say, reps=args.reps)
    if dev.type == "cuda":
        measure_bfs_split(bfs, beg, end, args.chunk, smi, say=say,
                          reps=args.reps)
        ptxas_report(say=say)
    return 0


if __name__ == "__main__":
    sys.exit(main())
