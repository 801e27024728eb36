"""Command-line interface mirroring the reference ``kISS`` binary.

Port of ``kiss_tpu.cli`` (reference surface: src/main.cpp:19-40,
include/utils/options.hpp:20-300): the same subcommands, flags, defaults
and log lines, so scripts written against the reference binary keep
working. One flag is new: ``--device`` (default ``cuda``) names where the
work runs; a CUDA device that is not there is an error, never a quiet
move to the CPU.

``suffix_sort`` routes as ``kiss_tpu.cli`` does: ``--external``, or a
text at or over the in-core capacity derived from the card's memory, goes
to the out-of-core sorter (``ops.external_sort``, host-staged, batches
sorted by K1); ``-s LMS_INDUCED`` is the host-resident native sorter and
never auto-routes. ``fmindex_query`` routes locate by the archive's
``.meta`` sidecar: the per-row walk when it records a full sort, the range
BFS otherwise (``fmindex_build -k N`` archives, archives whose sidecar is
absent or stale, archives written by the reference binary). ``serve``
answers ``-q`` patterns and ``batch <file>`` requests from one loaded
index.

``-t N`` maps the reference's thread count onto a mesh of min(N, visible
CUDA devices) cards (:mod:`kiss_tpu_torch.parallel`), as ``kiss_tpu.cli``
maps it onto its device mesh: ``suffix_sort`` and ``fmindex_build`` sort
on the mesh, the build makes its tables shard by shard and writes the same
``.fmi``, and ``fmindex_query`` / ``serve`` search and walk a row-sharded
index. On one card, and on the CPU, ``-t`` runs the single-device path.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np
import torch

from kiss_tpu_torch import BANNER, VERSION
from kiss_tpu_torch.models import fm_index as fm_meta
from kiss_tpu_torch.models.fm_index import FMIndex
from kiss_tpu_torch.ops import external_sort
from kiss_tpu_torch.ops import suffix_sort as ss
from kiss_tpu_torch.ops.lms_native import LmsSorter
from kiss_tpu_torch.ops.suffix_sort import Kiss1Sorter, Kiss2Sorter
from kiss_tpu_torch.utils import codec, fasta, timing
from kiss_tpu_torch.utils.device import resolve_device

SORTING_ALGORITHMS = {
    "PARALLEL_SORTING": Kiss1Sorter,
    "PREFIX_DOUBLING": Kiss2Sorter,
    "LMS_INDUCED": LmsSorter,
}


def _add_generic(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "-g",
        "--generic",
        action="store_true",
        help="(Under construction) input contains bases other than ATCG",
    )
    p.add_argument(
        "-t",
        "--num_threads",
        type=int,
        default=0,
        metavar="NUM",
        help="number of threads (accepted for parity; maps onto the "
        "number of CUDA devices, clamped to those visible)",
    )
    p.add_argument(
        "--verbose", action="store_true", help="print more information"
    )
    p.add_argument(
        "--profile",
        metavar="DIR",
        help="write a torch.profiler trace of this command to "
        "DIR/trace.json, the library's kiss.* phases named in it",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default: cuda). CUDA that is not "
        "available is an error; pass --device cpu to run on the CPU",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kISS", add_help=True)
    p.add_argument("-v", "--version", action="store_true", help="print version")
    sub = p.add_subparsers(dest="command")

    ss = sub.add_parser("suffix_sort", help="build a k-ordered suffix array")
    _add_generic(ss)
    ss.add_argument(
        "-k",
        "--kordered",
        type=int,
        default=256,
        metavar="NUM",
        help="sort each suffix by its first k characters; -1 = unbounded",
    )
    ss.add_argument(
        "-s",
        "--sorting-algorithm",
        dest="sorting_algorithm",
        type=str.upper,
        choices=sorted(SORTING_ALGORITHMS),
        default="PARALLEL_SORTING",
        metavar="ALGO",
        help="PARALLEL_SORTING: 64-char raw-word seed + 8-key rank "
        "rounds (kISS-1's bucketed direct sort re-expressed; the fast "
        "default). PREFIX_DOUBLING: 16-char super-char seed + 2-key "
        "doubling rounds (kISS-2's prefix doubling re-expressed). "
        "Identical output order either way (exact-k cut, position "
        "tiebreaks). LMS_INDUCED: the reference's LMS direct sort + "
        "induced L/S passes as native host C++ (csrc/kiss_lms.cpp); "
        "host-resident, -t caps its OpenMP threads, never routed "
        "out-of-core.",
    )
    ss.add_argument(
        "--external",
        action="store_true",
        help="use the out-of-core sorter (host-staged buckets, each batch "
        "sorted on the device; -s/-t do not apply). Texts at or above the "
        "in-core capacity derived from device memory take it "
        "automatically.",
    )
    ss.add_argument("fasta", help="FASTA/text file path")

    fb = sub.add_parser("fmindex_build", help="build and save an FM-index")
    _add_generic(fb)
    fb.add_argument(
        "-k",
        "--kordered",
        type=int,
        default=None,
        metavar="NUM",
        help="sort depth of the underlying suffix array; -1 = unbounded. "
        "The reference declares this flag but hardcodes sort_len = 32 "
        "(reference: include/utils/options.hpp:133-141 vs "
        "fm_index.hpp:384-386); here it is honored as the sort depth. "
        "Default (omitted): a FULLY sorted SA, which keeps locate exact "
        "for every pattern length.",
    )
    fb.add_argument(
        "-l", "--lookup-len", type=int, default=0, dest="lookup_len",
        help="seed-table depth: precompute ranges of all 4^L length-L "
        "seeds so queries skip their last L backward-search steps "
        "(reference FMIndex LOOKUP_LEN parameter, fm_index.hpp:237-269; "
        "the reference CLI uses 0). Queries read it from the archive.",
    )
    fb.add_argument("fasta", help="FASTA/text file path")

    fq = sub.add_parser("fmindex_query", help="query a saved FM-index")
    _add_generic(fq)
    fq.add_argument(
        "--assume-full-sa",
        action="store_true",
        dest="assume_full_sa",
        help="treat the archive as built from a FULLY sorted suffix "
        "array: locate uses the per-row LF walk. Archives built by this "
        "tool's fmindex_build record this in a `.meta` sidecar and route "
        "automatically; the flag exists for archives whose sidecar was "
        "lost. WRONG positions on long repeats if the SA was only "
        "k-ordered (e.g. reference-binary archives, which are 32-ordered"
        " -- reference: fm_index.hpp:384-386).",
    )
    fq.add_argument("-q", "--query", type=str, help="single pattern to search")
    fq.add_argument(
        "-n", "--headn", type=int, default=10, metavar="NUM",
        help="print at most this many positions",
    )
    fq.add_argument(
        "-b", "--batch", type=str,
        help="binary pattern file: u32 query_len, u32 num_query, then "
        "fixed-length ASCII patterns",
    )
    fq.add_argument("fasta", help="FASTA/text file path")

    sv = sub.add_parser(
        "serve", help="long-lived query server: load the index once, "
        "then answer one pattern (or `batch <file>`) per stdin line"
    )
    _add_generic(sv)
    sv.add_argument(
        "--assume-full-sa", action="store_true", dest="assume_full_sa",
        help="same as the fmindex_query flag",
    )
    sv.add_argument(
        "-n", "--headn", type=int, default=10, metavar="NUM",
        help="print at most this many positions per pattern",
    )
    sv.add_argument(
        "--warm", type=int, default=0, metavar="LEN",
        help="run one search and locate of a pattern of this length "
        "before signalling ready (loads the kernel library and touches "
        "the index on the device)",
    )
    sv.add_argument("fasta", help="FASTA/text file path")
    return p


def _read_folded(path: str) -> np.ndarray:
    """read_sequence + the c % 4 alphabet fold every command applies
    (reference: include/command/suffix_sort.hpp:29-33)."""
    seq = fasta.read_sequence(path)
    return codec.fold_to_acgt(seq)


def _reject_generic(args) -> None:
    if getattr(args, "generic", False):
        # reference: every command throws on --generic
        # (include/command/suffix_sort.hpp:26-28)
        raise SystemExit(
            "Generic sorting and indexing are currently not supported."
        )


# in-core device-buffer cost model: peak CUDA bytes per text character of
# the port's sort + index build, with margin. Measured on an H100 at
# n = 48,800,648: 85.3 (k = 256), 109.3 (k = -1, synthetic genome) and
# 133.3 (k = -1, a 1000-periodic text, where every suffix stays tied into
# the tail refinement) -- see PERF.md
IN_CORE_BYTES_PER_CHAR = 160
# the same for each card of a -t N mesh, per character of the card's block
# (the mesh pipeline keeps 1/D of every length-N array a card), by the
# algorithm -t N sorts with: fitted from the peaks of four shards on one
# H100 80GB HBM3 at 700 W, n = 48,800,648, k = -1, on 2, 4 and 8 shards
# (chip_smoke.py phase 7f, see PERF.md): columnsort 177.3 and bitonic
# 345.6, plus for bitonic the partner's block a card receives for its
# merge-split (36 B a row, no copy with every shard on one card), with
# 15% margin
MESH_BLOCK_BYTES_PER_CHAR = {"columnsort": 205, "bitonic": 440}
# safety margin against the cost model (allocator reserves, fragmentation)
IN_CORE_MEM_FRACTION = 0.9
# on the CPU there is no device memory to read: the JAX package's
# conservative constant
EXTERNAL_THRESHOLD_FALLBACK = 350_000_000


def in_core_capacity_chars(device, mesh_size: int = 1) -> int:
    """Largest text (chars) the in-core pipeline should attempt on
    ``device``, or on a mesh of ``mesh_size`` such cards: one card's
    capacity times the mesh size, as ``kiss_tpu/cli.py:266`` scales it
    (the mesh pipeline keeps 1/D of every length-N array on each card).
    A card's capacity is, for CUDA, its memory
    (``torch.cuda.mem_get_info``) times IN_CORE_MEM_FRACTION over
    IN_CORE_BYTES_PER_CHAR, or on a mesh over the
    MESH_BLOCK_BYTES_PER_CHAR of the algorithm it sorts with.
    ``KISS_TPU_INCORE_CAP=<chars>`` overrides one card's capacity."""
    override = os.environ.get("KISS_TPU_INCORE_CAP")
    if override:
        return int(override) * mesh_size
    dev = torch.device(device)
    if dev.type != "cuda":
        return EXTERNAL_THRESHOLD_FALLBACK * mesh_size
    _free, total = torch.cuda.mem_get_info(dev)
    per_char = IN_CORE_BYTES_PER_CHAR
    if mesh_size > 1:
        from kiss_tpu_torch.parallel.dsort import auto_algorithm

        per_char = MESH_BLOCK_BYTES_PER_CHAR[auto_algorithm(mesh_size)]
    return int(total * IN_CORE_MEM_FRACTION) // per_char * mesh_size


def suffix_sort_main(args) -> None:
    _reject_generic(args)
    dev = resolve_device(args.device)
    seq = _read_folded(args.fasta)
    sorter = SORTING_ALGORITHMS[args.sorting_algorithm]
    ref = sorter.prepare_aligned_ref(seq)
    # the mesh pipeline keeps 1/D of every length-N array on each card, so
    # a mesh multiplies the in-core capacity by its size, as kiss_tpu.cli
    d = ss._mesh_size_for(args.num_threads, dev)
    capacity = in_core_capacity_chars(dev, d)
    # LMS_INDUCED is host-resident (~10 B/char of host RAM, no device
    # buffers), so the device-memory auto-route does not apply to it;
    # an explicit --external still wins
    host_resident = sorter is LmsSorter
    sw = timing.Stopwatch()
    if args.external or (len(ref) >= capacity and not host_resident):
        if not args.external:
            timing.log_info(
                "routing: n = %d exceeds the in-core device budget "
                "(%d chars x %d device(s)); using the out-of-core "
                "sorter (host-staged; -s/-t do not apply on this path)",
                len(ref), capacity // d, d,
            )
        external_sort.external_k_ordered_suffix_array(
            ref, args.kordered, verbose=timing.debug_enabled(), device=dev
        )
    elif host_resident:
        sorter.get_suffix_array_dna(ref, args.kordered, args.num_threads)
    else:
        sorter.get_suffix_array_dna(ref, args.kordered, args.num_threads,
                                    device=dev)
    timing.log_info(
        "n = %d, k = %d, suffix sorting elapsed %.6f",
        len(ref), args.kordered, sw.elapsed(),
    )


def _build_sharded(fmi: FMIndex, seq: np.ndarray, sort_len, d: int) -> None:
    """fmindex_build over a d-device mesh: the suffix sort and the index
    tables on the mesh, each shard holding its blocks, the tables
    downloaded block by block and trimmed to the canonical serialization
    layout on the host, so the `.fmi` is byte-identical to the
    single-device build's (the reference -t knob, src/main.cpp:22-26, as
    kiss_tpu.cli's ``_build_sharded``)."""
    from kiss_tpu_torch.parallel import make_mesh
    from kiss_tpu_torch.parallel.fm_build import (
        build_index_blocks,
        sharded_lookup,
        tables_to_host,
    )
    from kiss_tpu_torch.parallel.sharded_plan import sharded_sa_blocks

    timing.log_debug("fmindex_build: sharded build over %d devices", d)
    mesh = make_mesh(d, device=fmi.device)
    text = np.ascontiguousarray(seq, dtype=np.int8)
    fmi.full_sa = (
        sort_len is None or sort_len < 0 or sort_len >= len(seq)
    )
    with timing.span(None, log="suffix sort (sharded)") as sp:
        sa = sp.result(sharded_sa_blocks(
            mesh, text, -1 if sort_len is None else sort_len
        ))
    with timing.span(None, log="fmindex build (sharded)") as sp:
        tables = sp.result(build_index_blocks(mesh, text, sa, fmi.sa_intv))
        del sa
    lookup = sharded_lookup(mesh, tables, fmi.lookup_len)
    fmi.arrays = tables_to_host(mesh, tables, lookup, fmi.sa_intv)
    fmi.n_rows = len(seq) + 1


def fmindex_build_main(args) -> None:
    _reject_generic(args)
    dev = resolve_device(args.device)
    seq = _read_folded(args.fasta)
    fmi = FMIndex(sa_intv=4, lookup_len=args.lookup_len, device=dev)
    # -k omitted -> the full-sort default (None); -k N -> N-ordered SA
    # (-1 = unbounded, same wrap rule as suffix_sort, README.md:56)
    sort_len = args.kordered
    if sort_len is not None and sort_len < 0:
        sort_len = None
    d = ss._mesh_size_for(args.num_threads, dev)
    if d > 1:
        _build_sharded(fmi, seq, sort_len, d)
    else:
        fmi.build(seq, sort_len=sort_len)
    fmi_path = args.fasta + ".fmi"
    with open(fmi_path, "wb") as fout:
        fmi.save(fout)
    # provenance sidecar: lets fmindex_query route locate through the
    # per-row walk when (and only when) the source SA was fully sorted
    fm_meta.write_meta(
        fmi_path, full_sa=fmi.full_sa, sort_len=sort_len,
        lookup_len=args.lookup_len,
    )


def _ordinal(x: int) -> str:
    # reference: include/command/fmindex_query.hpp:42-53
    x %= 100
    if x // 10 == 1:
        return "th"
    return {1: "st", 2: "nd", 3: "rd"}.get(x % 10, "th")


def _load_query_engine(args):
    """Shared fmindex_query/serve setup: read + load + locate routing +
    mesh selection. Returns (seq, engine)."""
    dev = resolve_device(args.device)
    seq = _read_folded(args.fasta)
    fmi = FMIndex(sa_intv=4, lookup_len=0, device=dev)
    fmi_path = args.fasta + ".fmi"
    with open(fmi_path, "rb") as fin:
        fmi.load(fin)
    # locate routing: the per-row walk is exact only over a fully sorted
    # source SA; trust the build-time sidecar (or the explicit flag)
    meta = fm_meta.read_meta(fmi_path)
    if args.assume_full_sa or (meta is not None and meta.get("full_sa")):
        fmi.full_sa = True
    # -t N (N > 1): the search (and, for full-sort indexes, the locate
    # walk) over an N-device mesh with the index row-sharded; results
    # equal -t 1's
    d = ss._mesh_size_for(args.num_threads, dev)
    if d > 1:
        from kiss_tpu_torch.parallel import make_mesh
        from kiss_tpu_torch.parallel.fm_sharded import ShardedFMQuery

        timing.log_debug("fmindex_query: index sharded over %d devices", d)
        return seq, ShardedFMQuery(make_mesh(d, device=dev), fmi)
    return seq, fmi


def _single_query(engine, seq, pattern: str, headn: int) -> None:
    """The -q path (reference: include/command/fmindex_query.hpp:34-64)."""
    iq = codec.fold_to_acgt(codec.to_istring(pattern))
    beg, end, _ = engine.get_range(iq)
    positions = engine.get_offsets(beg, end)
    # the range's rows, as kiss_tpu counts them (outside the range BFS's
    # contract the BFS may give another number of positions)
    timing.log_info(
        "query = %s found %d times",
        codec.to_string(iq), end - beg,
    )
    for i in range(min(headn, len(positions))):
        loc = int(positions[i])
        timing.log_info(
            "The %d-%s position is %d, content of substring is %s",
            i + 1, _ordinal(i + 1), loc,
            codec.to_string(seq[loc : loc + len(iq)]),
        )


def _batch_query(engine, batch_path: str) -> None:
    """The -b path (reference: include/command/fmindex_query.hpp:66-99)."""
    with open(batch_path, "rb") as pfile:
        query_len, num_query = struct.unpack("<II", pfile.read(8))
        timing.log_info(
            "query_len: %d, num_query: %d", query_len, num_query
        )
        raw = pfile.read(query_len * num_query)
    buf = np.frombuffer(raw, dtype=np.uint8).reshape(num_query, query_len)
    queries = codec.fold_to_acgt(codec.to_istring(buf.reshape(-1))).reshape(
        num_query, query_len
    )
    # chunk boundaries land on remaining-count multiples of 100k so
    # the per-100k progress line matches the reference batch loop
    # (reference: include/command/fmindex_query.hpp:92-93 logs
    # "remain: {}, time: {}" whenever num_query % 100000 == 0)
    occ, checksum, elapsed = 0, 0, 0.0
    done = 0
    while done < num_query:
        step = num_query % 100_000 if done == 0 else 100_000
        step = step or min(100_000, num_query)
        sw = timing.Stopwatch()
        o, c = engine.batch_query_stats(queries[done : done + step])
        elapsed += sw.elapsed()
        occ += o
        checksum += c
        done += step
        timing.log_debug("remain: %d, time: %s", num_query - done, elapsed)
    timing.log_info("searching time: %s seconds", elapsed)
    timing.log_info("number of matched locations: %d", occ)
    timing.log_info("location checksum: %d", checksum)


def fmindex_query_main(args) -> None:
    _reject_generic(args)
    seq, engine = _load_query_engine(args)
    if args.query:
        _single_query(engine, seq, args.query, args.headn)
    if args.batch:
        _batch_query(engine, args.batch)


def serve_main(args, stdin=None, stdout=None) -> None:
    """Long-lived query loop: the FASTA and the index are read and put on
    the device once, and each stdin line is one request -- a pattern (the
    ``-q`` path) or ``batch <file>`` (the ``-b`` path). Prints ``ready``,
    then ``ok <seconds>`` after each request, or ``err <Type>: <msg>``
    after a failed one, and keeps serving; an empty line, ``quit`` or
    ``exit`` stops it. ``stdin``/``stdout`` are injectable for tests."""
    _reject_generic(args)
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    seq, engine = _load_query_engine(args)
    if args.warm > 0:
        # one search + locate of this length: the first request then finds
        # the kernel library loaded
        warm = codec.to_string(seq[: args.warm]) if len(seq) >= args.warm \
            else "A" * args.warm
        iq = codec.fold_to_acgt(codec.to_istring(warm))
        beg, end, _ = engine.get_range(iq)
        engine.get_offsets(beg, end)
    print("ready", file=stdout, flush=True)
    for line in stdin:
        line = line.strip()
        if not line or line in ("quit", "exit"):
            break
        sw = timing.Stopwatch()
        # one bad request (missing batch file, malformed pattern) must
        # not end the server: report `err <reason>` and keep serving
        try:
            if line.startswith("batch "):
                _batch_query(engine, line[len("batch "):].strip())
            else:
                _single_query(engine, seq, line, args.headn)
        except Exception as e:  # noqa: BLE001 -- protocol boundary
            timing.log_info("serve: request failed: %s", e)
            print(f"err {type(e).__name__}: {e}", file=stdout, flush=True)
            continue
        print(f"ok {sw.elapsed():.3f}", file=stdout, flush=True)


COMMANDS = {
    "suffix_sort": suffix_sort_main,
    "fmindex_build": fmindex_build_main,
    "fmindex_query": fmindex_query_main,
    "serve": serve_main,
}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.version:
        print(VERSION)
        return 0
    if not args.command:
        print(BANNER)
        parser.print_help()
        return 0
    timing.setup_logging(verbose=getattr(args, "verbose", False))
    profile_dir = getattr(args, "profile", None)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            COMMANDS[args.command](args)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    else:
        COMMANDS[args.command](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
