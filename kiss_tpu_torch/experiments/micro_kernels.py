"""Kernel viability + throughput micro-benchmarks for the sort kernel.

Port of ``experiments/micro_pallas.py``: the same four probes, each a
hand-written CUDA kernel (``kiss_tpu_torch/csrc/micro_probes.cu``) beside
its plain PyTorch version:

  - :func:`stream_copy`: ``x + 1`` streamed tile by tile (the device
    memory roofline check);
  - :func:`one_stage`: one bitonic compare-exchange stage over (key,
    payload) tiles;
  - :func:`tile_sort`: the full in-tile bitonic sort of (key, payload);
  - :func:`kernel_gather`: ``x[idx]`` with the table in fast memory.

Arrays are shaped ``[R, 128]`` as on the TPU. The TPU probes' unsigned
32-bit keys are carried as ``int32`` tensors holding the same bits (torch
has no arithmetic on ``uint32``); payloads and indices are ``int32``.
``rows`` was the TPU kernel's block of ``rows x 128`` elements; here it is
the tile one thread block owns, so the probes can still sweep it. How a
block moves its tile is chosen so that the bytes it keeps in flight do not
shrink with the number of blocks (see :func:`launch_tile_map`).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
``*_plain`` version. Run on the card:

    python -m kiss_tpu_torch.experiments.micro_kernels [--device cuda]

prints the card's name and power limit, then for each probe its label,
best-of-3 milliseconds (CUDA events; per call of 10 in a row for the
streaming copy) and the derived rate, and beside it
the one PyTorch call that computes the same function where there is one.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time

import torch

from kiss_tpu_torch import kernels
from kiss_tpu_torch.ops.pack import as_u32, to_u32_bits
from kiss_tpu_torch.utils.device import resolve_device

N = 48_800_649
LANES = 128
VEC = 4  # 32-bit elements per 16-byte vector
# calls in a row per timing of a streaming copy (see best_seconds)
COPY_LAUNCHES = 10
# largest table the gather stages in a block's shared memory (227 KB)
SHARED_TABLE_BYTES = 232_448


# ------------------------------------------------------------------ helpers
def device_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them (the
    first line of a probe run), or ``cpu``."""
    if dev.type != "cuda":
        return str(dev)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def best_seconds(fn, *args, n=3, launches=1) -> float:
    """Best of ``n`` timings of ``fn(*args)`` after one warm-up call: CUDA
    events when the first argument is on a card, the host clock else.
    With ``launches`` > 1 a timing spans that many calls in a row and is
    divided by their number: the card then works through a queue, and the
    host's time to prepare one launch (tens of microseconds of Python,
    as long as a whole streaming kernel) no longer sits between the two
    events."""
    on_card = args[0].is_cuda
    fn(*args)
    if on_card:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(n):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fn(*args)
            stop.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3 / launches)
        else:
            t0 = time.perf_counter()
            for _ in range(launches):
                fn(*args)
            best = min(best, (time.perf_counter() - t0) / launches)
    return best


def timed(label, fn, *args, n=3, launches=1):
    best = best_seconds(fn, *args, n=n, launches=launches)
    print(f"{label:48s} {best*1e3:9.3f}ms", flush=True)
    return best


def require_tiles(x: torch.Tensor, name: str, rows: int) -> None:
    """An ``[R, 128]`` int32 tensor, contiguous and 16-byte aligned, and
    a positive ``rows``."""
    kernels.require(x, name, torch.int32, 2)
    if x.shape[1] != LANES:
        raise ValueError(
            f"{name}: expected [R, {LANES}], got {tuple(x.shape)}"
        )
    if rows < 1:
        raise ValueError(f"rows must be positive, got {rows}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: storage must be 16-byte aligned")


def whole_tiles(x: torch.Tensor, name: str, rows: int) -> int:
    if x.shape[0] % rows:
        raise ValueError(
            f"{name}: {x.shape[0]} rows are not a whole number of "
            f"{rows}-row tiles"
        )
    return x.shape[0] // rows


def launch_tile_map(entry: str, counter: str, x: torch.Tensor, rows: int,
                    *scalars) -> torch.Tensor:
    """Launch one of the elementwise probes on a CUDA tensor: a thread
    block per tile of ``rows * 128`` elements. A copy is bound by device
    memory and runs at the rate of the bytes it keeps in flight; large
    tiles mean few blocks, so each block has to keep many. Batched loads:
    every thread of a large block starts four 16-byte loads before its
    first store. The identity copy with fewer tiles than SMs takes a ring
    instead, the faster of the two on the H100 there: one elected thread
    streams the tile through six 16 KB stages of shared memory with
    asynchronous bulk copies in both directions, so 80 KB of loads stay
    in flight a block and no thread touches the data."""
    out = torch.empty_like(x)
    # [R, 128] int32 is R * 32 vectors of 16 bytes: never a ragged vector
    nvec = x.numel() // VEC
    fn = getattr(kernels.library(), entry)
    kernels.check(
        fn(x.data_ptr(), out.data_ptr(), nvec, rows * LANES // VEC, *scalars,
           kernels.stream_of(x.device)),
        entry,
    )
    kernels.count_launch(counter)
    return out


# --------------------------------------------------------------- copy kernel
def stream_copy_plain(x, rows):
    return to_u32_bits(as_u32(x) + 1)


def stream_copy(x, rows):
    """P1: ``x + 1`` (mod 2**32) over uint32 bits held in int32
    ``[R, 128]``, a thread block per tile of ``rows`` rows (the last tile
    may be short). Blocks of 1024 threads, each thread loading four
    16-byte vectors before its first store (64 KB in flight a block): the
    threads must touch every element anyway, and on the card this beat
    moving the tile through a ring of shared-memory stages."""
    require_tiles(x, "x", rows)
    if x.device.type == "cpu":
        return stream_copy_plain(x, rows)
    return launch_tile_map("kt_probe_stream_copy", "stream_copy", x, rows)


# ------------------------------------------------- bitonic stage / full sort
def _pairs(k, v, rows, what):
    require_tiles(k, "k", rows)
    require_tiles(v, "v", rows)
    if k.shape != v.shape or k.device != v.device:
        raise ValueError(f"{what}: k and v differ in shape or device")
    return whole_tiles(k, "k", rows)


def _check_stage(T, d, stage_d):
    if d < 1 or d & (d - 1) or T % (2 * d):
        raise ValueError(
            f"one_stage: d = {d} must be a power of two with 2 * d "
            f"dividing the tile of {T} elements"
        )
    if stage_d < 1:
        raise ValueError(f"one_stage: stage_d = {stage_d} must be positive")


def one_stage_plain(k, v, rows, d, stage_d):
    """Plain version of P2: the TPU kernel's reshape + flip partner
    exchange, keys compared as unsigned (widened), payloads as signed."""
    R, L = k.shape
    T = rows * L
    nt = R // rows
    ku = as_u32(k).reshape(nt, T)
    vs = v.to(torch.int64).reshape(nt, T)
    idx = torch.arange(T, dtype=torch.int64, device=k.device)
    keep_min = ((idx & (2 * stage_d)) == 0) == ((idx & d) == 0)
    ko = ku.reshape(nt, T // (2 * d), 2, d).flip(2).reshape(nt, T)
    vo = vs.reshape(nt, T // (2 * d), 2, d).flip(2).reshape(nt, T)
    lt = (ku < ko) | ((ku == ko) & (vs < vo))
    take_self = torch.where(keep_min, lt, ~lt)
    return (
        to_u32_bits(torch.where(take_self, ku, ko)).reshape(R, L),
        torch.where(take_self, vs, vo).to(torch.int32).reshape(R, L),
    )


def one_stage(k, v, rows, d, stage_d):
    """P2: one bitonic compare-exchange of partners ``i``, ``i ^ d``
    inside each tile of ``rows * 128`` elements, ordered by (``k`` as
    unsigned 32 bits held in int32, then ``v`` signed); the run direction
    comes from ``idx & 2 * stage_d`` with ``idx`` local to the tile.
    Returns ``(k', v')``."""
    _pairs(k, v, rows, "one_stage")
    T = rows * LANES
    _check_stage(T, d, stage_d)
    if k.device.type == "cpu":
        return one_stage_plain(k, v, rows, d, stage_d)
    ko, vo = torch.empty_like(k), torch.empty_like(v)
    kernels.check(
        kernels.library().kt_probe_one_stage(
            k.data_ptr(), v.data_ptr(), ko.data_ptr(), vo.data_ptr(),
            k.numel(), T, d, stage_d, kernels.stream_of(k.device),
        ),
        "kt_probe_one_stage",
    )
    kernels.count_launch("one_stage")
    return ko, vo


def sort_key(k, v):
    """One signed 64-bit key per pair whose order is (``k`` unsigned,
    ``v`` signed): what ``torch.sort``, which takes one key, needs."""
    return ((as_u32(k) - 2**31) << 32) | (v.to(torch.int64) + 2**31)


def tile_sort_plain(k, v, rows):
    """Plain version of P3: ``torch.sort`` of :func:`sort_key` along
    each tile, decoded back into (key bits, payload)."""
    R, L = k.shape
    key = torch.sort(sort_key(k, v).reshape(R // rows, rows * L), dim=1).values
    return (
        to_u32_bits((key >> 32) + 2**31).reshape(R, L),
        ((key & 0xFFFFFFFF) - 2**31).to(torch.int32).reshape(R, L),
    )


def tile_sort(k, v, rows):
    """P3: every tile of ``T = rows * 128`` elements (``T`` a power of
    two) fully sorted ascending by (``k`` as unsigned 32 bits held in
    int32, then ``v`` signed). Returns ``(k', v')``."""
    _pairs(k, v, rows, "tile_sort")
    T = rows * LANES
    if T & (T - 1):
        raise ValueError(f"tile_sort: the tile of {T} elements must be a "
                         "power of two")
    if k.device.type == "cpu":
        return tile_sort_plain(k, v, rows)
    ko, vo = torch.empty_like(k), torch.empty_like(v)
    kernels.check(
        kernels.library().kt_probe_tile_sort(
            k.data_ptr(), v.data_ptr(), ko.data_ptr(), vo.data_ptr(),
            k.numel(), T, kernels.stream_of(k.device),
        ),
        "kt_probe_tile_sort",
    )
    kernels.count_launch("tile_sort")
    return ko, vo


# --------------------------------------------------------- in-kernel gather
def kernel_gather_plain(x, idx, rows):
    return x[idx.to(torch.int64)]


def kernel_gather(x, idx, rows):
    """P4: ``x[idx]`` for a table ``x`` (uint32 bits held in int32
    ``[n]``) and indices ``idx`` (int32 ``[R, 128]``, each in ``[0, n)``;
    the kernel clamps any other to the last entry rather than read
    outside the table, where the plain version raises). The table is
    staged in a block's shared memory when its bytes fit
    (``SHARED_TABLE_BYTES``) and read through the read-only cache
    otherwise."""
    kernels.require(x, "x", torch.int32, 1)
    require_tiles(idx, "idx", rows)
    if x.device != idx.device:
        raise ValueError("kernel_gather: x and idx are on different devices")
    if not 1 <= x.shape[0] < 2**31:
        raise ValueError(f"kernel_gather: table of {x.shape[0]} entries")
    if x.device.type == "cpu":
        return kernel_gather_plain(x, idx, rows)
    out = torch.empty_like(idx)
    kernels.check(
        kernels.library().kt_probe_gather(
            x.data_ptr(), x.shape[0], idx.data_ptr(), out.data_ptr(),
            idx.numel() // VEC, rows * LANES // VEC,
            int(x.shape[0] * 4 <= SHARED_TABLE_BYTES),
            kernels.stream_of(x.device),
        ),
        "kt_probe_gather",
    )
    kernels.count_launch("kernel_gather")
    return out


# --------------------------------------------------------------------- main
def probe_inputs(np_, dev, seed=0):
    """(k, v): ``np_`` random key bits and the payload 0..np_-1, both
    int32 ``[np_ / 128, 128]`` on ``dev``, from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randint(0, 2**32, (np_,), device=dev, generator=g).to(
        torch.int32  # the cast wraps: all 32 bits are random
    )
    v = torch.arange(np_, dtype=torch.int32, device=dev)
    return k.reshape(-1, LANES), v.reshape(-1, LANES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; absent CUDA raises)")
    ap.add_argument("--elements", type=int, default=N,
                    help="elements per operand, rounded down to whole "
                    f"tiles of 2048 x 128 (default: {N})")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    ROWS = 2048  # 2048*128 = 256K elements/tile
    Np = (args.elements // (ROWS * LANES)) * ROWS * LANES
    if Np == 0:
        raise ValueError(f"--elements must be at least {ROWS * LANES}")
    k, v = probe_inputs(Np, dev)
    gb = Np * 4 / 1e9
    print(f"N={Np} ({gb:.2f} GB/operand)", flush=True)

    t = timed("stream copy u32 (rows=2048)", stream_copy, k, ROWS,
              launches=COPY_LAUNCHES)
    print(f"  -> {2 * gb / t:.0f} GB/s")
    t = timed("torch x + 1 (library call)", lambda x: x + 1, k,
              launches=COPY_LAUNCHES)
    print(f"  -> {2 * gb / t:.0f} GB/s")

    for label, d in (("d=1", 1), ("d=128", 128), ("d=64k", 1 << 16)):
        t = timed(f"1 bitonic stage {label} (2 ops)", one_stage, k, v, ROWS,
                  d, d)
        print(f"  -> {4 * gb / t:.0f} GB/s")

    for rows in (256, 1024, 2048):
        t = timed(f"full tile sort {rows*128//1024}K (2 ops)", tile_sort, k,
                  v, rows)
        lg = math.log2(rows * LANES)
        nst = lg * (lg + 1) / 2
        print(f"  -> {t*1e3:.1f}ms for {nst:.0f} stages "
              f"({t*1e3/nst:.3f} ms/stage-equivalent)")
        key = sort_key(k, v).reshape(-1, rows * LANES)
        timed(f"torch.sort 1 key per tile {rows*128//1024}K (library call)",
              lambda a: torch.sort(a, dim=1), key)
        del key

    # in-kernel gather: a table in shared memory (32K entries fit a block)
    # and one in L2 (64K entries do not), random idx
    for entries, where in ((1 << 15, "shared memory"), (1 << 16, "L2")):
        table = k.reshape(-1)[:entries]
        idx = v % entries
        t = timed(f"in-kernel gather ({entries >> 10}K table, {where})",
                  kernel_gather, table, idx, ROWS)
        print(f"  -> {Np / t / 1e9:.1f} G elements/s")
        t = timed(f"torch x[idx] ({entries >> 10}K table, library call)",
                  lambda t_, i_: t_[i_], table, idx)
        print(f"  -> {Np / t / 1e9:.1f} G elements/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
