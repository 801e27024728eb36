"""How fast does a trivial streaming copy run, and at what block size?

Port of ``experiments/micro_copy.py``: an identity copy over a grid of
row tiles (:func:`copy_grid`), the same copy over the 2-D view
``[R / rows, rows * 128]`` (:func:`copy_2d`), and a 64-step integer
multiply-add chain per element (:func:`run_heavy`, the integer-lane
rate). Each is a hand-written CUDA kernel
(``kiss_tpu_torch/csrc/micro_probes.cu``) beside its plain PyTorch
version; a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the ``*_plain`` version. Arrays are ``[R, 128]`` int32 tensors holding the
TPU probes' unsigned 32-bit values bit for bit.

    python -m kiss_tpu_torch.experiments.micro_copy [--device cuda]

prints the card's name and power limit, then label, best-of-3
milliseconds (CUDA events, per call of 10 in a row) and GB/s (bytes read
plus bytes written) of ``x + 1`` and ``x.clone()`` in PyTorch and of each
probe, and the chain's Tops/s.
"""

from __future__ import annotations

import argparse
import sys

import torch

from kiss_tpu_torch import kernels
from kiss_tpu_torch.experiments.micro_kernels import (
    LANES,
    VEC,
    COPY_LAUNCHES,
    whole_tiles,
    best_seconds,
    device_line,
    launch_tile_map,
    probe_inputs,
    require_tiles,
)
from kiss_tpu_torch.ops.pack import U32_MASK, as_u32, to_u32_bits
from kiss_tpu_torch.utils.device import resolve_device

N = 48_758_784
HEAVY_STEPS = 64
HEAVY_MUL = 2654435761
HEAVY_ADD = 12345
MAX_ROWS_2D = 65_535  # the y extent of a CUDA grid


def timed(label, fn, *args, n=3):
    best = best_seconds(fn, *args, n=n, launches=COPY_LAUNCHES)
    gbs = args[0].numel() * 4 * 2 / 1e9 / best
    print(f"{label:52s} {best*1e3:9.3f}ms  {gbs:7.1f} GB/s", flush=True)
    return best


def copy_grid_plain(x, rows):
    return x.clone()


def copy_grid(x, rows):
    """P5: identity copy of int32 ``[R, 128]``, a thread block per tile
    of ``rows`` rows (the last tile may be short). While there is a tile
    for every SM, blocks of 1024 threads load four 16-byte vectors a
    thread before the first store. With fewer tiles than SMs a block is
    one warp whose elected thread streams the tile through a ring of six
    16 KB shared-memory stages with asynchronous bulk copies in both
    directions: the bytes in flight are then the ring's, not the thread
    count's, and no thread touches the data. The TPU probe's
    ``semantics`` argument is dropped: it was a hint on how the TPU may
    schedule its sequential grid, which has no meaning on a GPU, whose
    blocks always run in parallel."""
    require_tiles(x, "x", rows)
    if x.device.type == "cpu":
        return copy_grid_plain(x, rows)
    return launch_tile_map("kt_probe_copy_grid", "copy_grid", x, rows)


def copy_2d_plain(x, rows):
    return x.reshape(x.shape[0] // rows, rows * LANES).clone()


def copy_2d(x, rows):
    """P6: identity copy of int32 ``[R, 128]`` viewed as ``[R / rows,
    rows * 128]`` (the shape it returns): each row of the view is spread
    over many small thread blocks."""
    require_tiles(x, "x", rows)
    ntiles = whole_tiles(x, "x", rows)
    if x.device.type == "cpu":
        return copy_2d_plain(x, rows)
    if ntiles > MAX_ROWS_2D:
        raise ValueError(
            f"copy_2d: {ntiles} rows of the 2-D view exceed a CUDA grid's "
            f"y extent of {MAX_ROWS_2D}; use a larger rows"
        )
    out = torch.empty((ntiles, rows * LANES), dtype=x.dtype, device=x.device)
    kernels.check(
        kernels.library().kt_probe_copy_2d(
            x.data_ptr(), out.data_ptr(), ntiles, rows * LANES // VEC,
            kernels.stream_of(x.device),
        ),
        "kt_probe_copy_2d",
    )
    kernels.count_launch("copy_2d")
    return out


def run_heavy_plain(x, rows):
    """Plain version of P7 in int64, masked to 32 bits after every step.
    The factor is taken modulo 2**32 into the signed range, so no product
    leaves int64 and the low 32 bits are those of the unsigned product."""
    v = as_u32(x)
    mul = HEAVY_MUL - 2**32
    for _ in range(HEAVY_STEPS):
        v = (v * mul + HEAVY_ADD) & U32_MASK
    return to_u32_bits(v)


def run_heavy(x, rows):
    """P7: 64 x ``v = v * 2654435761 + 12345`` (mod 2**32) per element of
    uint32 bits held in int32 ``[R, 128]``: 128 integer operations for
    every 8 bytes moved, so the integer lanes bound it. Blocks of 512
    threads, four 16-byte loads a thread before the first store."""
    require_tiles(x, "x", rows)
    if x.device.type == "cpu":
        return run_heavy_plain(x, rows)
    return launch_tile_map("kt_probe_heavy", "run_heavy", x, rows, HEAVY_MUL,
                           HEAVY_ADD)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; absent CUDA raises)")
    ap.add_argument("--elements", type=int, default=N,
                    help="elements of the operand, rounded down to whole "
                    f"tiles of 2048 x 128 (default: {N})")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    n = (args.elements // (2048 * LANES)) * 2048 * LANES
    if n == 0:
        raise ValueError(f"--elements must be at least {2048 * LANES}")
    x, _ = probe_inputs(n, dev)
    print(f"N={n} ({n * 4 / 1e9:.2f} GB/operand)", flush=True)

    timed("torch x + 1 (library call)", lambda a: a + 1, x)
    timed("torch x.clone() (library call)", lambda a: a.clone(), x)
    for rows in (128, 512, 2048, 8192, 32768):
        timed(f"grid copy rows={rows}", copy_grid, x, rows)
    timed("2d copy rows=2048", copy_2d, x, 2048)

    # compute-heavy kernel to see the integer rate: 64 fused ops per element
    t = timed("heavy x128ops rows=2048", run_heavy, x, 2048)
    print(f"  -> {n * 128 / t / 1e12:.2f} Tops/s (u32 mul+add)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
