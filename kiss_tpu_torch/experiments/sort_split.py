"""Where the time of the two sorts goes: K1 ``radix_sort_words`` and the
probe P3 ``tile_sort``, split by device kernel.

Each call is run under ``torch.profiler`` and the device's own record of
every kernel, copy and memset it ran is printed, summed by name, beside
the call's wall time (ending in a synchronize), so the time the device
sat idle inside the call -- the host's share: launch preparation and the
download of the digit counts that decides the pass plan -- shows as the
difference. Then every sort call of the two suffix sorts of the main path
(``-k 256`` and the full sort), with its shape, the digit passes its keys
need and its time by CUDA events.

    python -m kiss_tpu_torch.experiments.sort_split [--device cuda]

``--device cpu --n 20000 --probe-elements 262144`` rehearses the control
flow on the CPU, where there are no device kernels to list.

``--only-k1`` prints K1's split alone and reaches K1 through nothing but
``radix_sort_words``: this file put into a checkout of another commit
measures that commit's K1, so two versions can be timed in one session.
"""

from __future__ import annotations

import argparse
import re
import statistics
import sys
import time

import numpy as np
import torch

from kiss_tpu_torch.experiments import micro_kernels as mk
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.ops.radix_sort import (
    radix_sort_words,
    radix_sort_words_plain,
)
from kiss_tpu_torch.ops.suffix_sort import (
    _make_plan,
    _normalize_k,
    _pack_fields,
    _run_plan,
)
from kiss_tpu_torch.utils.device import resolve_device
from kiss_tpu_torch.utils.synth import synth_genome

N_TEXT = 48_800_648
N_PROBE = 48_758_784
TAIL_SHAPE = (8, 1 << 20)  # a tail-refinement sort: 8 rank keys


def seed_sort_words(text_dev):
    """The 5 words the seed sort hands K1 (64 raw chars + end/position)."""
    n = text_dev.shape[0]
    words, _ = _pack_fields(
        [(w, 32, False) for w in pack.suffix_key_words_2bit(text_dev, 64, 0)]
        + [(pack.fused_end_pos(n, 64, text_dev.device),
            max(n.bit_length(), 1), True)]
    )
    return words


def rank_like_words(shape, dev, seed=0, bits=26):
    """Random keys below ``2**bits`` in every word: what a refinement
    round sorts (ranks of a 48.8M-character text have 26 bits)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 2**bits, shape, device=dev, generator=g).to(
        torch.int32
    )


def digit_passes(keys) -> int:
    """The 8-bit digit passes K1 takes on these keys: the length of its own
    plan."""
    from kiss_tpu_torch.ops.radix_sort import digit_counts_cuda, pass_plan

    W, n = keys.shape
    if keys.is_cuda:
        counts = digit_counts_cuda(keys).cpu().numpy().view(np.uint32)
    else:  # little-endian bytes of each word: byte 0 least significant
        b = np.ascontiguousarray(keys.numpy()).view(np.uint8).reshape(W, n, 4)
        counts = np.array([[np.bincount(b[w, :, j], minlength=256)
                            for j in range(4)] for w in range(W)])
    return len(pass_plan(counts, n))


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(")[0]


def device_events(fn):
    """(events, wall ms): ``fn()`` once under the profiler; events are
    (short name, microseconds) of everything the device ran, in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm up: allocator, lazy module load
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    return [(_short(e.name), e.time_range.elapsed_us()) for e in evs], wall


def by_name(events):
    out = {}
    for name, us in events:
        c, t = out.get(name, (0, 0.0))
        out[name] = (c + 1, t + us)
    return out


def event_ms(fn, reps=3, turns=5):
    """(median, least, most) ms per call over ``turns`` timings by CUDA
    events of ``reps`` calls in a row."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(turns):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out), min(out), max(out)


def report_split(label, fn):
    # CUDA events first: once the profiler has run, a launch costs the host
    # more
    med, least, most = event_ms(fn)
    events, wall = device_events(fn)
    busy = sum(us for _, us in events) / 1e3
    print(f"{label}: {med:.3f} ms per call by CUDA events (median of 5 "
          f"timings of 3 calls in a row, {least:.3f} .. {most:.3f}); under "
          f"the profiler wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"device idle inside the call {wall - busy:.3f} ms")
    for name, (count, us) in sorted(by_name(events).items(),
                                    key=lambda kv: -kv[1][1]):
        print(f"    {name:44s} x{count:<4d} {us / 1e3:9.3f} ms "
              f"({us / count / 1e3:.4f} each)")
    return events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; absent CUDA raises)")
    ap.add_argument("--n", type=int, default=N_TEXT,
                    help=f"text length of the sorts (default: {N_TEXT})")
    ap.add_argument("--probe-elements", type=int, default=N_PROBE,
                    help="elements per tile_sort operand, rounded down to "
                    f"whole tiles of 2048 x 128 (default: {N_PROBE})")
    ap.add_argument("--only-k1", action="store_true",
                    help="K1's split alone, through radix_sort_words only")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(mk.device_line(dev), flush=True)
    text_dev = torch.from_numpy(synth_genome(args.n)).to(dev)

    # ---- every sort call of the two suffix sorts
    for k in () if args.only_k1 else (256, -1):
        calls = []

        def recorded(keys):
            if keys.is_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = radix_sort_words(keys)
            if keys.is_cuda:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            calls.append((tuple(keys.shape), digit_passes(keys), ms))
            return out

        plan = _make_plan(args.n, _normalize_k(k), pack.DNA)
        _run_plan(text_dev, plan, pack.DNA, sort_impl=recorded)  # warm up
        del calls[:]
        _run_plan(text_dev, plan, pack.DNA, sort_impl=recorded)
        print(f"suffix sort k={k}, n={args.n}: {len(calls)} K1 calls "
              f"(W x N, digit passes, wall ms ending in a synchronize): "
              + "; ".join(f"{w}x{n} {p} {ms:.3f}" for (w, n), p, ms in calls),
              flush=True)

    if dev.type != "cuda":
        print("cpu: the plain versions ran; no device kernels to split")
        return 0

    # ---- K1 by kernel
    w5 = seed_sort_words(text_dev)
    if not args.only_k1:
        print(f"seed sort words {tuple(w5.shape)}: {digit_passes(w5)} passes")
    events = report_split("K1 seed sort", lambda: radix_sort_words(w5))
    print("    passes in launch order (ms): "
          + " ".join(f"{us / 1e3:.3f}" for name, us in events
                     if "pass" in name or "scatter" in name))
    got, want = radix_sort_words(w5), radix_sort_words_plain(w5)
    print("    equal to the plain version:",
          torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    del w5, text_dev, got, want
    w8 = rank_like_words(TAIL_SHAPE, dev)
    if not args.only_k1:
        print(f"tail words {tuple(w8.shape)}: {digit_passes(w8)} passes")
    report_split("K1 tail shape", lambda: radix_sort_words(w8))
    del w8

    if args.only_k1:
        return 0

    # ---- P3 by launch
    rows = 2048
    n_probe = (args.probe_elements // (rows * mk.LANES)) * rows * mk.LANES
    k_, v_ = mk.probe_inputs(n_probe, dev)
    for r in (256, 1024, rows):
        events = report_split(f"P3 tile_sort T={r * mk.LANES // 1024}K",
                              lambda: mk.tile_sort(k_, v_, r))
        print("    in launch order (ms): "
              + " ".join(f"{name[:14]}:{us / 1e3:.3f}" for name, us in events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
