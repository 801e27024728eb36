"""Run one cell of the benchmark and print its result as one JSON line.

    python -m kissbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's inputs from the seed, loads or builds the
program's kernels (into ``kiss_tpu_torch/build/`` in the checkout), does
what the traffic needs before the window (an index) and one warm
operation. The window is a closed loop of whole operations, each ended
with its result ready on the card; no operation starts after ``--seconds``
and the window ends when the last one ends. With ``--trace 0`` the line
carries the cell's end-to-end metrics; with ``--trace 1`` the window runs
under ``torch.profiler`` (for at most the traffic's ``trace_seconds``) and
the line carries its per-layer metrics and the breakdown. After the window
the outputs are compared with the plain reference (``correct``), each
number beside its limit on the last lines of standard error and under
``checks``, the last key of the line.

A run needs a CUDA device (``--device cpu`` rehearses the control flow on
the CPU with the program's plain versions: its numbers are the CPU's).
``--root`` names the directory that holds ``BENCHMARK.json`` and the data
files (``kissbench/configs``, ``traffic``, ``e2e``, ``metrics``,
``entries``); by default the directory above this package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here, imports included

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import NamedTuple  # noqa: E402

# Modules the benchmark's process may not hold once the window has closed,
# compared by top-level name: JAX and the JAX package (whose name the
# port's begins with), and the repository's JAX-side scripts.
FORBIDDEN = ("jax", "jaxlib", "flax", "kiss_tpu", "bench", "experiments",
             "tools")
HERE = os.path.dirname(os.path.abspath(__file__))


class Window(NamedTuple):
    """What the end-to-end readers read."""

    ops: int
    seconds: float
    work: int  # units of work of all the window's operations
    n: int  # characters of the configuration's text
    peak_bytes: int  # the allocator's peak over the window
    setup_s: float


def load_file(path: str, name: str):
    """A module loaded from a file of the benchmark's data folders."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m kissbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--root", default=None)
    return p.parse_args(argv)


def parse_device(name: str, chips: int):
    """The run's ``torch.device``, or None (with the reason on standard
    error) where a CUDA run finds fewer cards than the cell asks for.
    Caches of any extension or compiler torch may build are put at fixed
    places in the checkout first (the program's kernels build into its
    own ``build/``)."""
    cache = os.path.join(os.path.dirname(HERE), "kissbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    import torch

    if name == "cuda" and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < chips):
        print(f"kissbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return None
    return torch.device(name)


class Bench(NamedTuple):
    """The parts of ``BENCHMARK.json`` (under ``root``) one cell uses."""

    root: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, root: str | None, name: str) -> "Bench":
        root = root or os.path.dirname(HERE)
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            spec = json.load(f)
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
        with open(os.path.join(root, conf["file"])) as f:
            config = json.load(f)
        with open(os.path.join(root, "kissbench", "traffic",
                               cell["traffic"] + ".json")) as f:
            traffic = json.load(f)
        return cls(root, cell, config, traffic,
                   [m for m in spec["end_to_end"] if applies(m, name)],
                   [m for m in spec["per_layer"] if applies(m, name)])

    def module(self, kind: str, name: str):
        return load_file(os.path.join(self.root, "kissbench", kind,
                                      name + ".py"),
                         f"kissbench_{kind}_{name.replace('.', '_')}")


def run_window(cell, seconds: float, mark=None):
    """Whole operations back to back until ``seconds`` have passed: (ops,
    seconds from the first start to the last end)."""
    import contextlib

    mark = mark or contextlib.nullcontext
    ops = 0
    t0 = time.perf_counter()
    while True:
        with mark():
            cell.op()
        ops += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return ops, elapsed


def main(argv=None) -> int:
    args = parse(argv)
    bench = Bench.load(args.root, args.workload)
    chips = int(bench.workload["chips"])
    device = parse_device(args.device, chips)
    if device is None:
        return 2
    import torch

    from kissbench import trace
    from kissbench.cell import Context

    cuda = device.type == "cuda"
    ctx = Context(args.workload, bench.config, bench.traffic, args.seed,
                  device)
    entry = bench.module("entries", bench.traffic["entry"])
    cell = entry.Cell(ctx)
    cell.setup_program()
    cell.op()  # warm: every shape and kernel of the cell's operation
    ctx.sync()
    setup_s = time.perf_counter() - T_START
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cell.begin_window()
    summary = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        seconds = min(args.seconds,
                      float(bench.traffic.get("trace_seconds", args.seconds)))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW_MARK):
                ops, elapsed = run_window(
                    cell, seconds, lambda: record_function(trace.OP_MARK))
    else:
        ops, elapsed = run_window(cell, args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window = Window(ops, elapsed, ops * cell.work, int(bench.config["n"]),
                    peak, setup_s)
    metrics = {}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": chips,
        "memory_peak_bytes": max(setup_peak, peak),
    }
    if args.trace:
        from kiss_tpu_torch import kernels

        summary = trace.summarize(prof.events(),
                                  trace.hand_kernels(kernels.CSRC), ops)
        del prof
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
    else:
        for m in bench.end_to_end:
            metrics[m["name"]] = {"value": bench.module("e2e", m["name"])
                                  .read(window), "unit": m["unit"]}
    t_check = time.perf_counter()
    cell.release()
    checks = cell.check()
    t_check = time.perf_counter() - t_check
    print(f"kissbench: set-up {setup_s:.3f} s, {ops} operations in "
          f"{elapsed:.3f} s, the reference's check {t_check:.3f} s",
          file=sys.stderr)
    if args.trace:
        work = cell.trace_work()
        for m in bench.per_layer:
            value = bench.module("metrics", m["name"]).read(summary, work)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print("kissbench: the process holds " + ", ".join(found)
              + " after the window; no result", file=sys.stderr)
        return 3
    if cuda:
        card = power_limit()
        if card:
            device_info["nvidia_smi"] = card
    correct = all(c.value <= c.limit for c in checks)
    line = {
        "correct": correct,
        "attempted": ops,
        "failed": min(ops, cell.failed_ops(checks)),
        "metrics": metrics,
        "device": device_info,
    }
    if summary is not None:
        line["breakdown"] = {"device_ops": summary.device_ops,
                             "idle_gaps": summary.idle_gaps}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    for c in checks:
        print(f"check {c.name} {c.value} limit {c.limit}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
