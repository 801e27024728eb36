"""The automatic out-of-core route at its real size, through the CLI.

Makes a synthetic genome (``utils.synth``, from ``--seed``) just over the
in-core capacity that ``cli.in_core_capacity_chars`` derives from the
card's memory (``OVER`` = 1.02 times it: about 0.49 G characters on an
80 GB card), writes it as FASTA and runs ``suffix_sort -k 256`` through
``kiss_tpu_torch.cli.main``, so that the route is taken by the capacity
and not by an override (``KISS_TPU_INCORE_CAP`` must be unset). Prints the
card and its power limit, the host's memory, the ``routing:`` line, the
sorter's stage split (bucketize, column build, per batch upload + K1 +
download summed, rank rounds), the CLI's elapsed line, the peak host RSS and peak CUDA bytes,
and the checks on the SA: a permutation of 0..n and 100,000 random
adjacent rows in k-order (compared on the card). Last, one JSON line with
those numbers.

The out-of-core sorter keeps ~25-35 bytes a character on the host; when
the host's available memory cannot hold 40 bytes a character at that
size, the run is cut to the largest size that fits and the cut is
printed (the route is then forced by ``KISS_TPU_INCORE_CAP`` and the
output says so).

    python -m kiss_tpu_torch.experiments.external_scale

``--device cpu --n 200000`` rehearses the control flow on the CPU (the
route forced by the override, K1's plain version).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kiss_tpu_torch import cli, kernels
from kiss_tpu_torch.ops import external_sort
from kiss_tpu_torch.utils import fasta
from kiss_tpu_torch.utils.checks import Kept, LogLines, check_k_sorted_sample
from kiss_tpu_torch.utils.device import resolve_device
from kiss_tpu_torch.utils.synth import synth_genome

HOST_BYTES_PER_CHAR = 40  # what a run may need on the host, with margin
OVER = 1.02  # the text's length over the in-core capacity
K = 256  # the k-order of the sort


def host_memory() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":")
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(value.split()[0]) * 1024
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=None,
                   help="text length (default: OVER x the capacity)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if os.environ.get("KISS_TPU_INCORE_CAP"):
        raise SystemExit("unset KISS_TPU_INCORE_CAP: this run measures the "
                         "route the capacity takes")
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    mem = host_memory()
    capacity = cli.in_core_capacity_chars(dev)
    n = args.n or int(capacity * OVER) + 1
    fits = mem["MemAvailable"] // HOST_BYTES_PER_CHAR
    cut = None
    if n > fits:
        cut = f"cut from {n} to {fits} characters by host memory"
        n = fits
    print(f"host memory: total {mem['MemTotal']} available "
          f"{mem['MemAvailable']} bytes; in-core capacity {capacity} chars; "
          f"n = {n}" + (f" ({cut})" if cut else ""), flush=True)

    t0 = time.perf_counter()
    text = synth_genome(n, seed=args.seed)
    made_s = time.perf_counter() - t0
    lines = LogLines()
    logging.getLogger().addHandler(lines)
    split = {}
    kept = Kept(external_sort, "external_k_ordered_suffix_array",
                split=split)
    if n < capacity:
        # the capacity alone would keep this text in core: force the route
        os.environ["KISS_TPU_INCORE_CAP"] = str(n)
    try:
        with kept, tempfile.TemporaryDirectory(
                prefix="kiss_external_scale_") as tmp:
            fa = os.path.join(tmp, "genome.fa")
            t0 = time.perf_counter()
            fasta.write_fasta(fa, [fasta.FastaRecord("synth", text)],
                              width=80)
            write_s = time.perf_counter() - t0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(["suffix_sort", "-k", str(K), "--device", str(dev),
                           fa])
            cli_s = time.perf_counter() - t0
    finally:
        os.environ.pop("KISS_TPU_INCORE_CAP", None)
        logging.getLogger().removeHandler(lines)
    launches = kernels.LAUNCHES["radix_sort_words"]
    peak_cuda = (int(torch.cuda.max_memory_allocated())
                 if dev.type == "cuda" else 0)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if rc != 0 or len(kept.values) != 1:
        raise RuntimeError("suffix_sort did not take the out-of-core route")
    print("routing: " + lines.value("routing: "), flush=True)
    print("stage split (s): " + json.dumps(split), flush=True)
    print(f"n = {n}, k = {K}, suffix sorting elapsed "
          + lines.value(f"n = {n}, k = {K}, suffix sorting elapsed "),
          flush=True)
    t0 = time.perf_counter()
    sa = torch.from_numpy(kept.values.pop().astype(np.int64)).to(dev)
    check_k_sorted_sample(torch.from_numpy(text).to(dev), sa, K, 100_000)
    check_s = time.perf_counter() - t0
    print(f"SA of n = {n}: permutation and 100000-row k-order sample ok; "
          f"K1 launches {launches}; peak host RSS {rss} bytes "
          f"({rss / n:.1f} per char); peak CUDA bytes {peak_cuda} "
          f"({peak_cuda / n:.2f} per char); genome made in {made_s:.3f} s, "
          f"FASTA written in {write_s:.3f} s, CLI {cli_s:.3f} s, checks "
          f"{check_s:.3f} s on {card}", flush=True)
    print(json.dumps({
        "card": card, "n": n, "k": K, "capacity_chars": capacity,
        "cut": cut, "forced_by_override": n < capacity,
        "cli_s": cli_s, "split_s": split, "k1_launches": launches,
        "peak_host_rss_bytes": rss, "peak_cuda_bytes": peak_cuda,
        "host_mem_total": mem["MemTotal"],
        "host_mem_available": mem["MemAvailable"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
