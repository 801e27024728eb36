"""Stage timing + logging, mirroring the reference's spdlog usage.

The reference wraps every pipeline phase in a ``spdlog::stopwatch`` and
logs ``SPDLOG_DEBUG("<stage> elapsed {}", sw)`` with an INFO summary at the
top level (reference: include/biovoltron/algo/sort/kiss1_core.hpp:244-267,
include/command/suffix_sort.hpp:57-61). Same stage names and log shape as
``kiss_tpu.utils.timing``; PyTorch launches CUDA work asynchronously, so a
stage that hands in CUDA tensors synchronizes the device before it reads
the clock.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time

import torch

_LOGGER = logging.getLogger("kiss_tpu_torch")


def setup_logging(verbose: bool = False) -> None:
    """Configure spdlog-style stderr logging.

    (reference: include/utils/options.hpp:266-270 -- default stderr color
    sink; ``--verbose`` lowers the level to debug.)
    """
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            "[%(asctime)s.%(msecs)03d] [%(levelname)s] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )
    )
    _LOGGER.handlers[:] = [handler]
    _LOGGER.setLevel(logging.DEBUG if verbose else logging.INFO)


def log_info(msg: str, *args) -> None:
    _LOGGER.info(msg, *args)


def debug_enabled() -> bool:
    """True when per-stage debug logging is on (``--verbose``); stage
    timers sync the device per phase only in that case, mirroring the
    reference's runtime spdlog gate (reference: include/utils/
    options.hpp:269-270 -- stopwatch logs compiled in, level-gated)."""
    return _LOGGER.isEnabledFor(logging.DEBUG)


def staged(name: str | None, fn):
    """Run ``fn`` and, when ``name`` is given AND debug logging is on,
    sync its device outputs and log ``<name> elapsed <seconds>`` -- the
    per-phase stopwatch pattern of the reference pipeline (reference:
    include/biovoltron/algo/sort/kiss1_core.hpp:244-267). With debug off
    this is a plain call: no sync, zero cost."""
    if name is None or not debug_enabled():
        return fn()
    with stage(name) as out:
        res = fn()
        out["block_on"] = res
    return res


def log_debug(msg: str, *args) -> None:
    _LOGGER.debug(msg, *args)


class Stopwatch:
    """Elapsed-seconds stopwatch (reference: spdlog::stopwatch)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def __format__(self, spec: str) -> str:
        return format(self.elapsed(), spec or ".6f")

    def __str__(self) -> str:
        return f"{self.elapsed():.6f}"


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for item in x:
            yield from _tensors(item)


def sync(x) -> None:
    """Wait for the device work producing ``x`` (a tensor, or a tuple /
    list / NamedTuple of them): ``torch.cuda.synchronize`` on each device
    holding one of its CUDA tensors (a mesh's blocks lie on several). CPU
    tensors are already complete."""
    synced = set()
    for t in _tensors(x):
        if t.is_cuda and t.device not in synced:
            torch.cuda.synchronize(t.device)
            synced.add(t.device)


def _memory_line():
    """(peak CUDA bytes allocated by this process, peak host RSS bytes)
    -- the reference experiment protocol records peak RSS per run
    (getPeakRSS, reference: experiment/src/kiss-1.cpp:15-19). The device
    part is 0 when CUDA is not in use."""
    import resource

    dev = 0
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        dev = int(torch.cuda.max_memory_allocated())
    # ru_maxrss is kilobytes on Linux but BYTES on macOS
    scale = 1 if sys.platform == "darwin" else 1024
    host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale
    return dev, host


@contextlib.contextmanager
def stage(name: str, *, block_on=None):
    """Log ``<name> elapsed <seconds>`` at debug level on exit, after
    syncing on any pending device work handed in via ``block_on``.
    With KISS_TPU_LOG_MEM=1 a second debug line reports per-stage peak
    device bytes + host RSS (the reference experiment protocol's space
    column, experiment_a.sh:34-35)."""
    import os

    sw = Stopwatch()
    result = {}
    try:
        yield result
    finally:
        pending = result.get("block_on", block_on)
        if pending is not None:
            sync(pending)
        _LOGGER.debug("%s elapsed %.6f", name, sw.elapsed())
        if os.environ.get("KISS_TPU_LOG_MEM"):
            dev, host = _memory_line()
            _LOGGER.debug(
                "%s peak_device_bytes %d peak_host_rss_bytes %d",
                name, dev, host,
            )
