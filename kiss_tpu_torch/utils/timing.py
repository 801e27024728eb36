"""Stage timing + logging, mirroring the reference's spdlog usage, and the
library's phases as spans in a profiler's trace.

The reference wraps every pipeline phase in a ``spdlog::stopwatch`` and
logs ``SPDLOG_DEBUG("<stage> elapsed {}", sw)`` with an INFO summary at the
top level (reference: include/biovoltron/algo/sort/kiss1_core.hpp:244-267,
include/command/suffix_sort.hpp:57-61). Same stage names and log shape as
``kiss_tpu.utils.timing``; PyTorch launches CUDA work asynchronously, so a
stage that hands in CUDA tensors synchronizes the device before it reads
the clock.

:func:`span` is the one helper for both: a phase of the library, named
``kiss.<layer>.<phase>``, that appears as a host event in a
``torch.profiler`` trace and in :data:`RECORDS` while a profiler records,
and that logs its stopwatch line under ``--verbose`` where it has one.
"""

from __future__ import annotations

import dataclasses
import logging
import os
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


# ---------------------------------------------------------------------------
# spans: the library's phases in a profiler's trace
# ---------------------------------------------------------------------------

_profiling = torch.autograd._profiler_enabled


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One span run while a profiler recorded: its name; the index in
    :data:`RECORDS` of the span it ran in (-1: none); its start and end on
    ``time.time_ns()``'s clock, the profiler's host clock (``end_ns`` 0
    while it is open); the counts :func:`add` gave it while it was the
    innermost open span; and, for a span that asked for device time with
    CUDA in use, two timing events around it on the current stream."""

    name: str
    parent: int
    start_ns: int
    end_ns: int = 0
    counts: dict = dataclasses.field(default_factory=dict)
    events: tuple | None = None


# The spans of the profiled stretches of this process, in the order they
# started (one thread's: the library runs its phases on one), and the
# indices of those still open, innermost last.
RECORDS: list[SpanRecord] = []
_OPEN: list[int] = []


class _Off:
    """The span of a call that neither traces nor logs: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def result(self, x):
        return x


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "log", "outputs", "_t0", "_fast")

    def __init__(self, name, device, log):
        self.name, self.device, self.log = name, device, log
        self.outputs = None

    def result(self, x):
        """``x``, kept as what the span's stopwatch line waits for."""
        self.outputs = x
        return x

    # The trace's event opens first and closes last, so that the trace
    # puts the span's own bookkeeping inside the span.
    def __enter__(self):
        if self.name is not None:
            self._fast = torch._C._profiler._RecordFunctionFast(self.name)
            self._fast.__enter__()
            rec = SpanRecord(self.name, _OPEN[-1] if _OPEN else -1,
                             time.time_ns())
            if self.device and torch.cuda.is_initialized():
                rec.events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                rec.events[0].record()
            _OPEN.append(len(RECORDS))
            RECORDS.append(rec)
        if self.log is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.log is not None:
            if self.outputs is not None:
                sync(self.outputs)
            _LOGGER.debug("%s elapsed %.6f", self.log,
                          time.perf_counter() - self._t0)
            if os.environ.get("KISS_TPU_LOG_MEM"):
                dev, host = _memory_line()
                _LOGGER.debug(
                    "%s peak_device_bytes %d peak_host_rss_bytes %d",
                    self.log, dev, host,
                )
        if self.name is not None:
            if _OPEN:
                rec = RECORDS[_OPEN.pop()]
                if rec.events is not None:
                    rec.events[1].record()
                rec.end_ns = time.time_ns()
            self._fast.__exit__(None, None, None)
        return None


def span(name: str | None, *, device: bool = False, log: str | None = None):
    """A context manager around one phase of the library.

    - Off (no profiler records, and no ``log`` or debug logging off): a
      shared do-nothing manager, after one check of the profiler's flag.
    - Tracing (a ``torch.profiler`` records and ``name`` is given): a host
      event ``name`` in the trace (``_RecordFunctionFast``, which the
      profiler keeps off the device's timeline) and a :class:`SpanRecord`
      in :data:`RECORDS`; with ``device=True``, CUDA timing events around
      the span on the current stream.
    - Debug (``log`` given and ``--verbose``): the stopwatch line ``<log>
      elapsed <seconds>``, after syncing what ``result`` kept, as the
      reference's per-phase ``spdlog::stopwatch``. Callers build ``log``
      only under :func:`debug_enabled`, so the off state formats nothing.

    ``with span(...) as sp: out = sp.result(work())`` keeps ``out`` for
    the line (a tensor or a tuple / list of them)."""
    tracing = name is not None and _profiling()
    debug = log is not None and debug_enabled()
    if not (tracing or debug):
        return _OFF
    return _Span(name if tracing else None, device, log if debug else None)


def add(counter: str, value: int) -> None:
    """Add ``value`` to ``counter`` of the innermost open span's record;
    nothing where no span is recording."""
    if _OPEN:
        counts = RECORDS[_OPEN[-1]].counts
        counts[counter] = counts.get(counter, 0) + value


def reset_spans() -> None:
    """Forget every recorded span (call it with none open)."""
    RECORDS.clear()
    _OPEN.clear()


def span_summary() -> dict:
    """The ended spans of :data:`RECORDS` by name: ``{name: {"count",
    "host_ms", "self_host_ms", "device_ms", "counts"}}``. ``host_ms`` sums
    their durations, ``self_host_ms`` the durations less what their child
    spans cover; ``device_ms`` sums the elapsed time of their CUDA events
    (None where the span asked for none, or CUDA was not in use);
    ``counts`` the counts added inside them, their children's included.
    Waits once for the device where any span holds events."""
    recs = RECORDS
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    child_ns = [0] * len(recs)
    counts = [dict(r.counts) for r in recs]
    for i in range(len(recs) - 1, -1, -1):  # children after their parent
        r = recs[i]
        if r.parent >= 0 and r.end_ns:
            child_ns[r.parent] += r.end_ns - r.start_ns
            up = counts[r.parent]
            for k, v in counts[i].items():
                up[k] = up.get(k, 0) + v
    out = {}
    for i, r in enumerate(recs):
        if not r.end_ns:
            continue
        s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                    "self_host_ms": 0.0, "device_ms": None,
                                    "counts": {}})
        ns = r.end_ns - r.start_ns
        s["count"] += 1
        s["host_ms"] += ns / 1e6
        s["self_host_ms"] += (ns - child_ns[i]) / 1e6
        if r.events is not None:
            s["device_ms"] = ((s["device_ms"] or 0.0)
                              + r.events[0].elapsed_time(r.events[1]))
        for k, v in counts[i].items():
            s["counts"][k] = s["counts"].get(k, 0) + v
    return out
