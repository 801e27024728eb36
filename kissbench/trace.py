"""The traced window: ``torch.profiler`` over CPU and CUDA activity,
reduced to what the per-layer metrics and the breakdown read.

- the device's busy time: the union of its kernels, copies and sets inside
  the window (the window is the span of a ``record_function`` marker);
- device time by kernel, each kernel named as its source declares it, and
  whether it is one of the program's hand-written kernels (its
  ``__global__`` functions in ``kiss_tpu_torch/csrc/*.cu``) or glue;
- the idle gaps between device activity, each put down to the innermost
  host event running at its middle.
"""

from __future__ import annotations

import glob
import os
import re
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_MARK = "kissbench.window"
OP_MARK = "kissbench.op"

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"([A-Za-z_]\w*)\s*\(")


def hand_kernels(csrc: str) -> dict[str, str]:
    """{kernel function name: its source file} for every ``__global__``
    function in the ``*.cu`` files of ``csrc``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu"))):
        with open(path, encoding="utf-8") as f:
            for name in _GLOBAL.findall(f.read()):
                out[name] = os.path.basename(path)
    return out


def kernel_name(name: str) -> str:
    """The function name of a device event's (demangled) name, qualified
    by any namespace other than an anonymous one (the program's kernels
    live in anonymous ones, PyTorch's in ``at::``):
    ``void (anonymous namespace)::foo_kernel<512, 16, 2>(unsigned int
    const*, ...)`` -> ``foo_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name.strip())
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def label(name: str) -> str:
    """A short plain label of an event name for the breakdown."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name.strip())
    return re.sub(r"[^A-Za-z0-9_.:-]+", "_", name)[:64]


@dataclass
class Summary:
    """The reduced trace of one window."""

    window_s: float
    busy_s: float
    ops: int
    # (kernel function name or event label, source file or None) -> seconds
    device_s: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def seconds_of(self, source: str | None = None, hand: bool | None = None
                   ) -> float:
        """Device seconds of the events from ``source`` (a ``.cu`` file),
        or of all hand-written kernels (``hand=True``) or of everything
        else (``hand=False``)."""
        total = 0.0
        for (_, src), s in self.device_s.items():
            if source is not None and src != source:
                continue
            if hand is not None and (src is not None) != hand:
                continue
            total += s
        return total


def _union(intervals):
    """Merged [start, end) intervals of a list, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(cpu, points):
    """For each of the sorted ``points``, the name of the latest-starting
    host event of ``cpu`` (sorted (start, end, name)) that covers it, or
    None."""
    out, active, i = [], [], 0
    for p in points:
        while i < len(cpu) and cpu[i][0] <= p:
            active.append(cpu[i])
            i += 1
        active = [e for e in active if e[1] > p]
        out.append(max(active)[2] if active else None)
    return out


def summarize(events, kernels: dict[str, str], ops: int) -> Summary:
    """Reduce ``torch.profiler``'s events (``prof.events()``) of a window
    marked by :data:`WINDOW_MARK`."""
    from torch.autograd import DeviceType

    cpu, dev = [], []
    window = None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name in (WINDOW_MARK, OP_MARK) and e.device_type != \
                DeviceType.CPU:
            continue  # the markers' spans on the device's timeline
        if e.device_type == DeviceType.CUDA:
            dev.append((start, end, e.name))
        elif e.name == WINDOW_MARK:
            window = (start, end)
        else:
            cpu.append((start, end, e.name))
    if window is None:
        raise RuntimeError("the trace has no window marker")
    w0, w1 = window
    dev = [(max(a, w0), min(b, w1), name) for a, b, name in dev
           if b > w0 and a < w1]
    by_kernel = defaultdict(float)
    by_label = defaultdict(float)
    for a, b, name in dev:
        fn = kernel_name(name)
        src = kernels.get(fn)
        by_kernel[(fn if src else label(name), src)] += (b - a) * 1e-6
        by_label[label(name)] += (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in dev])
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    cpu.sort()
    names = _innermost(cpu, [(a + b) / 2 for a, b in gaps])
    by_host = defaultdict(float)
    for (a, b), name in zip(gaps, names):
        if name is None:
            name = "host_between_operations"
        elif name == OP_MARK:
            name = "host_in_operation_outside_any_torch_call"
        by_host[label(name)] += (b - a) * 1e-6
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return Summary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        ops=ops,
        device_s=dict(by_kernel),
        device_ops=[[k, v] for k, v in top],
        idle_gaps=[[k, v] for k, v in idle],
    )
